"""Inference half of the training runtime: graph, features, neighborhood
tables, pool operators, full-corpus embeddings, evaluation, checkpoint load.

Port of ``movie_recommendation_engine_tpu/train/trainer.py`` for the serving
path (``__init__``, ``refresh_neighborhoods`` for the dense, hybrid and gather
rungs, ``movie_embeddings``, ``evaluate``, ``load_checkpoint``). The train
step, the hub and block rungs and the device mesh are not ported yet
(ROADMAP queue 1). Table sampling (``refresh_neighborhoods``) is split from
the building of the pool operators (``set_neighborhood_tables``) so that
tables sampled elsewhere — by the JAX package, in the tests — can be used.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..core import checkpoint as ckpt
from ..core.device import resolve_device
from ..core.logging import MetricsLogger
from ..evaluation import metrics as eval_metrics
from ..graph import features as feat_mod
from ..graph.dataset import MovieLensData
from ..graph.split import corated_item_pairs
from ..models import pinsage
from ..sampling import random_walk as rw

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP queue 1)")


class Trainer:
    """Dataset + model state for one config, on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for)."""

    def __init__(self, cfg: Config, data: MovieLensData,
                 logger: MetricsLogger | None = None, device=None):
        self.cfg = cfg
        self.data = data
        self.log = logger or MetricsLogger()
        self.device = resolve_device(device)
        if cfg.mesh.mesh_shape is not None:
            raise _not_ported("mesh.mesh_shape (multi-device execution)")
        if cfg.train.lr_plateau_monitor not in ("train_loss", "val_metric"):
            raise ValueError(
                "train.lr_plateau_monitor must be 'train_loss' or "
                f"'val_metric', got {cfg.train.lr_plateau_monitor!r}")

        # ---- graph ---------------------------------------------------------
        if cfg.graph.use_bipartite_graph:
            self.csr = data.build_bipartite_graph()
        else:
            self.csr = data.build_item_similarity_graph(
                threshold=cfg.graph.similarity_threshold)
        self.graph = rw.device_graph(self.csr, self.device)
        self.n_iters = rw.search_iters(self.csr)

        # ---- features ------------------------------------------------------
        movie_features = feat_mod.extract_movie_features(
            data.titles, data.genres, data.movie_tags,
            feature_dim=cfg.features.feature_dim,
            genre_weight=cfg.features.genre_weight,
            year_norm=cfg.features.year_norm,
            title_tfidf_max=cfg.features.title_tfidf_max_features,
            title_tfidf_min_df=cfg.features.title_tfidf_min_df,
            tag_tfidf_max=cfg.features.tag_tfidf_max_features,
            tag_tfidf_min_df=cfg.features.tag_tfidf_min_df,
            seed=cfg.train.seed,
            standardize=cfg.features.standardize,
        )
        if cfg.features.use_visual_features:
            movie_features = movie_features + feat_mod.create_visual_features(
                data.num_movies, cfg.features.feature_dim, seed=cfg.train.seed)
        self.movies_only = (cfg.model.pool_nodes == "movies_only"
                            or not cfg.graph.use_bipartite_graph)
        if self.movies_only:
            table = movie_features
            self.valid_limit = data.num_movies
        else:
            table = feat_mod.node_feature_table(movie_features, data.num_users)
            self.valid_limit = self.csr.num_nodes
        self.x_table = torch.as_tensor(np.asarray(table, np.float32), device=self.device)
        self.table_rows = int(self.x_table.shape[0])

        # ---- splits & pairs ------------------------------------------------
        tr, va, te = data.temporal_split(cfg.train.val_ratio, cfg.train.test_ratio)
        self.splits = (tr, va, te)
        seed = cfg.train.seed
        min_r = cfg.eval.corated_min_rating
        self.train_pairs = corated_item_pairs(tr.user_idx, tr.movie_idx, tr.ratings,
                                              min_rating=min_r, seed=seed)
        self.val_pairs = corated_item_pairs(va.user_idx, va.movie_idx, va.ratings,
                                            min_rating=min_r, seed=seed + 1)
        self.test_pairs = corated_item_pairs(te.user_idx, te.movie_idx, te.ratings,
                                             min_rating=min_r, seed=seed + 2)
        if self.train_pairs.shape[0] == 0:
            # Degenerate tiny datasets: user-movie interactions mapped into
            # movie space (both endpoints = the movie), as the JAX trainer.
            self.train_pairs = np.stack([tr.movie_idx, tr.movie_idx], axis=1)
        if self.train_pairs.shape[0] == 0:
            raise ValueError(
                "no training pairs: the train split is empty (check "
                "data.min_interactions / val_ratio / test_ratio)")

        # ---- model ---------------------------------------------------------
        # The port's own seeded init and walk stream: the numbers differ from
        # JAX's; parity comes from injecting JAX's params and tables.
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = pinsage.init_params(
            self.generator, cfg.features.feature_dim, cfg.model.hidden_dim,
            cfg.model.embed_dim, cfg.model.num_layers, cfg.model.aggregator_type,
            use_batch_norm=cfg.model.use_batch_norm,
            init_style=cfg.model.init_style, device=self.device)
        self.compute_dtype = _DTYPES[cfg.train.compute_dtype]
        self.epoch = 0
        self.best_metric = -float("inf")
        # Restored by load_checkpoint and kept for the training slice.
        self.opt_state: dict[str, np.ndarray] = {}
        self.rng: np.ndarray | None = None
        self.plateau: dict | None = None
        self.nbr_tables: list[tuple[torch.Tensor, torch.Tensor]] | None = None
        self.pool_mats: tuple = ()

        # "auto" = the torch gather + einsum formulation, as the JAX trainer
        # resolves it; "pallas" = the CUDA gather kernel (ops/pool.py).
        gi = cfg.model.gather_impl
        if gi not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown model.gather_impl {gi!r}")
        self.gather_impl = "xla" if gi == "auto" else gi
        if self.gather_impl != "xla":
            self.log.log("gather_impl", impl=self.gather_impl)

        self.log.log(
            "init", device=str(self.device),
            num_movies=data.num_movies, num_users=data.num_users,
            num_nodes=self.csr.num_nodes, num_edges=self.csr.num_edges,
            num_params=pinsage.num_params(self.params),
            train_pairs=int(self.train_pairs.shape[0]),
            val_pairs=int(self.val_pairs.shape[0]),
            test_pairs=int(self.test_pairs.shape[0]),
        )

    # ---- neighborhoods ----------------------------------------------------

    def refresh_neighborhoods(self) -> None:
        """Resample one neighborhood table per layer for every table row,
        then rebuild the pool operators."""
        cfg = self.cfg
        if cfg.walk.strategy != "random_walk":
            raise _not_ported(f"walk.strategy={cfg.walk.strategy!r}")
        restrict = (self.data.num_movies
                    if cfg.walk.count_nodes == "movies" and cfg.graph.use_bipartite_graph
                    else None)
        tables = rw.all_node_neighborhood_tables(
            self.graph, cfg.model.num_layers, cfg.walk.num_walks,
            cfg.walk.walk_length, cfg.walk.num_neighbors, self.n_iters,
            generator=self.generator, num_nodes=self.table_rows,
            restrict_below=restrict)
        self.set_neighborhood_tables(tables)

    def set_neighborhood_tables(self, tables) -> None:
        """Use the given per-layer ([N, K] ids, [N, K] weights) tables (tensors
        or arrays) and build the pool operators the config's rung asks for:
        ``dense`` (one [N, N] matrix per layer), ``hybrid`` (a matrix for
        layers 0..L-2, gather for the last) or ``gather`` (none)."""
        cfg = self.cfg
        def on_device(x, dtype):
            return torch.as_tensor(x if torch.is_tensor(x) else np.array(x),
                                   dtype=dtype, device=self.device)

        self.nbr_tables = [(on_device(nb, torch.int32), on_device(w, torch.float32))
                           for nb, w in tables]
        self.pool_mats = ()
        impl = cfg.model.pool_impl
        n_layers = cfg.model.num_layers
        if cfg.model.aggregator_type != "importance" or cfg.train.train_path == "mlp":
            return
        if impl == "dense" or (impl == "auto"
                               and self.table_rows <= cfg.model.dense_pool_max_rows):
            n_dense = n_layers
        elif n_layers > 1 and (impl == "hybrid" or (
                impl == "auto"
                and self.table_rows <= cfg.model.dense_pool_hybrid_max_rows)):
            n_dense = n_layers - 1
        elif n_layers > 1 and impl in ("hub", "block", "auto"):
            raise _not_ported(
                f"pool_impl={impl!r} at {self.table_rows} rows (hub/block rungs)")
        else:
            n_dense = 0
        if cfg.model.pool_matrix_dtype not in ("auto", "bfloat16"):
            raise _not_ported(f"pool_matrix_dtype={cfg.model.pool_matrix_dtype!r}")
        self.pool_mats = tuple(
            pinsage.build_pool_matrix(nbrs, w, num_cols=self.table_rows,
                                      valid_limit=self.valid_limit,
                                      dtype=torch.bfloat16)
            for nbrs, w in self.nbr_tables[:n_dense])

    # ---- inference / eval -------------------------------------------------

    @torch.no_grad()
    def movie_embeddings(self, params=None) -> torch.Tensor:
        """[num_movies, embed_dim] f32 via the full pooled forward."""
        if self.nbr_tables is None:
            self.refresh_neighborhoods()
        params = params if params is not None else self.params
        m = self.data.num_movies
        if self.cfg.train.train_path == "mlp":
            return pinsage.mlp_forward(params, self.x_table[:m], self.compute_dtype)
        if len(self.pool_mats) == self.cfg.model.num_layers:
            emb = pinsage.pooled_forward_dense(params, self.x_table,
                                               list(self.pool_mats),
                                               dtype=self.compute_dtype)
        else:
            emb = pinsage.pooled_forward(
                params, self.x_table, [t[0] for t in self.nbr_tables],
                [t[1] for t in self.nbr_tables], valid_limit=self.valid_limit,
                dtype=self.compute_dtype,
                aggregator=self.cfg.model.aggregator_type,
                pool_mats=self.pool_mats, gather_impl=self.gather_impl)
        return emb[:m]

    def evaluate(self, pairs: np.ndarray | None = None, params=None) -> dict[str, float]:
        pairs = self.test_pairs if pairs is None else pairs
        emb = self.movie_embeddings(params)
        if pairs is None or pairs.shape[0] == 0:
            # No interaction-derived pairs: genre-similarity fallback.
            from ..evaluation.fallback import evaluate_genre_similarity

            out = evaluate_genre_similarity(
                emb, self.data.genres, k_values=self.cfg.eval.k_values,
                mrr_scale=self.cfg.eval.mrr_scale, seed=self.cfg.train.seed)
            out["fallback"] = "genre_similarity"
            return out
        return eval_metrics.evaluate_embeddings(
            emb, pairs, k_values=self.cfg.eval.k_values,
            mrr_scale=self.cfg.eval.mrr_scale)

    # ---- checkpoint -------------------------------------------------------

    def load_checkpoint(self, path: str) -> None:
        """Params and metadata from a JAX-format checkpoint (``.npz`` +
        ``.meta.json``). Optimizer leaves and the JAX rng key are kept as
        numpy arrays for the training slice."""
        flat = ckpt.load_flat(path)
        meta = ckpt.load_meta(path)
        self.params = ckpt.params_from_jax(flat, self.device)
        self.opt_state = {k: v for k, v in flat.items() if k.startswith("opt/")}
        self.rng = flat.get("rng")
        self.epoch = int(meta["epoch"])
        self.best_metric = float(meta["best_metric"])
        self.plateau = dict(meta["plateau"])

