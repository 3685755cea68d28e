"""Training runtime: graph, features, neighborhood tables, pool operators,
the train step, the epoch loop, evaluation and checkpoint / resume.

Port of ``movie_recommendation_engine_tpu/train/trainer.py`` for every
pooling rung (dense, hybrid, hub, block, gather) and every aggregator (a
kind other than ``importance`` builds no pool operators and pools through
its gather layers, as in JAX); the device mesh is not ported yet (ROADMAP
queue 1). Contrastive training over shared random and rank-window hard
negatives on the pooled embeddings: per step, the
negatives, the batch-restricted pooled forward with dropout, the loss
(``train.loss``, NCE by default), its gradient and an Adam update.

Where JAX scans a jitted block of steps, ``train_steps`` is a Python loop of
steps on the device. The epoch is still cut into blocks of
``min(8, steps)`` steps, padded to whole blocks by wrap-around, so that the
port takes as many Adam steps as JAX. Random numbers come from one
``torch.Generator``; ``train_steps`` takes each step's draws instead
(``StepDraws``), which is how the tests feed JAX's. Table sampling
(``refresh_neighborhoods``) is split from the building of the pool operators
(``set_neighborhood_tables``) so that tables sampled elsewhere can be used.
"""

from __future__ import annotations

import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..core import checkpoint as ckpt
from ..core import tree
from ..core.device import resolve_device
from ..core.logging import MetricsLogger
from ..evaluation import metrics as eval_metrics
from ..graph import features as feat_mod
from ..graph.dataset import MovieLensData
from ..graph.split import corated_item_pairs
from ..models import losses, pinsage
from ..ops import block_sparse as bsp
from ..ops import hub_pool as hub_mod
from ..ops.hub_pool import HubPool
from ..ops.pool import segment_layout
from ..sampling import negative, ppr, random_walk as rw
from . import optim

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class StepDraws(NamedTuple):
    """One train step's random inputs: the shared random negatives [R] and
    the hard negatives [B, H] (None when H = 0) as int32 movie ids, and one
    bool keep mask per hidden conv ([N, hidden], None to draw them)."""

    random: torch.Tensor
    hard: torch.Tensor | None = None
    keep: list[torch.Tensor] | None = None


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
                threshold=cfg.graph.similarity_threshold, logger=self.log)
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
        self.opt_state = optim.adam_init(self.params)
        self.plateau = optim.plateau_init(cfg.train.learning_rate)
        self.epoch = 0
        self.best_metric = -float("inf")
        self.nbr_tables: list[tuple[torch.Tensor, torch.Tensor]] | None = None
        self.pool_mats: tuple = ()
        self.bwd_layouts: list | None = None
        self._block_perm: np.ndarray | None = None   # block rung's node order
        # Steps per block of an epoch (see train_epoch).
        self.steps_per_call = 8

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
        then rebuild the pool operators. PPR tables (``walk.strategy="ppr"``)
        are deterministic: they are built once (logged as ``ppr_tables``)
        and every later refresh keeps them and their operators."""
        cfg = self.cfg
        restrict = (self.data.num_movies
                    if cfg.walk.count_nodes == "movies" and cfg.graph.use_bipartite_graph
                    else None)
        if cfg.walk.strategy == "ppr":
            if self.nbr_tables is not None:
                return
            tables = ppr.all_node_neighborhood_tables_ppr(
                self.graph, cfg.model.num_layers, cfg.walk.num_neighbors,
                num_nodes=self.table_rows, restrict_below=restrict,
                alpha=cfg.walk.ppr_alpha, num_iterations=cfg.walk.ppr_iterations,
                batch=cfg.walk.ppr_batch)
            self.log.log("ppr_tables", rows=self.table_rows, batch=cfg.walk.ppr_batch)
        elif cfg.walk.strategy == "random_walk":
            tables = rw.all_node_neighborhood_tables(
                self.graph, cfg.model.num_layers, cfg.walk.num_walks,
                cfg.walk.walk_length, cfg.walk.num_neighbors, self.n_iters,
                generator=self.generator, num_nodes=self.table_rows,
                restrict_below=restrict)
        else:
            raise ValueError(f"unknown walk.strategy {cfg.walk.strategy!r} "
                             "(expected 'random_walk' or 'ppr')")
        self.set_neighborhood_tables(tables)

    def set_neighborhood_tables(self, tables) -> None:
        """Use the given per-layer ([N, K] ids, [N, K] weights) tables (tensors
        or arrays) and build the pool operators of the config's rung
        (``_pool_operators``). With ``gather_impl="pallas"`` it also builds
        the backward kernel's layouts (``full_graph_layouts``)."""
        def on_device(x, dtype):
            return torch.as_tensor(x if torch.is_tensor(x) else np.array(x),
                                   dtype=dtype, device=self.device)

        self.nbr_tables = [(on_device(nb, torch.int32), on_device(w, torch.float32))
                           for nb, w in tables]
        # Drop the old operators before building the new ones: at scale two
        # sets do not fit on the card together.
        self.pool_mats = ()
        self.bwd_layouts = None
        if (self.cfg.model.aggregator_type != "importance"
                or self.cfg.train.train_path == "mlp"):
            return
        self.pool_mats = self._pool_operators()
        if self.gather_impl == "pallas":
            self.bwd_layouts = self.full_graph_layouts()

    def full_graph_layouts(self) -> list:
        """``ops.pool.segment_layout`` of each full-graph layer's gather
        table, for the backward kernel: a gather layer's walk table (limit
        ``valid_limit``), a hub layer's residual ids (limit N, as the
        residual pools over the whole table); None for a dense or block
        layer. Layers 0..L-2 pool the whole graph with the same tables
        until the next refresh (the last layer pools the batch's rows)."""
        limit = min(self.valid_limit, self.table_rows)
        layouts = []
        for i in range(self.cfg.model.num_layers - 1):
            pm = self.pool_mats[i] if i < len(self.pool_mats) else None
            if isinstance(pm, HubPool):
                layouts.append(segment_layout(pm.res_nbrs, self.table_rows))
            elif pm is None:
                layouts.append(segment_layout(
                    self.nbr_tables[min(i, len(self.nbr_tables) - 1)][0], limit))
            else:
                layouts.append(None)
        return layouts

    def _pool_operators(self) -> tuple:
        """The pooling rung, as the JAX trainer picks it: ``dense`` (one
        [N, N] matrix per layer), ``hybrid`` (matrices for layers 0..L-2,
        gather for the last), ``hub`` (a ``HubPool`` for layers 0..L-2, and
        for the last too under ``hub_pool_final_layer``, or under ``auto``
        when the slabs fit ``auto_hub_final_max_bytes``), ``block``, or
        ``gather`` (no operators). ``auto`` takes dense, then hybrid, up to
        their row limits; above them hub, then block when a hub layer drops
        more mass than its gate (after one doubling of the residual), then
        gather when a block layer does."""
        m = self.cfg.model
        impl, n_layers, rows = m.pool_impl, m.num_layers, self.table_rows
        n_dense = n_hub = n_block = 0
        if impl == "dense" or (impl == "auto" and rows <= m.dense_pool_max_rows):
            n_dense = n_layers
        elif n_layers > 1 and (impl == "hybrid" or (
                impl == "auto" and rows <= m.dense_pool_hybrid_max_rows)):
            n_dense = n_layers - 1
        elif n_layers > 1 and impl == "block":
            n_block = n_layers - 1
        elif n_layers > 1 and impl in ("hub", "auto"):
            hub_final = m.hub_pool_final_layer
            if impl == "auto" and m.auto_hub_final and not hub_final:
                dt = hub_mod.resolve_pool_matrix_dtype(m.pool_matrix_dtype, rows, "hub",
                                                       head_cfg=m.hub_pool_head)
                head = m.hub_pool_head if m.hub_pool_head > 0 else hub_mod.auto_head(rows, dt)
                slab_bytes = n_layers * rows * min(head, rows) * dt.itemsize
                hub_final = slab_bytes <= m.auto_hub_final_max_bytes
            n_hub = n_layers if hub_final else n_layers - 1
        if n_hub:
            mats = self._hub_operators(n_hub)
            if mats:
                return mats
            if impl == "auto":
                n_block = n_hub
        if n_block:
            return self._block_operators(n_block)
        if n_dense:
            pool_dtype = hub_mod.resolve_pool_matrix_dtype(m.pool_matrix_dtype, rows, "dense")
            # Cast after the bf16 build, as JAX does (a scatter-add into
            # float8 would round every addition).
            return tuple(
                pinsage.build_pool_matrix(nbrs, w, num_cols=rows, valid_limit=self.valid_limit,
                                          dtype=torch.bfloat16).to(pool_dtype)
                for nbrs, w in self.nbr_tables[:n_dense])
        return ()

    def _hub_operators(self, n_hub: int) -> tuple:
        """One ``HubPool`` for each of the first ``n_hub`` layers, the slab
        built in ``pool_dtype`` directly, or () when a layer fails its gate
        (``hub_pool_max_dropped_mass``, or the block gate when negative)
        even after one doubling of its residual."""
        m = self.cfg.model
        pool_dtype = hub_mod.resolve_pool_matrix_dtype(
            m.pool_matrix_dtype, self.table_rows, "hub", head_cfg=m.hub_pool_head)
        cap = (m.hub_pool_max_dropped_mass if m.hub_pool_max_dropped_mass >= 0
               else m.block_pool_max_dropped_mass)
        mats = []
        for nbrs, w in self.nbr_tables[:n_hub]:
            def build(residual):
                return hub_mod.build_hub_pool_device(
                    nbrs, w, valid_limit=self.valid_limit, head=m.hub_pool_head,
                    residual=residual, dtype=pool_dtype)

            hp, stats = build(m.hub_pool_residual)
            self.log.log("hub_pool", **stats)
            r2 = min(m.hub_pool_residual * 2, int(nbrs.shape[1]))
            if stats["dropped_mass"] > cap and r2 > m.hub_pool_residual:
                # Free the failed slab before the wider build: at scale two
                # slabs do not fit on the card together.
                del hp
                hp, stats = build(r2)
                self.log.log("hub_pool_residual_escalated", residual=r2, **stats)
            if stats["dropped_mass"] > cap:
                del hp
                self.log.log("hub_pool_fallback", dropped_mass=stats["dropped_mass"])
                return ()
            mats.append(hp)
        return tuple(mats)

    def _block_operators(self, n_block: int) -> tuple:
        """One ``BlockPool`` for each of the first ``n_block`` layers over
        the node order cached at the first build (``block_pool_order``), cast
        to ``pool_dtype`` after the bf16 build, or () when a layer drops more
        than ``block_pool_max_dropped_mass``."""
        m = self.cfg.model
        tables = [(nb.cpu().numpy(), w.cpu().numpy()) for nb, w in self.nbr_tables[:n_block]]
        if self._block_perm is None:
            t0 = time.perf_counter()
            if m.block_pool_order == "mass":
                self._block_perm = bsp.mass_permutation(*tables[0], valid_limit=self.valid_limit)
            else:
                self._block_perm = bsp.cluster_permutation(
                    self.x_table, num_clusters=m.block_pool_clusters, seed=self.cfg.train.seed)
            self.log.log("block_cluster", order=m.block_pool_order,
                         seconds=time.perf_counter() - t0)
        pool_dtype = hub_mod.resolve_pool_matrix_dtype(m.pool_matrix_dtype, self.table_rows,
                                                       "block")
        mats = []
        for nbrs, w in tables:
            bp, stats = bsp.build_block_pool(
                nbrs, w, self._block_perm, valid_limit=self.valid_limit,
                block_size=m.block_pool_block_size, max_blocks=m.block_pool_max_blocks,
                device=self.device)
            self.log.log("block_pool", **stats)
            if stats["dropped_mass"] > m.block_pool_max_dropped_mass:
                self.log.log("block_pool_fallback", dropped_mass=stats["dropped_mass"])
                return ()
            mats.append(bp._replace(a_blocks=bp.a_blocks.to(pool_dtype)))
        return tuple(mats)

    def _dense_fast_path(self) -> bool:
        """A dense matrix for every layer: the all-matmul forwards. A full
        set of hub or block operators goes through the general forwards."""
        return (len(self.pool_mats) == self.cfg.model.num_layers
                and all(torch.is_tensor(pm) for pm in self.pool_mats))

    # ---- train step -------------------------------------------------------

    def draw_step(self, q: torch.Tensor, num_hard: int) -> StepDraws:
        """One step's negatives from the generator (the keep masks are drawn
        by the forward)."""
        cfg = self.cfg
        num_rand = min(cfg.train.num_negative_samples, self.data.num_movies)
        rand_negs = negative.sample_random_negatives(
            self.data.num_movies, num_rand, self.generator, self.device)
        hard = None
        if num_hard > 0:
            hard = negative.sample_hard_negatives(
                self.graph, q, num_hard, self.data.num_movies, num_walks=100,
                walk_length=cfg.walk.walk_length, min_rank=cfg.train.hard_neg_min_rank,
                max_rank=cfg.train.hard_neg_max_rank, n_iters=self.n_iters,
                generator=self.generator)
        return StepDraws(rand_negs, hard)

    def _loss(self, params, q: torch.Tensor, p: torch.Tensor, draws: StepDraws,
              epoch: float) -> torch.Tensor:
        cfg = self.cfg
        b, num_rand = q.shape[0], draws.random.shape[0]
        nodes = [q, p, draws.random]
        if draws.hard is not None:
            nodes.append(draws.hard.reshape(-1))
        all_nodes = torch.cat([x.to(torch.int32) for x in nodes])
        drop = dict(dropout_rate=cfg.model.dropout, generator=self.generator,
                    dropout_keep=draws.keep)
        if cfg.train.train_path == "mlp":
            emb = pinsage.mlp_forward(params, self.x_table[all_nodes.long()],
                                      self.compute_dtype)
        elif self._dense_fast_path():
            emb = pinsage.pooled_forward_batch_dense(
                params, self.x_table, list(self.pool_mats), all_nodes,
                dtype=self.compute_dtype, **drop)
        else:
            emb = pinsage.pooled_forward_batch(
                params, self.x_table, [t[0] for t in self.nbr_tables],
                [t[1] for t in self.nbr_tables], all_nodes, valid_limit=self.valid_limit,
                dtype=self.compute_dtype, aggregator=cfg.model.aggregator_type,
                pool_mats=self.pool_mats, gather_impl=self.gather_impl,
                bwd_layouts=self.bwd_layouts if self.gather_impl == "pallas" else None,
                **drop)
        q_emb, p_emb = emb[:b], emb[b:2 * b]
        r_emb = emb[2 * b:2 * b + num_rand]
        h_emb = (emb[2 * b + num_rand:].reshape(b, draws.hard.shape[1], -1)
                 if draws.hard is not None else None)

        kind = cfg.train.loss if cfg.train.train_path != "mlp" else "cosine"
        if kind == "cosine":
            return losses.cosine_objective(q_emb, p_emb)
        if kind == "batch_hard":
            return losses.batch_hard_triplet_loss(q_emb, p_emb, cfg.train.margin)
        if kind == "max_margin":
            return losses.shared_pool_max_margin_loss(q_emb, p_emb, r_emb, cfg.train.margin)
        if kind == "nce":
            return losses.nce_loss(q_emb, p_emb, r_emb, h_emb,
                                   temperature=cfg.train.nce_temperature)
        return losses.curriculum_loss(
            q_emb, p_emb, r_emb, h_emb, epoch, margin=cfg.train.margin,
            max_epochs=cfg.train.epochs, hard_negative_factor=cfg.train.hard_neg_factor)

    def loss_and_grads(self, q: torch.Tensor, p: torch.Tensor, draws: StepDraws,
                       epoch: float) -> tuple[torch.Tensor, Any]:
        """The step's loss and its gradient in every parameter (zeros for
        the ones the loss does not read, as JAX's), at ``self.params``."""
        flat = tree.flatten(self.params)
        leaves = [x.detach().requires_grad_() for x in flat.values()]
        loss = self._loss(tree.unflatten(dict(zip(flat, leaves))), q, p, draws, epoch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), tree.unflatten(dict(zip(flat, grads)))

    def train_steps(self, q_blk, p_blk, lr: float, epoch: float, num_hard: int,
                    draws: list[StepDraws] | None = None) -> torch.Tensor:
        """Steps over the batches ``q_blk``, ``p_blk`` [S, B]: per step the
        negatives (``draws[s]`` if given, else drawn), the loss and its
        gradient, and an Adam update of ``self.params`` at ``lr``. Returns
        the [S] f32 losses on the device, without waiting for them."""
        if self.nbr_tables is None and self.cfg.train.train_path != "mlp":
            self.refresh_neighborhoods()
        q_blk = torch.as_tensor(q_blk, dtype=torch.int32, device=self.device)
        p_blk = torch.as_tensor(p_blk, dtype=torch.int32, device=self.device)
        step_losses = []
        for s in range(q_blk.shape[0]):
            d = draws[s] if draws is not None else self.draw_step(q_blk[s], num_hard)
            loss, grads = self.loss_and_grads(q_blk[s], p_blk[s], d, epoch)
            self.params, self.opt_state = optim.adam_update(grads, self.opt_state,
                                                            self.params, lr)
            step_losses.append(loss)
        return torch.stack(step_losses).float()

    # ---- epoch loop -------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _epoch_pairs(self, rng: np.random.Generator) -> np.ndarray:
        pairs = self.train_pairs
        cap = self.cfg.train.max_pairs_per_epoch
        if cap is not None and pairs.shape[0] > cap:
            pairs = pairs[rng.choice(pairs.shape[0], size=cap, replace=False)]
        else:
            pairs = pairs[rng.permutation(pairs.shape[0])]
        # Pad to a whole number of fixed-size batches (wrap-around).
        bsz = min(self.cfg.train.batch_size, max(pairs.shape[0], 1))
        pad = (-pairs.shape[0]) % bsz
        if pad:
            reps = 2 + pad // max(pairs.shape[0], 1)
            pairs = np.concatenate([pairs] * reps, axis=0)[: pairs.shape[0] + pad]
        return pairs.reshape(-1, bsz, 2)

    def train_epoch(self, epoch: int) -> dict[str, float]:
        cfg = self.cfg
        refresh = cfg.train.refresh_neighborhoods_every
        refresh_s = 0.0
        if self.nbr_tables is None or (refresh and epoch % refresh == 0):
            t0 = time.perf_counter()
            self.refresh_neighborhoods()
            self._sync()
            refresh_s = time.perf_counter() - t0
            self.log.log("neighborhoods", epoch=epoch, seconds=refresh_s)

        batches = self._epoch_pairs(np.random.default_rng(cfg.train.seed + 1000 + epoch))
        num_hard = (negative.curriculum_num_hard(epoch, cfg.train.max_hard_negatives)
                    if cfg.train.loss in ("curriculum", "nce")
                    and cfg.train.train_path != "mlp" else 0)
        # Blocks of min(8, steps) steps, the step count padded to whole
        # blocks (wrap-around) as JAX's scanned blocks are: the padded steps
        # update the params and are left out of the loss mean.
        s_total = batches.shape[0]
        block = min(self.steps_per_call, s_total)
        pad_steps = (-s_total) % block
        if pad_steps:
            batches = np.concatenate([batches, batches[:pad_steps]], axis=0)
        q_all = torch.as_tensor(batches[:, :, 0], dtype=torch.int32, device=self.device)
        p_all = torch.as_tensor(batches[:, :, 1], dtype=torch.int32, device=self.device)

        step_losses = []
        self._sync()
        t0 = time.perf_counter()
        t_after_first = None
        for s0 in range(0, batches.shape[0], block):
            step_losses.append(self.train_steps(q_all[s0:s0 + block], p_all[s0:s0 + block],
                                                self.plateau.lr, float(epoch), num_hard))
            if t_after_first is None:
                self._sync()
                t_after_first = time.perf_counter()
        all_losses = torch.cat(step_losses).cpu().numpy()[:s_total]
        t_end = time.perf_counter()

        bsz = int(batches.shape[1])
        n_timed_steps = batches.shape[0] - block
        timed_s = t_end - t_after_first
        exps = (bsz * n_timed_steps / timed_s if n_timed_steps and timed_s > 0
                else bsz * block / max(t_after_first - t0, 1e-9))
        return {
            "loss": float(all_losses.mean()),
            "examples_per_sec": exps,
            # Mean over the steps after the first block (host clock, device
            # synchronized at both ends).
            "step_ms_avg": timed_s / n_timed_steps * 1e3 if n_timed_steps else float("nan"),
            "num_hard": num_hard,
            "refresh_seconds": round(refresh_s, 2),
            "step_wall_seconds": round(t_end - t0, 2),
        }

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
        if self._dense_fast_path():
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


    # ---- checkpoint / resume ----------------------------------------------

    def _rng_words(self) -> np.ndarray:
        """Two uint32 words drawn from the generator, which is then reseeded
        from them: a run that saves continues exactly as one that resumes
        from what it saved (``_reseed``)."""
        words = torch.randint(0, 2**32, (2,), generator=self.generator,
                              device=self.device, dtype=torch.int64).cpu().numpy()
        words = words.astype(np.uint32)
        self._reseed(words)
        return words

    def _reseed(self, words: np.ndarray) -> None:
        w = np.asarray(words, np.uint32).reshape(-1)
        if w.shape != (2,):
            raise ValueError(f"checkpoint rng must be uint32[2], got shape {w.shape}")
        self.generator.manual_seed((int(w[0]) << 32) | int(w[1]))

    def save_checkpoint(self, path: str, tag: str = "last") -> None:
        """Params, Adam state and a uint32[2] ``rng`` in the JAX package's
        format (``.npz`` + ``.meta.json``), which its Trainer resumes."""
        flat = {f"params/{k}": v for k, v in ckpt.params_to_jax(self.params).items()}
        flat.update(optim.state_to_jax(self.opt_state))
        flat["rng"] = self._rng_words()
        meta = {"epoch": self.epoch, "best_metric": self.best_metric,
                "plateau": self.plateau._asdict(), "config": self.cfg.to_dict(), "tag": tag}
        ckpt.save_flat(path, flat, meta)

    def load_checkpoint(self, path: str) -> None:
        """Params, Adam state, rng (the generator is reseeded from it),
        epoch, best metric and plateau state from a checkpoint written by
        either package."""
        flat = ckpt.load_flat(path)
        meta = ckpt.load_meta(path)
        self.params = ckpt.params_from_jax(flat, self.device)
        self.opt_state = optim.state_from_jax(flat, self.device)
        self._reseed(flat["rng"])
        self.epoch = int(meta["epoch"])
        self.best_metric = float(meta["best_metric"])
        self.plateau = optim.PlateauState(**meta["plateau"])

    # ---- main loop --------------------------------------------------------

    def fit(self, resume_from: str | None = None) -> dict[str, Any]:
        """Epochs from ``self.epoch`` to ``train.epochs``: train, validate
        (HR@min(k) every ``eval.eval_every`` epochs), step the plateau
        schedule, write ``last_model`` every epoch and ``best_model`` on a
        new best, stop early on ``eval.patience``."""
        cfg = self.cfg
        if resume_from and os.path.exists(
                resume_from if resume_from.endswith(".npz") else resume_from + ".npz"):
            self.load_checkpoint(resume_from)
            self.log.log("resume", epoch=self.epoch)

        stopper = optim.EarlyStopping(cfg.eval.patience)
        stopper.best = self.best_metric
        os.makedirs(cfg.paths.checkpoint_dir, exist_ok=True)
        best_path = os.path.join(cfg.paths.checkpoint_dir, "best_model")
        last_path = os.path.join(cfg.paths.checkpoint_dir, "last_model")
        history = []
        best_written = False  # did THIS fit() call write best_model?

        for epoch in range(self.epoch, cfg.train.epochs):
            self.epoch = epoch
            t0 = time.perf_counter()
            stats = self.train_epoch(epoch)
            stats["epoch_seconds"] = time.perf_counter() - t0

            val_metric = None
            if (cfg.eval.eval_every and (epoch + 1) % cfg.eval.eval_every == 0
                    and self.val_pairs.shape[0] > 0):
                vp = self.val_pairs
                cap = cfg.eval.max_val_pairs
                if cap is not None and vp.shape[0] > cap:
                    vp = vp[np.random.default_rng(cfg.train.seed + 7).choice(
                        vp.shape[0], size=cap, replace=False)]
                val = self.evaluate(vp)
                val_metric = val[f"hit_rate@{min(cfg.eval.k_values)}"]
                stats.update({f"val_{k}": v for k, v in val.items()})

            # Plateau on the train loss (min mode) or on the val metric (max
            # mode, by negation; epochs without validation leave it as is).
            if cfg.train.lr_plateau_monitor == "val_metric":
                if val_metric is not None:
                    self.plateau = optim.plateau_step(
                        self.plateau, -float(val_metric), factor=cfg.train.lr_plateau_factor,
                        patience=cfg.train.lr_plateau_patience)
            else:
                self.plateau = optim.plateau_step(
                    self.plateau, stats["loss"], factor=cfg.train.lr_plateau_factor,
                    patience=cfg.train.lr_plateau_patience)
            stats["lr"] = self.plateau.lr
            self.log.log_epoch(epoch, **stats)
            history.append(stats)

            self.epoch = epoch + 1
            self.save_checkpoint(last_path, tag="last")
            if val_metric is not None and val_metric > self.best_metric:
                self.best_metric = val_metric
                self.save_checkpoint(best_path, tag="best")
                best_written = True
            if val_metric is not None and stopper.update(val_metric):
                self.log.log("early_stop", epoch=epoch)
                break

        return {"history": history, "best_metric": self.best_metric,
                # Only when this call wrote it: a resumed run restores
                # best_metric without writing best_model.
                "best_path": best_path if best_written else None}
