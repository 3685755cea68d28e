"""Training runtime: graph, features, neighborhood tables, pool operators,
the train step, the epoch, evaluation and, through ``loop.TrainLoop``
(``fit``, checkpoint / resume), the epoch loop.

Port of ``movie_recommendation_engine_tpu/train/trainer.py`` for every
pooling rung (dense, hybrid, hub, block, gather), every aggregator (a kind
other than ``importance`` builds no pool operators and pools through its
gather layers, as in JAX) and the (data, model) device mesh. Contrastive
training over shared random and rank-window hard negatives on the pooled
embeddings: per step, the negatives, the batch-restricted pooled forward
with dropout, the loss (``train.loss``, NCE by default), its gradient and an
Adam update (``parallel/sharding.py``).

Under ``mesh.mesh_shape = (d, m)`` (one process a rank, the process group
joined first: ``parallel.mesh.distributed_init``) every rank draws the same
global draws and runs its share of each step; with ``mesh.shard_tables``
and ``m > 1`` the feature table is padded to a multiple of ``m`` (as JAX's)
and it, the walk tables and the pool operators hold the rank's rows only
(``mesh.shard_graph`` splits the CSR too, ``sampling/sharded_walk.py``).
The gather kernels stay on under a mesh. Only the coordinator writes a
checkpoint; every rank loads it.

Where JAX scans a jitted block of steps, ``train_steps`` (``loop.TrainLoop``)
replays a CUDA graph of the step once a step (one graph per ``num_hard``,
batch size and rung, as JAX compiles once per ``num_hard``), and
``movie_embeddings`` one graph of the embedding pass; both run eager under a
mesh too. The epoch is still cut into blocks of
``min(8, steps)`` steps, padded to whole blocks by wrap-around, so that the
port takes as many Adam steps as JAX. ``lr`` and ``epoch`` reach the step as
0-d device tensors, filled before each block, and Adam's step count lives on
the device. Random numbers come from one ``torch.Generator``; ``train_steps``
takes each step's draws instead (``StepDraws``), which is how the tests feed
JAX's. Table sampling
(``refresh_neighborhoods``) is split from the building of the pool operators
(``set_neighborhood_tables``) so that tables sampled elsewhere can be used.
Where JAX runs each refresh chunk's walks and top-K as one program and its
validation ranks as one scan, the card replays one CUDA graph of the whole
refresh (``walk_tables``, with the dense rung's pool matrices) and one of
the ranks (``evaluate``), kept in ``graphs.programs``, each graph dropped
alone when what it reads moves; the hub and block operators and the segment
layouts are built eager (host gates pick the rung and its shapes).

Program spans (``core.logging.span``) mark the epoch's parts:
``trainer.refresh`` (``.walks``, ``.pool_build``), ``trainer.epoch_batches``,
``trainer.steps`` (the block loop through the loss readback) and
``trainer.evaluate`` (``.embed``, ``.ranks``); ``fit`` adds ``trainer.epoch``.
The ``neighborhoods`` event's ``seconds``, ``step_wall_seconds`` and ``fit``'s
``epoch_seconds`` and ``val_seconds`` are their spans' durations. Spans wrap
replays, never a capture. Where the backward kernel's layouts are built, the
event's ``bwd_zero_weight_share`` gives, per layout, the share of its table's
slots left out for a weight of 0; on the dense and hybrid rungs its
``dense_pad_cols`` gives, per [N, N] matrix, the zero columns its row stride
adds (``_dense_matrices``). On the hub rung each build's ``hub_pool`` event
gives ``mass_slots_skipped``, the share of the walk table's slots (its
sentinels, weight 0) that the column mass left out.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..core import checkpoint as ckpt
from ..core.device import resolve_device
from ..core.graphs import copy_into, tensors
from ..core.logging import MetricsLogger, span
from ..evaluation import metrics as eval_metrics
from ..graph import features as feat_mod
from ..graph.dataset import MovieLensData
from ..graph.split import corated_item_pairs
from ..models import pinsage
from ..ops import block_sparse as bsp
from ..ops import hub_pool as hub_mod
from ..ops.hub_pool import HubPool
from ..ops.pool import segment_layout
from ..parallel import collectives as coll
from ..parallel import mesh as mesh_mod
from ..parallel import sharding
from ..sampling import negative, ppr, random_walk as rw
from ..sampling import sharded_walk
from . import optim
from .loop import TrainLoop


def rung(pool_mats) -> str:
    """The pooling rung of a trainer's operators, one word a layer
    (``dense``, ``hub``, ``block``), or ``gather`` where there are none:
    part of the step and embedding graphs' keys."""
    words = ["hub" if isinstance(pm, HubPool)
             else "block" if isinstance(pm, bsp.BlockPool) else "dense"
             for pm in pool_mats]
    return ",".join(words) or "gather"


class StepDraws(NamedTuple):
    """One train step's random inputs: the shared random negatives [R] and
    the hard negatives [B, H] (None when H = 0) as int32 movie ids, and one
    bool keep mask per hidden conv ([N, hidden], None to draw them)."""

    random: torch.Tensor
    hard: torch.Tensor | None = None
    keep: list[torch.Tensor] | None = None


class Trainer(TrainLoop):
    """Dataset + model state for one config, on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for)."""

    def __init__(self, cfg: Config, data: MovieLensData,
                 logger: MetricsLogger | None = None, device=None):
        device = resolve_device(device)
        # ---- optional device mesh -------------------------------------------
        self.mesh = self.world = self.shard = None
        if cfg.mesh.mesh_shape is not None:
            self.mesh = mesh_mod.make_mesh(tuple(cfg.mesh.mesh_shape))
            self.world = torch.distributed.group.WORLD
            device = mesh_mod.rank_device(device)
            self._data_size = mesh_mod.axis_size(self.mesh, "data")
        mc = cfg.model
        # Steps and embedding passes run eager under a mesh.
        super().__init__(cfg, data, logger, device, graphed=self.mesh is None,
                         init_params=lambda g: pinsage.init_params(
                             g, cfg.features.feature_dim, mc.hidden_dim, mc.embed_dim,
                             mc.num_layers, mc.aggregator_type, use_batch_norm=mc.use_batch_norm,
                             init_style=mc.init_style, device=device))

        # ---- graph ---------------------------------------------------------
        if cfg.graph.use_bipartite_graph:
            self.csr = data.build_bipartite_graph()
        else:
            self.csr = data.build_item_similarity_graph(
                threshold=cfg.graph.similarity_threshold, logger=self.log)
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
        table = np.asarray(table, np.float32)
        m = 1 if self.mesh is None else mesh_mod.axis_size(self.mesh, "model")
        if cfg.mesh.shard_tables and m > 1:
            # Row-shard the tables over the model axis: the rows padded to
            # a multiple of it (table_rows changes as in JAX), the rank
            # keeping its own.
            table, _ = mesh_mod.pad_to_multiple(table, m)
            self.shard = mesh_mod.row_shard(self.mesh, table.shape[0])
        self.table_rows = int(table.shape[0])
        rows = slice(None) if self.shard is None else slice(self.shard.start, self.shard.stop)
        self.x_table = torch.as_tensor(table[rows], device=self.device)
        if self.shard is not None and cfg.mesh.shard_graph:
            self.graph = sharded_walk.sharded_device_graph(self.csr, self.shard.group,
                                                           self.device)
        else:
            self.graph = rw.device_graph(self.csr, self.device)

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
        # The step's epoch on the device, filled before each block, so that
        # a captured step reads the new value.
        self._epoch = torch.zeros((), dtype=torch.float32, device=self.device)
        self.nbr_tables: list[tuple[torch.Tensor, torch.Tensor]] | None = None
        self.pool_mats: tuple = ()
        self.bwd_layouts: list | None = None
        # Per layout, the share of slots it leaves out for a weight of 0
        # (on the device; read back for the ``neighborhoods`` event).
        self.bwd_zero_weight_share: torch.Tensor | None = None
        self._block_perm: np.ndarray | None = None   # block rung's node order

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
        """Resample one neighborhood table per layer for every table row
        (``walk_tables``), then rebuild the pool operators. PPR tables
        (``walk.strategy="ppr"``) are deterministic: they are built once
        (logged as ``ppr_tables``) and every later refresh keeps them and
        their operators."""
        cfg = self.cfg
        if cfg.walk.strategy == "ppr":
            if self.nbr_tables is not None:
                return
            tables = ppr.all_node_neighborhood_tables_ppr(
                self.graph, cfg.model.num_layers, cfg.walk.num_neighbors,
                num_nodes=self.table_rows, restrict_below=self._count_below(),
                alpha=cfg.walk.ppr_alpha, num_iterations=cfg.walk.ppr_iterations,
                batch=cfg.walk.ppr_batch)
            self.log.log("ppr_tables", rows=self.table_rows, batch=cfg.walk.ppr_batch)
            dense = None
        elif cfg.walk.strategy == "random_walk":
            with span("trainer.refresh.walks", sync=self.device):
                tables, dense = self.walk_tables()
        else:
            raise ValueError(f"unknown walk.strategy {cfg.walk.strategy!r} "
                             "(expected 'random_walk' or 'ppr')")
        with span("trainer.refresh.pool_build", sync=self.device):
            self.set_neighborhood_tables(tables, dense)

    def _count_below(self) -> int | None:
        """The walks count only movie nodes of a bipartite graph
        (``walk.count_nodes="movies"``), else every node."""
        cfg = self.cfg
        return (self.data.num_movies
                if cfg.walk.count_nodes == "movies" and cfg.graph.use_bipartite_graph else None)

    def walk_tables(self) -> tuple[list, tuple | None]:
        """One freshly walked ([N, K] ids, [N, K] weights) table per layer
        for every table row, drawn from the trainer's generator, and on the
        dense and hybrid rungs their pool matrices, built from the tables in
        the same program (else None): where ``graphed``, a replay of the
        refresh's CUDA graph (one per shape, ``rw.all_node_neighborhood_tables``,
        kept in ``graphs.programs``), else eager. The two draw the same
        numbers and leave the generator in the same state."""
        cfg = self.cfg
        n_dense = self._dense_layers()
        then = None
        if n_dense:
            then = (("dense", n_dense), lambda nbrs, wts: self._dense_matrices(
                list(zip(nbrs, wts)), n_dense))
        out = rw.all_node_neighborhood_tables(
            self.graph, cfg.model.num_layers, cfg.walk.num_walks, cfg.walk.walk_length,
            cfg.walk.num_neighbors, self.n_iters, generator=self.generator,
            num_nodes=self.table_rows, restrict_below=self._count_below(),
            graphs=self.graphs.programs, graphed=self.graphed, then=then)
        return out if n_dense else (out, None)

    def set_neighborhood_tables(self, tables, dense: tuple | None = None) -> None:
        """Use the given per-layer ([N, K] ids, [N, K] weights) tables (tensors
        or arrays, every table row) and build the pool operators of the
        config's rung (``_pool_operators``; ``dense``: the dense rung's
        matrices, already built from these tables by ``walk_tables``). With
        ``gather_impl="pallas"`` it also builds the backward kernel's layouts
        (``full_graph_layouts``).
        Under a row shard the operators are built for the rank's rows and
        the rank keeps its rows of the tables.

        Captured graphs read the old tables, operators and layouts. Where
        two sets fit on the card, the new set is copied into the old one's
        storage when the shapes match, and the graphs stay (else the new set
        lies elsewhere, and the graphs' record drops them at their next use);
        where not, the graphs are dropped and the old set freed before the
        new one is built."""
        made = {}      # one tensor per input object: layers may share a table

        def on_device(x, dtype):
            if id(x) not in made:
                t = torch.as_tensor(x if torch.is_tensor(x) else np.array(x),
                                    dtype=dtype, device=self.device)
                made[id(x)] = t.clone() if t is x else t   # owned: it may be copied into
            return made[id(x)]

        old = (self.nbr_tables, self.pool_mats, self.bwd_layouts)
        if not (self.graphs.graphs and self._fits_twice(old)):
            self.graphs.drop(programs=False)      # the refresh reads no tables
            old = None
        self.nbr_tables = [(on_device(nb, torch.int32), on_device(w, torch.float32))
                           for nb, w in tables]
        # Drop the old operators before building the new ones (unless kept
        # for the graphs above): at scale two sets do not fit on the card
        # together.
        self.pool_mats = ()
        self.bwd_layouts = self.bwd_zero_weight_share = None
        pooled = (self.cfg.model.aggregator_type == "importance"
                  and self.cfg.train.train_path != "mlp")
        if pooled:
            self.pool_mats = self._pool_operators(dense)
        if self.shard is not None:
            rows = slice(self.shard.start, self.shard.stop)
            self.nbr_tables = [(nb[rows], w[rows]) for nb, w in self.nbr_tables]
        if pooled and self.gather_impl == "pallas":
            self.bwd_layouts = self.full_graph_layouts()
            self.bwd_zero_weight_share = self._zero_weight_shares()
        if old is not None:
            new = (self.nbr_tables, self.pool_mats, self.bwd_layouts)
            if copy_into(old, new):
                self.nbr_tables, self.pool_mats, self.bwd_layouts = old

    def _fits_twice(self, tables_and_operators) -> bool:
        """Whether a second set of tables, operators and layouts of this
        size fits in half the card's free memory."""
        if self.device.type != "cuda":
            return True
        size = sum(t.numel() * t.element_size() for t in tensors(tables_and_operators))
        return 2 * size <= torch.cuda.mem_get_info(self.device)[0]

    def _full_graph_gathers(self) -> list:
        """Per full-graph layer, the (ids, weights, limit) its gather pools:
        a gather layer's walk table (limit ``valid_limit``), a hub layer's
        residual (limit N, as the residual pools over the whole table);
        None for a dense or block layer. Layers 0..L-2 pool the whole graph
        with the same tables until the next refresh (the last layer pools
        the batch's rows). Under a row shard: the rank's rows, with global
        ids."""
        limit = min(self.valid_limit, self.table_rows)
        gathers = []
        for i in range(self.cfg.model.num_layers - 1):
            pm = self.pool_mats[i] if i < len(self.pool_mats) else None
            if isinstance(pm, HubPool):
                gathers.append((pm.res_nbrs, pm.res_w, self.table_rows))
            elif pm is None:
                gathers.append((*self.nbr_tables[min(i, len(self.nbr_tables) - 1)], limit))
            else:
                gathers.append(None)
        return gathers

    def full_graph_layouts(self) -> list:
        """``ops.pool.segment_layout`` of each full-graph layer's gather
        (``_full_graph_gathers``) for the backward kernel, built with its
        weights, so that the slots of weight 0 (the hub residual's padding)
        are left out; None for a dense or block layer."""
        return [None if gt is None else segment_layout(gt[0], gt[2], weights=gt[1])
                for gt in self._full_graph_gathers()]

    def _zero_weight_shares(self) -> torch.Tensor | None:
        """Per layout of ``bwd_layouts``, on the device: the share of its
        table's slots that it leaves out for a weight of 0 (the slots with
        an id in range less those it keeps), or None without layouts."""
        shares = []
        for lay, gt in zip(self.bwd_layouts or (), self._full_graph_gathers()):
            if lay is not None:
                nbrs, _, limit = gt
                kept = lay.row_ptr[-1]
                in_range = ((nbrs >= 0) & (nbrs < limit)).sum()
                shares.append((in_range - kept).float() / max(nbrs.numel(), 1))
        return torch.stack(shares) if shares else None

    def _pool_operators(self, dense: tuple | None = None) -> tuple:
        """The pooling rung, as the JAX trainer picks it: ``dense`` (one
        [N, N] matrix per layer), ``hybrid`` (matrices for layers 0..L-2,
        gather for the last), ``hub`` (a ``HubPool`` for layers 0..L-2, and
        for the last too under ``hub_pool_final_layer``, or under ``auto``
        when the slabs fit ``auto_hub_final_max_bytes``), ``block``, or
        ``gather`` (no operators). ``auto`` takes dense, then hybrid, up to
        their row limits; above them hub, then block when a hub layer drops
        more mass than its gate (after one doubling of the residual), then
        gather when a block layer does. Under a row shard each operator
        holds the rank's rows (a block operator its row blocks, where they
        divide the model axis). ``dense`` holds the dense rung's matrices
        where they were built already."""
        m = self.cfg.model
        impl, n_layers, rows = m.pool_impl, m.num_layers, self.table_rows
        n_dense, n_hub, n_block = self._dense_layers(), 0, 0
        if n_dense:
            return dense if dense is not None else self._dense_matrices(self.nbr_tables, n_dense)
        if n_layers > 1 and impl == "block":
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
        return ()

    def _dense_layers(self) -> int:
        """How many leading layers pool through [N, N] matrices: every layer
        on the dense rung, all but the last on the hybrid rung, else 0 (no
        pooling, or another rung)."""
        m = self.cfg.model
        impl, n_layers, rows = m.pool_impl, m.num_layers, self.table_rows
        if m.aggregator_type != "importance" or self.cfg.train.train_path == "mlp":
            return 0
        if impl == "dense" or (impl == "auto" and rows <= m.dense_pool_max_rows):
            return n_layers
        if n_layers > 1 and (impl == "hybrid" or (
                impl == "auto" and rows <= m.dense_pool_hybrid_max_rows)):
            return n_layers - 1
        return 0

    def _dense_matrices(self, tables, n_dense: int) -> tuple:
        """The [N (the rank's rows under a shard), N] pool matrix of each of
        the first ``n_dense`` tables, at an aligned row stride with zero
        columns past N (``pinsage.padded_pool_matrix``; the products read
        it as it is), cast to ``pool_dtype`` after the bf16 build, as JAX
        does (a scatter-add into float8 would round every addition)."""
        pool_dtype = hub_mod.resolve_pool_matrix_dtype(self.cfg.model.pool_matrix_dtype,
                                                       self.table_rows, "dense")
        mine = slice(None) if self.shard is None else slice(self.shard.start, self.shard.stop)
        return tuple(
            pinsage.padded_pool_matrix(nbrs[mine], w[mine], num_cols=self.table_rows,
                                       valid_limit=self.valid_limit).to(pool_dtype)
            for nbrs, w in tables[:n_dense])

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
                    residual=residual, dtype=pool_dtype,
                    rows=None if self.shard is None else (self.shard.start, self.shard.stop))

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
                feats = (self.x_table if self.shard is None
                         else coll.all_gather_rows(self.x_table, self.shard.group))
                self._block_perm = bsp.cluster_permutation(
                    feats, num_clusters=m.block_pool_clusters, seed=self.cfg.train.seed)
            self.log.log("block_cluster", order=m.block_pool_order,
                         seconds=time.perf_counter() - t0)
        pool_dtype = hub_mod.resolve_pool_matrix_dtype(m.pool_matrix_dtype, self.table_rows,
                                                       "block")
        blocks = None
        r_blocks = -(-self.table_rows // m.block_pool_block_size)
        if self.shard is not None and r_blocks % self.shard.size == 0:
            # Row blocks divide the model axis: the rank holds its share
            # (else every rank holds them all, as JAX replicates them).
            per = r_blocks // self.shard.size
            blocks = (self.shard.index * per, (self.shard.index + 1) * per)
        mats = []
        for nbrs, w in tables:
            bp, stats = bsp.build_block_pool(
                nbrs, w, self._block_perm, valid_limit=self.valid_limit,
                block_size=m.block_pool_block_size, max_blocks=m.block_pool_max_blocks,
                device=self.device, blocks=blocks)
            self.log.log("block_pool", **stats)
            if stats["dropped_mass"] > m.block_pool_max_dropped_mass:
                self.log.log("block_pool_fallback", dropped_mass=stats["dropped_mass"])
                return ()
            mats.append(bp._replace(a_blocks=bp.a_blocks.to(pool_dtype)))
        return tuple(mats)

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

    def step_config(self, epoch) -> sharding.ShardedStepConfig:
        """The step's settings (``parallel.sharding.step_loss``) at ``epoch``
        (a number or a 0-d tensor on the device)."""
        cfg = self.cfg
        return sharding.ShardedStepConfig(
            aggregator=cfg.model.aggregator_type, loss=cfg.train.loss, margin=cfg.train.margin,
            epoch=epoch, max_epochs=cfg.train.epochs, hard_neg_factor=cfg.train.hard_neg_factor,
            nce_temperature=cfg.train.nce_temperature, valid_limit=self.valid_limit,
            dtype=self.compute_dtype, dropout=cfg.model.dropout, gather_impl=self.gather_impl,
            train_path=cfg.train.train_path)

    def loss_and_grads(self, q: torch.Tensor, p: torch.Tensor, draws: StepDraws,
                       epoch) -> tuple[torch.Tensor, Any]:
        """The step's loss and its gradient in every parameter (zeros for
        the ones the loss does not read, as JAX's), at ``self.params``; under
        a mesh, of the whole batch (each rank's share summed)."""
        scfg = self.step_config(epoch)
        return sharding.loss_and_grads(
            lambda params: sharding.step_loss(
                scfg, params, self.x_table, [t[0] for t in self.nbr_tables or []],
                [t[1] for t in self.nbr_tables or []], self.pool_mats, q, p, draws.random,
                draws.hard, self.generator, draws.keep, self.bwd_layouts, self.shard,
                self.world),
            self.params, self.world)

    def step(self, q: torch.Tensor, p: torch.Tensor, num_hard: int,
             draws: StepDraws | None = None) -> torch.Tensor:
        """One step at the lr and epoch last filled in by ``train_steps``:
        the negatives (``draws`` if given, else drawn), the loss and its
        gradient, and an in-place Adam update of ``self.params``. Returns
        the loss."""
        d = draws if draws is not None else self.draw_step(q, num_hard)
        loss, grads = self.loss_and_grads(q, p, d, self._epoch)
        optim.adam_update(grads, self.opt_state, self.params, self._lr)
        return loss

    def graph_inputs(self) -> tuple:
        return (self.x_table, self.nbr_tables, self.pool_mats, self.bwd_layouts, self.graph,
                self._epoch)

    def _block(self, q_blk, p_blk, epoch: float, num_hard: int) -> tuple:
        """A block's query and positive ids as int32 on the device (the
        tables refreshed first where there are none), the epoch filled in,
        the step graph's key (``num_hard``, batch size, rung) and its
        step."""
        if self.nbr_tables is None and self.cfg.train.train_path != "mlp":
            self.refresh_neighborhoods()
        q_blk = torch.as_tensor(q_blk, dtype=torch.int32, device=self.device)
        p_blk = torch.as_tensor(p_blk, dtype=torch.int32, device=self.device)
        self._epoch.fill_(epoch)
        key = ("step", num_hard, int(q_blk.shape[1]), rung(self.pool_mats))
        return q_blk, p_blk, key, lambda q, p, draws=None: self.step(q, p, num_hard, draws)

    # ---- epoch loop -------------------------------------------------------

    def _epoch_pairs(self, rng: np.random.Generator) -> np.ndarray:
        pairs = self.train_pairs
        cap = self.cfg.train.max_pairs_per_epoch
        if cap is not None and pairs.shape[0] > cap:
            pairs = pairs[rng.choice(pairs.shape[0], size=cap, replace=False)]
        else:
            pairs = pairs[rng.permutation(pairs.shape[0])]
        # Pad to a whole number of fixed-size batches (wrap-around). Under a
        # mesh the batch divides the data axis, as JAX's.
        bsz = min(self.cfg.train.batch_size, max(pairs.shape[0], 1))
        if self.mesh is not None:
            bsz = max(bsz - bsz % self._data_size, self._data_size)
        pad = (-pairs.shape[0]) % bsz
        if pad:
            reps = 2 + pad // max(pairs.shape[0], 1)
            pairs = np.concatenate([pairs] * reps, axis=0)[: pairs.shape[0] + pad]
        return pairs.reshape(-1, bsz, 2)

    def epoch_batches(self, epoch: int) -> tuple:
        """The epoch's batches on the device, ``q_all``, ``p_all`` [S, B]
        int32, cut into blocks of ``block`` = min(8, steps) steps, the step
        count padded to whole blocks (wrap-around) as JAX's scanned blocks
        are: the padded steps update the params and are left out of the
        loss mean. Returns (q_all, p_all, block, real steps, num_hard)."""
        cfg = self.cfg
        batches = self._epoch_pairs(np.random.default_rng(cfg.train.seed + 1000 + epoch))
        num_hard = (negative.curriculum_num_hard(epoch, cfg.train.max_hard_negatives)
                    if cfg.train.loss in ("curriculum", "nce")
                    and cfg.train.train_path != "mlp" else 0)
        s_total = batches.shape[0]
        block = min(self.steps_per_call, s_total)
        pad_steps = (-s_total) % block
        if pad_steps:
            batches = np.concatenate([batches, batches[:pad_steps]], axis=0)
        q_all = torch.as_tensor(batches[:, :, 0], dtype=torch.int32, device=self.device)
        p_all = torch.as_tensor(batches[:, :, 1], dtype=torch.int32, device=self.device)
        return q_all, p_all, block, s_total, num_hard

    def _epoch_steps(self, epoch: int, batches: tuple) -> tuple[tuple, int]:
        return (float(epoch), batches[4]), batches[3]

    def train_epoch(self, epoch: int) -> dict[str, Any]:
        """The neighbourhood refresh where it is due (span
        ``trainer.refresh``), then the epoch's steps (``TrainLoop``)."""
        refresh = self.cfg.train.refresh_neighborhoods_every
        refresh_s = 0.0
        if self.nbr_tables is None or (refresh and epoch % refresh == 0):
            with span("trainer.refresh", timed=True) as sp:
                self.refresh_neighborhoods()
                self._sync()
            refresh_s = sp.seconds
            zero = self.bwd_zero_weight_share     # computed by the refresh, read after its sync
            pad = [pm.shape[1] - self.table_rows for pm in self.pool_mats if torch.is_tensor(pm)]
            self.log.log("neighborhoods", epoch=epoch, seconds=refresh_s,
                         **({} if zero is None else {"bwd_zero_weight_share": zero.tolist()}),
                         **({"dense_pad_cols": pad} if pad else {}))
        return {**super().train_epoch(epoch), "refresh_seconds": round(refresh_s, 2)}

    def _epoch_stats(self, batches: tuple, times) -> dict[str, Any]:
        bsz, block = int(batches[0].shape[1]), batches[2]
        exps = (bsz * times.timed_steps / times.timed_seconds
                if times.timed_steps and times.timed_seconds > 0
                else bsz * block / max(times.first_block_seconds, 1e-9))
        return {"examples_per_sec": exps, "num_hard": batches[4]}

    # ---- inference / eval -------------------------------------------------

    @torch.no_grad()
    def movie_embeddings(self, params=None) -> torch.Tensor:
        """[num_movies, embed_dim] f32 via the full pooled forward (under a
        row shard each rank embeds its rows, then all-gathers them): a
        replay of the pass's CUDA graph where ``graphed`` and ``params`` is
        None or ``self.params``, which the graph reads in place."""
        if self.nbr_tables is None:
            self.refresh_neighborhoods()
        return self._cached_call(("embed", rung(self.pool_mats)), self._embed, params)

    def _embed(self, params) -> torch.Tensor:
        m = self.data.num_movies
        x = self.x_table
        if self.cfg.train.train_path == "mlp" and self.shard is None:
            x = x[:m]
        emb = sharding.embed(self.step_config(0.0), params, x,
                             [t[0] for t in self.nbr_tables], [t[1] for t in self.nbr_tables],
                             self.pool_mats, self.shard)
        if self.shard is not None:
            emb = coll.all_gather_rows(emb, self.shard.group)
        return emb[:m]

    def evaluate(self, pairs: np.ndarray | None = None, params=None) -> dict[str, float]:
        """HR@k / MRR of ``pairs`` (the test pairs if None) over the
        embedding pass at ``params``; its duration is kept in
        ``eval_seconds``."""
        with span("trainer.evaluate", timed=True) as sp:
            out = self._evaluate(self.test_pairs if pairs is None else pairs, params)
        self.eval_seconds = sp.seconds
        return out

    def _evaluate(self, pairs: np.ndarray | None, params) -> dict[str, float]:
        with span("trainer.evaluate.embed", sync=self.device):
            emb = self.movie_embeddings(params)
        if pairs is None or pairs.shape[0] == 0:
            # No interaction-derived pairs: genre-similarity fallback.
            from ..evaluation.fallback import evaluate_genre_similarity

            out = evaluate_genre_similarity(
                emb, self.data.genres, k_values=self.cfg.eval.k_values,
                mrr_scale=self.cfg.eval.mrr_scale, seed=self.cfg.train.seed)
            out["fallback"] = "genre_similarity"
            return out
        with span("trainer.evaluate.ranks"):
            return eval_metrics.evaluate_embeddings(
                emb, pairs, k_values=self.cfg.eval.k_values,
                mrr_scale=self.cfg.eval.mrr_scale, graphs=self.graphs.programs,
                graphed=self.graphed)


    # ---- checkpoint / main loop (``TrainLoop``) ----------------------------

    def _params_from(self, flat: dict[str, np.ndarray]):
        """The params of a checkpoint's flat leaves, on the device."""
        return ckpt.params_from_jax(flat, self.device)

    def validate(self) -> dict[str, float] | None:
        """``evaluate`` on the validation pairs (a fixed-seed sample of
        ``eval.max_val_pairs`` where capped), or None without any."""
        vp = self.val_pairs
        if vp.shape[0] == 0:
            return None
        cap = self.cfg.eval.max_val_pairs
        if cap is not None and vp.shape[0] > cap:
            vp = vp[np.random.default_rng(self.cfg.train.seed + 7).choice(
                vp.shape[0], size=cap, replace=False)]
        return self.evaluate(vp)
