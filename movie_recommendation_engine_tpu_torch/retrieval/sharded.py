"""Distributed retrieval over row-sharded embedding tables.

Port of ``movie_recommendation_engine_tpu/retrieval/sharded.py``. Each rank
of the group holds rows ``[s*C, (s+1)*C)`` of the corpus, scores them and
keeps a local top-k; one all-gather of the [S, Q, kk] partials and a merge
give the exact global top-k on every rank. Padding rows count as ``+inf``
distance (``-inf`` similarity), so they never win. Ranks go through
``core.ranking.top_k``: ties come out in ``lax.top_k``'s order, the lower
position first, which is the lower global id within a shard's list and the
lower shard in the merge.

IVF: ``sharded_kmeans`` sums its clusters per rank (one-hot GEMMs, as
``ivf.kmeans``) and all-reduces sums and counts; the balancing and the
cluster order are host numpy, identical on every rank; each rank then
holds a contiguous group of whole inverted lists, and a search scans only
the probed lists that live on it.

``group=None`` (no process group) is a world of one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..core.ranking import top_k
from ..parallel import collectives as coll
from ..parallel.mesh import axis_group, pad_to_multiple
from .ivf import _sq_dists, init_indices, pairwise_sq_dists


def _group(mesh, axis: str):
    """The mesh's axis group; without a mesh every rank of the default
    group (JAX's ``(1, n)`` mesh), or None in a single process."""
    if mesh is not None:
        return axis_group(mesh, axis)
    return dist.group.WORLD if dist.is_initialized() else None


def shard_embeddings(embeddings, group, device=None) -> tuple[torch.Tensor, int]:
    """The rank's rows of ``embeddings`` zero-padded to a multiple of the
    group's size, on ``device``: (rows [C, D], original row count)."""
    emb = np.asarray(embeddings.cpu() if torch.is_tensor(embeddings) else embeddings,
                     np.float32)
    s, r = coll.size(group), coll.rank(group)
    padded, orig = pad_to_multiple(emb, s)
    c = padded.shape[0] // s
    return torch.as_tensor(padded[r * c:(r + 1) * c], device=resolve_device(device)), orig


def _merge(scores: torch.Tensor, ids: torch.Tensor, k: int, group, largest: bool):
    """All-gather each rank's [Q, kk] partials and keep the top ``k`` of
    the [Q, S*kk] union, shard-major."""
    s, (q, kk) = coll.size(group), scores.shape
    all_s = coll.all_gather_rows(scores.contiguous(), group).reshape(s, q, kk)
    all_i = coll.all_gather_rows(ids.contiguous(), group).reshape(s, q, kk)
    flat_s = all_s.permute(1, 0, 2).reshape(q, s * kk)
    flat_i = all_i.permute(1, 0, 2).reshape(q, s * kk)
    top, pos = top_k(flat_s, min(k, s * kk), largest=largest)
    return top, flat_i.gather(1, pos)


def sharded_similarity_topk(group, emb: torch.Tensor, queries: torch.Tensor, k: int,
                            valid_rows: int | None = None):
    """Exact inner-product top-k over a row-sharded corpus (``emb`` the
    rank's [C, D] rows): (scores [Q, k], global ids [Q, k]) on every rank.
    Rows ``>= valid_rows`` (padding) score ``-inf``: similarities are
    signed, so a zero padding row would otherwise win when every real score
    is negative."""
    c = emb.shape[0]
    start = coll.rank(group) * c
    limit = c * coll.size(group) if valid_rows is None else valid_rows
    sims = queries @ emb.T
    rows = start + torch.arange(c, device=emb.device)
    sims = torch.where(rows[None, :] < limit, sims, -torch.inf)
    scores, idx = top_k(sims, min(k, c))
    return _merge(scores, idx + start, k, group, largest=True)


def sharded_l2_topk(group, emb: torch.Tensor, queries: torch.Tensor, k: int,
                    valid_rows: int):
    """Exact squared-L2 top-k over a row-sharded corpus (``||q||^2 +
    ||x||^2 - 2 q.x``, as ``exact.ExactIndex``): (distances [Q, k], global
    ids [Q, k]) on every rank; padding rows are ``+inf``."""
    c = emb.shape[0]
    start = coll.rank(group) * c
    dist_ = ((queries * queries).sum(dim=1, keepdim=True) + (emb * emb).sum(dim=1)[None, :]
             - 2.0 * (queries @ emb.T))
    rows = start + torch.arange(c, device=emb.device)
    dist_ = torch.where(rows[None, :] < valid_rows, dist_, torch.inf)
    d, idx = top_k(dist_, min(k, c), largest=False)
    return _merge(d, idx + start, k, group, largest=False)


class ShardedExactIndex:
    """Exact retrieval over a row-sharded corpus with the index API (build /
    search / ntotal), so the benchmark harness and the batched server run
    over it unchanged. ``mesh`` (its ``axis``) names the group; without one,
    every rank of the process group, or this process alone."""

    # Eager by rule: the search runs collectives, which gloo stages through
    # the host (nothing a CUDA graph can capture); no capture under NCCL yet.
    graphed = False

    def __init__(self, dim: int, mesh=None, axis: str = "model", device=None):
        self.dim = dim
        self.group = _group(mesh, axis)
        self.device = resolve_device(device)
        self._emb: torch.Tensor | None = None
        self._orig = 0

    @property
    def ntotal(self) -> int:
        return self._orig

    def build(self, embeddings) -> None:
        """``embeddings`` [N, D], the whole corpus (each rank keeps its rows)."""
        self._emb, self._orig = shard_embeddings(embeddings, self.group, self.device)

    def build_shard(self, rows: torch.Tensor, ntotal: int) -> None:
        """The rank's rows as they come from ``parallel.sharding.
        sharded_embed_fn`` (no gather): [C, D] of a corpus of ``ntotal``."""
        self._emb, self._orig = rows.float().to(self.device), int(ntotal)

    def search(self, queries, k: int = 10):
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return sharded_l2_topk(self.group, self._emb, q, k, valid_rows=self._orig)


def sharded_ivf_topk(group, emb: torch.Tensor, norm2: torch.Tensor, perm: torch.Tensor,
                     centroids: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
                     queries: torch.Tensor, nprobe: int, max_list: int, k: int):
    """Distributed IVF search: the global top-``nprobe`` lists of each query
    (the coarse quantizer on every rank), each rank scanning the probed
    lists that live in its rows (``emb`` / ``norm2`` / ``perm`` its
    ``[C]`` rows of the cluster-ordered, group-padded table; ``perm`` the
    original id of each row, -1 for padding; ``starts`` / ``ends`` the
    lists in padded coordinates), a running top-k per rank, then the merge.
    Returns (distances [Q, k], ids [Q, k]), ``inf`` / -1 where missing."""
    c = emb.shape[0]
    lo = coll.rank(group) * c
    qn = queries.shape[0]
    kk = min(k, nprobe * max_list)
    slot = torch.arange(max_list, device=emb.device)
    probe = top_k(_sq_dists(queries, centroids), nprobe, largest=False)[1]
    st, en = starts[probe], ends[probe]                                  # [Q, nprobe]
    q_norm2 = (queries * queries).sum(dim=1, keepdim=True)
    best_d = torch.full((qn, kk), float("inf"), device=emb.device)
    best_i = torch.full((qn, kk), -1, dtype=torch.int64, device=emb.device)
    for j in range(nprobe):
        cand = st[:, j, None] + slot[None, :]                            # [Q, L]
        valid = (cand < en[:, j, None]) & (cand >= lo) & (cand < lo + c)
        lc = torch.where(valid, cand - lo, 0)
        ip = torch.bmm(emb[lc], queries[:, :, None]).squeeze(2)
        d = torch.where(valid, q_norm2 - 2.0 * ip + norm2[lc], float("inf"))
        all_d = torch.cat([best_d, d], dim=1)
        all_i = torch.cat([best_i, perm[lc]], dim=1)
        pos = top_k(all_d, kk, largest=False)[1]
        best_d, best_i = all_d.gather(1, pos), all_i.gather(1, pos)
    d, ids = _merge(best_d, best_i, k, group, largest=False)
    if d.shape[1] < k:
        d = torch.nn.functional.pad(d, (0, k - d.shape[1]), value=float("inf"))
        ids = torch.nn.functional.pad(ids, (0, k - ids.shape[1]), value=-1)
    return d, torch.where(torch.isfinite(d), ids, -1)


def sharded_kmeans(group, x: torch.Tensor, init_centroids: torch.Tensor, valid_rows: int,
                   iters: int = 15):
    """Lloyd k-means over a row-sharded table (``x`` the rank's [C, D] rows,
    zero-padded past ``valid_rows``): assignments are local products, the
    cluster sums and counts local one-hot GEMMs summed over the group.
    Padding rows weigh nothing and are assigned -1. Returns (centroids
    [P, D] on every rank, the rank's assignments [C] int64). The same math
    as ``ivf.kmeans`` up to f32 summation order."""
    c, p = x.shape[0], init_centroids.shape[0]
    rows = coll.rank(group) * c + torch.arange(c, device=x.device)
    w = (rows < valid_rows).float()
    clusters = torch.arange(p, device=x.device)
    centroids = init_centroids.float()
    for _ in range(iters):
        assign = torch.argmin(_sq_dists(x, centroids), dim=1)
        onehot = (assign[None, :] == clusters[:, None]).float() * w[None, :]     # [P, C]
        sums = coll.all_reduce_(onehot @ x, group)
        counts = coll.all_reduce_(onehot.sum(dim=1, keepdim=True), group)
        centroids = torch.where(counts > 0, sums / counts.clamp_min(1.0), centroids)
    assign = torch.argmin(_sq_dists(x, centroids), dim=1)
    return centroids, torch.where(rows < valid_rows, assign, -1)


def balance_assignments_bounded(x, centroids, assign, cap: int):
    """``ivf.balance_assignments`` with bounded host memory: distances only
    for the rows of overfull clusters (to their own centroid) and for the
    spilled rows (to every centroid), never the full [N, P] table. The same
    spill decisions: the same stable orders and the same nearest centroid
    with room."""
    p = centroids.shape[0]
    cap = max(cap, -(-x.shape[0] // p))
    counts = np.bincount(assign[assign >= 0], minlength=p)
    if counts.max(initial=0) <= cap:
        return assign
    assign = assign.copy()
    room = cap - counts
    spilled: list[int] = []
    for c in np.flatnonzero(counts > cap):
        rows = np.flatnonzero(assign == c)
        # The clamped three-term form of ivf.balance_assignments, so that
        # near-ties order alike.
        d_own = pairwise_sq_dists(np.asarray(x[rows], np.float32), centroids[c:c + 1])[:, 0]
        order = np.argsort(d_own, kind="stable")
        spilled.extend(int(r) for r in rows[order[cap:]])
        room[c] = 0
    d2 = pairwise_sq_dists(np.asarray(x[spilled], np.float32), centroids)
    for i, r in enumerate(spilled):
        for c in np.argsort(d2[i]):
            if room[c] > 0:
                assign[r] = c
                room[c] -= 1
                break
    return assign


class ShardedIVFIndex:
    """IVF / Weak-AND retrieval over a row-sharded corpus with the index API
    and the single-device ``ivf.WeakANDIndex``'s results: the global
    top-``nprobe`` lists, each rank scanning those in its rows, one merge.
    A rank holds about ``N / S`` rows plus one list's padding, and the
    replicated [P, D] centroids. ``init_idx`` gives k-means' initial rows
    (default ``ivf.init_indices``)."""

    # Eager by rule: the search runs collectives, which gloo stages through
    # the host (nothing a CUDA graph can capture); no capture under NCCL yet.
    graphed = False

    def __init__(self, dim: int, mesh=None, axis: str = "model", num_partitions: int = 100,
                 candidates_factor: int = 0, nprobe: int = 20, seed: int = 0,
                 balance_factor: float = 4.0, device=None, init_idx=None):
        self.dim = dim
        self.group = _group(mesh, axis)
        self.device = resolve_device(device)
        self.num_partitions = num_partitions
        self.candidates_factor = candidates_factor
        self.nprobe = min(num_partitions, nprobe)
        self.seed = seed
        self.balance_factor = balance_factor
        self.init_idx = init_idx
        self._emb = self._norm2 = self._perm = None
        self._starts = self._ends = self._centroids = None
        self._max_list = 0
        self._orig = 0

    @property
    def ntotal(self) -> int:
        return self._orig

    def build(self, embeddings) -> None:
        """No rank ever holds the whole table on its device: k-means over
        the row-sharded input (``sharded_kmeans``), then the balancing, the
        cluster order and the split of whole lists into ``S`` contiguous
        groups of near-equal rows on the host, and each rank's group placed
        on its device, padded to a common ``C``."""
        x_np = np.asarray(embeddings.cpu() if torch.is_tensor(embeddings) else embeddings,
                          np.float32)
        n, d = x_np.shape
        p = min(self.num_partitions, n)
        size, me = coll.size(self.group), coll.rank(self.group)

        x_sh, _ = shard_embeddings(x_np, self.group, self.device)
        init_idx = init_indices(n, p, self.seed) if self.init_idx is None else self.init_idx
        init_c = torch.as_tensor(x_np[np.asarray(init_idx, np.int64)], device=self.device)
        centroids, assign = sharded_kmeans(self.group, x_sh, init_c, valid_rows=n)
        assign_np = coll.all_gather_rows(assign, self.group).cpu().numpy()[:n]
        c_np = centroids.cpu().numpy()
        del x_sh

        if self.balance_factor and n:
            cap = max(1, int(np.ceil(self.balance_factor * n / p)))
            assign_np = balance_assignments_bounded(x_np, c_np, assign_np, cap)
        d_own = np.sum((x_np - c_np[assign_np]) ** 2, axis=1)
        order = np.lexsort((d_own, assign_np))
        counts = np.bincount(assign_np, minlength=p).astype(np.int64)
        offsets = np.zeros(p + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        # Whole lists into `size` contiguous groups of near-equal rows: list
        # j joins the group its row midpoint falls in.
        target = max(n / size, 1.0)
        grp = np.minimum(((offsets[:-1] + counts / 2.0) // target).astype(np.int64), size - 1)
        grp = np.maximum.accumulate(grp) if len(grp) else grp
        rows_per = np.bincount(grp, weights=counts, minlength=size).astype(np.int64)
        chunk = max(int(rows_per.max(initial=1)), 1)
        base = np.zeros(size, dtype=np.int64)
        np.cumsum(rows_per[:-1], out=base[1:])
        mine = order[base[me]:base[me] + rows_per[me]]
        emb = np.zeros((chunk, d), np.float32)
        perm = np.full(chunk, -1, np.int64)
        emb[:mine.shape[0]] = x_np[mine]
        perm[:mine.shape[0]] = mine
        starts = grp * chunk + (offsets[:-1] - base[grp])
        dev = self.device
        self._emb = torch.as_tensor(emb, device=dev)
        self._norm2 = (self._emb * self._emb).sum(dim=1)
        self._perm = torch.as_tensor(perm, device=dev)
        self._starts = torch.as_tensor(starts, device=dev)
        self._ends = torch.as_tensor(starts + counts, device=dev)
        self._centroids = centroids
        self._max_list = int(counts.max()) if n else 0
        self._orig = n

    def search(self, queries, k: int = 10):
        budget = max(self._max_list, 1)
        if self.candidates_factor:
            budget = min(budget, max(k * self.candidates_factor, k))
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return sharded_ivf_topk(self.group, self._emb, self._norm2, self._perm,
                                self._centroids, self._starts, self._ends, q,
                                nprobe=self.nprobe, max_list=budget, k=k)
