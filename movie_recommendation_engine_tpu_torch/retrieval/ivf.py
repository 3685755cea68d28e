"""IVF / "Weak AND" two-level retrieval on the device.

Port of ``movie_recommendation_engine_tpu/retrieval/ivf.py`` (replaces FAISS
``IndexIVFFlat`` with an ``IndexFlatL2`` coarse quantizer; defaults 100
partitions, nprobe = min(partitions, 20)):

- **train**: Lloyd k-means as [N, D] x [D, P] products, ``argmin`` (the
  first minimum), and the per-cluster sums as a one-hot [P, N] x [N, D]
  product, which sums in a fixed order (a scatter-add on the card would not).
- **balance**: inverted lists are capped at ``balance_factor`` x the mean
  list size; overflow spills to the next-nearest centroid with room (numpy,
  once at build).
- **add**: rows are reordered by cluster, each list by distance to its
  centroid, so a list is a contiguous range of the table.
- **search**: the ``nprobe`` nearest centroids per query, then one probed
  list per step: gather its fixed-budget [Q, budget, D] candidate block,
  exact L2, merge into a running top-k. The peak transient is one probe's
  block.

JAX runs the whole search (coarse top-k, the ``nprobe`` probes as one
``lax.scan``, the id mapping) as one jitted ``_ivf_search`` program per
query rows and ``k``; on ``cuda`` it is one CUDA graph per (query rows,
``k``, ``nprobe``, budget), captured at the key's second call
(``core/graphs.SearchGraphs``). k-means' iterations, one jitted scan in
JAX, are one CUDA graph per shape (``core/graphs.GraphCache``).

Ranks go through ``core.ranking.top_k``, so the lower position comes first
among equal distances (``jax.lax.top_k``'s order). The initial centroids are rows
``init_idx`` when given, else a draw from a ``torch.Generator`` seeded with
``seed`` (not JAX's numbers).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.graphs import GraphCache, SearchGraphs, on_device, use_graphs
from ..core.ranking import top_k


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[N, P] |x|^2 - 2 x.c + |c|^2, unclamped (JAX's in-program form)."""
    return ((x * x).sum(dim=1, keepdim=True) - 2.0 * (x @ c.t())
            + (c * c).sum(dim=1)[None, :])


def init_indices(n: int, num_clusters: int, seed: int = 0) -> torch.Tensor:
    """``num_clusters`` distinct row ids of ``n``, from a seeded generator."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randperm(n, generator=gen)[:num_clusters]


def kmeans(x: torch.Tensor, num_clusters: int, iters: int = 15, seed: int = 0,
           init_idx=None, graphs: GraphCache | None = None,
           graphed: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means on ``x``'s device: (centroids [P, D] f32, assignments
    [N] int64). Starts from rows ``init_idx`` (else ``init_indices``); an
    empty cluster keeps its centroid. JAX scans the iterations in one jitted
    program; through ``graphs`` on ``cuda`` they are one CUDA graph per
    (rows, dim, clusters, iterations), the initial rows copied into its
    static buffer. Given ``init_idx`` (the seam the tests use) it runs eager
    by rule."""
    n = x.shape[0]
    seam = init_idx is not None
    if not seam:
        init_idx = init_indices(n, num_clusters, seed)
    if not torch.is_tensor(init_idx):
        init_idx = np.array(init_idx, dtype=np.int64)
    init = on_device(x.device, init_idx, torch.int64)
    fn = partial(_lloyd, num_clusters=num_clusters, iters=iters)
    if not seam and use_graphs(graphs, graphed, x.device):
        return graphs.run(("kmeans", n, x.shape[1], num_clusters, iters), fn, (x, init))
    return fn(x, init)


def _lloyd(x: torch.Tensor, init: torch.Tensor, num_clusters: int,
           iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    n = x.shape[0]
    centroids = x[init]
    clusters = torch.arange(num_clusters, device=x.device)
    # Rows per one-hot block: [P, rows] f32 stays within 256 MB.
    rows = max(1, (1 << 26) // max(num_clusters, 1))
    for _ in range(iters):
        assign = torch.argmin(_sq_dists(x, centroids), dim=1)
        sums = torch.zeros_like(centroids)
        counts = torch.zeros((num_clusters, 1), device=x.device)
        for s in range(0, n, rows):
            onehot = (assign[None, s:s + rows] == clusters[:, None]).float()   # [P, rows]
            sums += onehot @ x[s:s + rows]
            counts += onehot.sum(dim=1, keepdim=True)
        centroids = torch.where(counts > 0, sums / counts.clamp_min(1.0), centroids)
    return centroids, torch.argmin(_sq_dists(x, centroids), dim=1)


def pairwise_sq_dists(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Host-side [N, P] squared L2 distances via the three-term expansion,
    clamped at 0 (cancellation on near-duplicate rows can go slightly
    negative)."""
    d2 = (
        np.sum(x * x, axis=1, keepdims=True)
        - 2.0 * x @ c.T
        + np.sum(c * c, axis=1)[None, :]
    )
    return np.maximum(d2, 0.0)


def balance_assignments(x: np.ndarray, centroids: np.ndarray, assign: np.ndarray,
                        cap: int) -> np.ndarray:
    """Spill rows beyond ``cap`` per cluster to their next-nearest centroid
    with room (host-side, once at build). Overfull clusters keep their
    ``cap`` most central rows. ``cap`` is raised to ceil(N/P) when
    ``cap * P < N`` (no assignment could honor it)."""
    p = centroids.shape[0]
    cap = max(cap, -(-x.shape[0] // p))
    counts = np.bincount(assign, minlength=p)
    if counts.max(initial=0) <= cap:
        return assign
    assign = assign.copy()
    d2 = pairwise_sq_dists(x, centroids)
    room = cap - counts
    spilled: list[int] = []
    for c in np.flatnonzero(counts > cap):
        rows = np.flatnonzero(assign == c)
        order = np.argsort(d2[rows, c], kind="stable")
        for r in rows[order[cap:]]:
            spilled.append(int(r))
        room[c] = 0
    for r in spilled:
        for c in np.argsort(d2[r]):
            if room[c] > 0:
                assign[r] = c
                room[c] -= 1
                break
    return assign


class WeakANDIndex:
    """build(embeddings) / search(queries, k) on ``device``.

    ``balance_factor`` caps every inverted list at
    ``ceil(balance_factor * N / P)`` rows (0 disables balancing);
    ``candidates_factor`` > 0 bounds each probed list's scan to
    ``k * candidates_factor`` rows. ``init_idx`` gives k-means' initial
    rows. ``graphed`` (on by default on ``cuda``) runs the search and
    k-means as CUDA graphs."""

    def __init__(self, dim: int, num_partitions: int = 100, candidates_factor: int = 0,
                 nprobe: int = 20, seed: int = 0, balance_factor: float = 4.0,
                 device=None, init_idx=None):
        self.dim = dim
        self.num_partitions = num_partitions
        self.candidates_factor = candidates_factor
        self.nprobe = min(num_partitions, nprobe)
        self.seed = seed
        self.balance_factor = balance_factor
        self.device = resolve_device(device)
        self.init_idx = init_idx
        self._emb: torch.Tensor | None = None       # cluster-ordered rows [N, D]
        self._norm2: torch.Tensor | None = None     # [N] squared norms
        self._perm: torch.Tensor | None = None      # original id per row [N]
        self._offsets: torch.Tensor | None = None   # [P+1] list offsets
        self._centroids: torch.Tensor | None = None
        self._max_list = 0
        self.graphed = self.device.type == "cuda"
        self.graphs = SearchGraphs(self.device)
        # k-means' graph: kept across builds, so a rebuild after a re-embed
        # of the same shape replays it.
        self.build_graphs = GraphCache(self.device)

    @property
    def ntotal(self) -> int:
        return 0 if self._emb is None else int(self._emb.shape[0])

    def build(self, embeddings) -> None:
        self.graphs.drop()
        x = torch.as_tensor(embeddings, dtype=torch.float32, device=self.device)
        n = x.shape[0]
        p = min(self.num_partitions, n)
        centroids, assign = kmeans(x, p, seed=self.seed, init_idx=self.init_idx,
                                   graphs=self.build_graphs, graphed=self.graphed)
        assign_np = assign.cpu().numpy()
        x_np = x.cpu().numpy()
        c_np = centroids.cpu().numpy()
        if self.balance_factor and n:
            cap = max(1, int(np.ceil(self.balance_factor * n / p)))
            assign_np = balance_assignments(x_np, c_np, assign_np, cap)
        # Each list ordered by distance to its centroid, so a candidate
        # budget that truncates a list keeps its most central rows.
        d_own = np.sum((x_np - c_np[assign_np]) ** 2, axis=1)
        order = np.lexsort((d_own, assign_np))
        counts = np.bincount(assign_np, minlength=p)
        offsets = np.zeros(p + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        perm = torch.from_numpy(order).to(self.device)
        self._emb = x[perm]
        self._norm2 = (self._emb * self._emb).sum(dim=1)
        self._perm = perm
        self._offsets = torch.from_numpy(offsets).to(self.device)
        self._centroids = centroids
        self._max_list = int(counts.max()) if n else 0

    def search(self, queries, k: int = 10):
        """(squared L2 distances [Q, k] ascending, original ids [Q, k]);
        missing results are ``inf`` / -1."""
        budget = max(self._max_list, 1)
        if self.candidates_factor:
            budget = min(budget, max(k * self.candidates_factor, k))
        fn = partial(ivf_search, emb=self._emb, norm2=self._norm2,
                     centroids=self._centroids, offsets=self._offsets, perm=self._perm,
                     nprobe=self.nprobe, budget=budget, k=k)
        reads = (self._emb, self._norm2, self._centroids, self._offsets, self._perm)
        return self.graphs.search(("ivf", k, self.nprobe, budget), fn, queries, reads,
                                  self.graphed)


def ivf_search(q: torch.Tensor, emb: torch.Tensor, norm2: torch.Tensor,
               centroids: torch.Tensor, offsets: torch.Tensor, perm: torch.Tensor,
               nprobe: int, budget: int, k: int):
    """Probe the ``nprobe`` nearest lists of each query, ``budget`` rows of
    each, one list per step, keeping a running top-``min(k, nprobe *
    budget)``; pad to ``k`` with ``inf`` / -1 and map rows to original ids."""
    qn = q.shape[0]
    probe = top_k(_sq_dists(q, centroids), nprobe, largest=False)[1]               # [Q, nprobe]
    starts, ends = offsets[probe], offsets[probe + 1]
    q_norm2 = (q * q).sum(dim=1, keepdim=True)
    slot = torch.arange(budget, device=q.device)
    kk = min(k, nprobe * budget)
    best_d = torch.full((qn, kk), float("inf"), device=q.device)
    best_i = torch.zeros((qn, kk), dtype=torch.int64, device=q.device)
    for j in range(nprobe):
        cand = starts[:, j, None] + slot[None, :]                   # [Q, L]
        valid = cand < ends[:, j, None]
        cand = torch.where(valid, cand, 0)
        ip = torch.bmm(emb[cand], q[:, :, None]).squeeze(2)          # [Q, L]
        dist = torch.where(valid, q_norm2 - 2.0 * ip + norm2[cand], float("inf"))
        all_d = torch.cat([best_d, dist], dim=1)
        all_i = torch.cat([best_i, cand], dim=1)
        pos = top_k(all_d, kk, largest=False)[1]
        best_d, best_i = all_d.gather(1, pos), all_i.gather(1, pos)
    if kk < k:
        best_d = torch.nn.functional.pad(best_d, (0, k - kk), value=float("inf"))
        best_i = torch.nn.functional.pad(best_i, (0, k - kk), value=-1)
    ids = perm[best_i.clamp(min=0)]
    ids = torch.where(torch.isfinite(best_d) & (best_i >= 0), ids, -1)
    return best_d, ids
