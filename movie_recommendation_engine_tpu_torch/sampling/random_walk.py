"""Batched random walks + visit-count importance neighborhoods on the device.

Port of ``movie_recommendation_engine_tpu/sampling/random_walk.py``. Every
walker of a batch advances in lockstep: a weighted next-hop draw is a binary
search of a uniform sample into the row's cumulative transition
probabilities. Visit-count neighborhoods are sort + run-length counts + a
top-k whose tie order matches ``jax.lax.top_k`` (the lower position first),
so that the same visits give the same tables. Missing slots hold the
sentinel id (== num_nodes) and weight 0.

Uniforms come from a ``torch.Generator``; ``random_walks`` also takes them
explicitly ([walk_length, B * num_walks]) so that tests can feed JAX's
stream.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..graph.csr import CSRGraph


class DeviceGraph(NamedTuple):
    """CSR adjacency as device tensors (int64 offsets and ids, so they index
    directly). ``sentinel == num_nodes`` marks "no node" downstream."""

    indptr: torch.Tensor    # [N+1] int64
    indices: torch.Tensor   # [E] int64
    cumprob: torch.Tensor   # [E] f32, per-row cumulative probabilities
    weights: torch.Tensor   # [E] f32 raw edge weights

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def sentinel(self) -> int:
        return self.num_nodes

    def next_hop(self, cur: torch.Tensor, u: torch.Tensor,
                 n_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
        return _weighted_next_hop(self, cur, u, n_iters)


def device_graph(csr: CSRGraph, device) -> DeviceGraph:
    return DeviceGraph(
        indptr=torch.as_tensor(csr.indptr, dtype=torch.int64, device=device),
        indices=torch.as_tensor(csr.indices, dtype=torch.int64, device=device),
        cumprob=torch.as_tensor(csr.cumprob, dtype=torch.float32, device=device),
        weights=torch.as_tensor(csr.weights, dtype=torch.float32, device=device),
    )


def search_iters(csr_or_max_degree) -> int:
    """Binary-search depth: ceil(log2(max_degree + 1))."""
    md = (csr_or_max_degree if isinstance(csr_or_max_degree, int)
          else csr_or_max_degree.max_degree)
    return max(1, math.ceil(math.log2(max(md, 1) + 1)))


def _weighted_next_hop(graph: DeviceGraph, cur: torch.Tensor, u: torch.Tensor,
                       n_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One weighted categorical draw per walker over its CSR row: the first
    j in [0, deg) with ``cumprob[start + j] >= u``. Returns (next_node,
    has_neighbors); a walker at the sentinel has no neighbors."""
    n = graph.num_nodes
    last_edge = graph.cumprob.shape[0] - 1
    cur = cur.long()
    cur_c = cur.clamp(max=n - 1)
    start = graph.indptr[cur_c]
    deg = graph.indptr[cur_c + 1] - start
    deg = torch.where(cur >= n, 0, deg)
    lo = torch.zeros_like(start)
    hi = deg
    for _ in range(n_iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        c = graph.cumprob[(start + mid).clamp(0, last_edge)]
        go_right = active & (c < u)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    pick = start + torch.minimum(lo, (deg - 1).clamp(min=0))
    return graph.indices[pick.clamp(0, last_edge)], deg > 0


def random_walks(graph: DeviceGraph, starts: torch.Tensor, num_walks: int,
                 walk_length: int, n_iters: int,
                 generator: torch.Generator | None = None,
                 uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """All visited nodes of ``num_walks`` weighted walks of ``walk_length``
    steps from each start: [B, num_walks * walk_length] int32, the sentinel
    at halted positions. Start nodes themselves are not recorded.
    ``uniforms`` ([walk_length, B * num_walks] f32 in [0, 1)) replaces the
    draws from ``generator``. ``graph`` may also be a row-sharded
    ``sampling.sharded_walk.ShardedDeviceGraph``, whose hops are bit-identical
    (every rank of its group must call)."""
    b, w = starts.shape[0], num_walks
    device = graph.indptr.device
    if uniforms is None:
        uniforms = torch.rand((walk_length, b * w), generator=generator,
                              device=device)
    cur = starts.to(device=device, dtype=torch.int64).repeat_interleave(w)
    alive = torch.ones(b * w, dtype=torch.bool, device=device)
    steps = []
    for step in range(walk_length):
        nxt, has_nbrs = graph.next_hop(cur, uniforms[step], n_iters)
        record = alive & has_nbrs
        steps.append(torch.where(record, nxt, graph.sentinel))
        cur = torch.where(record, nxt, cur)
        alive = record
    visited = torch.stack(steps)                       # [L, B*W]
    return visited.t().reshape(b, w * walk_length).to(torch.int32)


def _run_length_counts(visited_sorted: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Per-row counts at run starts of an ascending-sorted id buffer; zero
    elsewhere and at sentinel entries. [B, M] -> [B, M] int64."""
    b, m = visited_sorted.shape
    idx = torch.arange(m, device=visited_sorted.device).expand(b, m)
    is_start = torch.ones_like(visited_sorted, dtype=torch.bool)
    is_start[:, 1:] = visited_sorted[:, 1:] != visited_sorted[:, :-1]
    r = torch.where(is_start, idx, m)
    # Suffix-min of r: index of the next run start at or after i.
    suffix_min = torch.cummin(r.flip(1), dim=1).values.flip(1)
    next_start = torch.cat([suffix_min[:, 1:], torch.full_like(r[:, :1], m)], dim=1)
    return torch.where(is_start & (visited_sorted < sentinel), next_start - idx, 0)


def importance_neighborhoods(visited: torch.Tensor, num_neighbors: int,
                             sentinel: int,
                             restrict_below: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``num_neighbors`` visited nodes by visit count, weights normalized
    over the selected set: (neighbors [B, K] int32, weights [B, K] f32).
    ``restrict_below`` counts only ids below it (movie nodes of the
    bipartite graph)."""
    v = visited.long()
    if restrict_below is not None:
        v = torch.where(v < restrict_below, v, sentinel)
    v = torch.sort(v, dim=1).values
    counts = _run_length_counts(v, sentinel)
    m = v.shape[1]
    k = min(num_neighbors, m)
    # Unique key count * M + (M - 1 - position): the largest keys are the
    # largest counts, the lower position first among equal counts.
    rev_pos = (m - 1) - torch.arange(m, device=v.device)
    top = torch.topk(counts * m + rev_pos, k, dim=1, sorted=True).values
    top_counts = top // m
    pos = (m - 1) - top % m
    nbrs = torch.where(top_counts > 0, v.gather(1, pos), sentinel)
    total = top_counts.sum(dim=1, keepdim=True)
    weights = torch.where(total > 0, top_counts.float() / total.float(), 0.0)
    if k < num_neighbors:
        pad = num_neighbors - k
        nbrs = torch.nn.functional.pad(nbrs, (0, pad), value=sentinel)
        weights = torch.nn.functional.pad(weights, (0, pad))
    return nbrs.to(torch.int32), weights


def all_node_neighborhood_tables(graph: DeviceGraph, num_layers: int,
                                 num_walks: int, walk_length: int,
                                 num_neighbors: int, n_iters: int,
                                 generator: torch.Generator | None = None,
                                 batch: int = 16384,
                                 num_nodes: int | None = None,
                                 restrict_below: int | None = None
                                 ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """One independent [N, K] (ids, weights) table per layer for every node,
    chunked over ``batch`` start nodes."""
    n = num_nodes if num_nodes is not None else graph.num_nodes
    ids = torch.arange(n, device=graph.indptr.device).clamp(max=graph.num_nodes - 1)
    nbrs = [[] for _ in range(num_layers)]
    wts = [[] for _ in range(num_layers)]
    for s in range(0, n, batch):
        chunk = ids[s:s + batch]
        for layer in range(num_layers):
            visited = random_walks(graph, chunk, num_walks, walk_length, n_iters,
                                   generator=generator)
            nb, w = importance_neighborhoods(visited, num_neighbors,
                                             graph.sentinel, restrict_below)
            nbrs[layer].append(nb)
            wts[layer].append(w)
    return [(torch.cat(nbrs[i]), torch.cat(wts[i])) for i in range(num_layers)]
