"""Row-sharded CSR random walks and PPR pushes.

Port of ``movie_recommendation_engine_tpu/sampling/sharded_walk.py``. The
O(E) CSR that hard-negative walks and table refreshes read is split by row
range over the model axis: rank ``s`` of ``S`` holds rows
``[s*C, (s+1)*C)`` (``C = ceil(N / S)``) as a local ``DeviceGraph`` —
indptr rebased to its own edges, its slice of indices / cumprob / weights.

- Walker state is replicated: every rank advances the whole walker batch.
  Per hop each rank answers, by the same lower-bound search over its local
  cumprob slice, the walkers whose current node it owns, and 0 for the
  rest; one sum over the group (``[B*W]`` int32, ``next + 1`` or 0) merges
  the answers. The search reads the same cumprob values with the same
  uniforms, so the walk is bit-identical to ``random_walk.random_walks``.
- A PPR push runs each rank's own out-edges (sources ascending, 16-edge
  slices through the gather-pool kernel, as ``sampling/ppr.py``); one sum
  over the group merges the [N, B] frontier, equal to float tolerance.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..graph.csr import CSRGraph
from ..ops.pool import EdgeSlices, edge_slices
from ..parallel import collectives as coll
from .random_walk import DeviceGraph, _weighted_next_hop, random_walks


class ShardedDeviceGraph(NamedTuple):
    """One rank's row range of a CSR: rows ``[start, start + rows)`` of
    ``total`` as a local ``DeviceGraph`` (rows past the graph's end have
    degree 0), and the model axis's ``group``."""

    local: DeviceGraph
    start: int
    total: int
    group: Any

    @property
    def rows(self) -> int:
        return self.local.num_nodes

    @property
    def indptr(self) -> torch.Tensor:
        return self.local.indptr

    @property
    def num_nodes(self) -> int:
        return self.total

    @property
    def sentinel(self) -> int:
        return self.total

    def next_hop(self, cur: torch.Tensor, u: torch.Tensor,
                 n_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``random_walk._weighted_next_hop`` over the whole graph: the
        rank's answers for the walkers it owns, summed over the group."""
        cur = cur.long()
        rel = cur - self.start
        owned = (rel >= 0) & (rel < self.rows) & (cur < self.total)
        if self.local.indices.numel():
            nxt, has = _weighted_next_hop(self.local, torch.where(owned, rel, self.rows),
                                          u, n_iters)
            answer = torch.where(owned & has, nxt + 1, 0).to(torch.int32)
        else:
            answer = torch.zeros(cur.shape, dtype=torch.int32, device=cur.device)
        coll.all_reduce_(answer, self.group)
        return answer.long() - 1, answer > 0


def sharded_device_graph(csr: CSRGraph, group, device) -> ShardedDeviceGraph:
    """The rank's row range of a host CSR on ``device`` (the rank holds
    only its slice of the edges)."""
    size, s = coll.size(group), coll.rank(group)
    indptr = np.asarray(csr.indptr, np.int64)
    n = indptr.shape[0] - 1
    c = max(1, -(-n // size))
    r0, r1 = min(s * c, n), min((s + 1) * c, n)
    e0, e1 = int(indptr[r0]), int(indptr[r1])
    local_ptr = np.full(c + 1, e1 - e0, np.int64)
    local_ptr[:r1 - r0 + 1] = indptr[r0:r1 + 1] - e0
    local = DeviceGraph(
        indptr=torch.as_tensor(local_ptr, device=device),
        indices=torch.as_tensor(np.asarray(csr.indices[e0:e1], np.int64), device=device),
        cumprob=torch.as_tensor(np.asarray(csr.cumprob[e0:e1], np.float32), device=device),
        weights=torch.as_tensor(np.asarray(csr.weights[e0:e1], np.float32), device=device))
    return ShardedDeviceGraph(local, s * c, n, group)


def sharded_random_walks(graph: ShardedDeviceGraph, starts: torch.Tensor, num_walks: int,
                         walk_length: int, n_iters: int,
                         generator: torch.Generator | None = None,
                         uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """``random_walk.random_walks`` on a sharded graph: the same [B, num_walks
    * walk_length] buffer, bit for bit, for the same uniforms."""
    if not isinstance(graph, ShardedDeviceGraph):
        raise TypeError("sharded_random_walks takes a ShardedDeviceGraph")
    return random_walks(graph, starts, num_walks, walk_length, n_iters,
                        generator=generator, uniforms=uniforms)


def sharded_push_operator(graph: ShardedDeviceGraph, num_nodes: int,
                          width: int) -> EdgeSlices:
    """P^T restricted to the rank's source rows: each target's slices of at
    most ``width`` edges from the rank's sources, ascending, weighted
    ``w[s->t] / sum_u w[s->u]`` (rows never split across ranks, so the row
    sums are whole)."""
    local, dev = graph.local, graph.indptr.device
    deg = local.indptr[1:] - local.indptr[:-1]
    src = torch.repeat_interleave(torch.arange(local.num_nodes, device=dev), deg)
    w_np, deg_np = local.weights.cpu().numpy(), deg.cpu().numpy()
    row_sum = np.zeros(local.num_nodes, np.float32)
    nz = deg_np > 0
    if w_np.size:
        row_sum[nz] = np.add.reduceat(w_np, local.indptr[:-1].cpu().numpy()[nz])
    wnorm = local.weights / torch.from_numpy(row_sum).to(dev).clamp_min(1e-12)[src]
    return edge_slices(src + graph.start, local.indices, wnorm, num_nodes, width)


def sharded_ppr_scores(graph: ShardedDeviceGraph, sources, num_nodes: int,
                       alpha: float = 0.15, num_iterations: int = 10) -> torch.Tensor:
    """``ppr.ppr_scores`` on a sharded graph: [B, num_nodes] on every rank of
    the group."""
    from .ppr import ppr_scores

    if not isinstance(graph, ShardedDeviceGraph):
        raise TypeError("sharded_ppr_scores takes a ShardedDeviceGraph")
    return ppr_scores(graph, sources, num_nodes, alpha=alpha, num_iterations=num_iterations)
