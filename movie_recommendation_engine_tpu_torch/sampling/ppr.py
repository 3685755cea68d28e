"""Approximate Personalized PageRank neighborhoods (batched power iteration).

Port of ``movie_recommendation_engine_tpu/sampling/ppr.py``. Each source's
frontier advances by

    ppr_{k+1} = ppr_k + alpha * r_k;   r_{k+1} = (1 - alpha) * r_k @ P

with P the row-normalized weighted adjacency. Where JAX materializes one
[B, E] message per edge and scatters it, the port keeps the frontier as
[N, B] columns and pushes it through the transpose of P (``push_operator``):
each target's incoming edges, sources ascending, are cut into slices of at
most ``SLICE`` edges (``ops.pool.edge_slices``); one ``ops.pool.gather_pool``
call (the gather-pool kernel on the card) sums every slice's weighted
frontier rows, and ``torch.segment_reduce`` adds each target's slices in
order (``ops.pool.slice_sum``). The transient
is O(B * N), and every sum runs in a fixed order, so a build repeats bit for
bit (a library sparse product does not on the card: cuSPARSE's CSR x dense
product gave other bits from run to run on an H100). Dangling nodes absorb
their teleport term and drop the rest, as in JAX.

Ranking goes through ``core.ranking.top_k``, so the lower node id comes
first among equal scores (``jax.lax.top_k``'s order).

Every function also takes a row-sharded ``sampling.sharded_walk.
ShardedDeviceGraph``: each rank pushes along its own rows' out-edges and
one sum over the model axis merges the frontier (equal to float
tolerance; every rank of the group must call).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.ranking import top_k
from ..ops.pool import EdgeSlices, edge_slices, slice_sum
from ..parallel import collectives as coll
from .random_walk import DeviceGraph
from .sharded_walk import ShardedDeviceGraph, sharded_push_operator

# Incoming edges summed by one gather-pool row. A masked slot still loads a
# row, so narrow slices waste less on low in-degree targets: one push on a
# 118,419-node, 1.35M-edge graph took 0.50 / 0.54 / 0.83 ms in the kernel at
# 16 / 32 / 64 (512 columns, NVIDIA H100 80GB HBM3, chip_smoke.py).
SLICE = 16


def push_operator(graph: DeviceGraph, num_nodes: int | None = None) -> EdgeSlices:
    """P^T of the graph on its device: target t's slices hold the edges s -> t
    with weight ``w[s->t] / sum_u w[s->u]``, sources ascending (a sharded
    graph's: the rank's sources only)."""
    n = graph.num_nodes if num_nodes is None else num_nodes
    if isinstance(graph, ShardedDeviceGraph):
        return sharded_push_operator(graph, n, SLICE)
    dev = graph.indptr.device
    deg = graph.indptr[1:] - graph.indptr[:-1]
    src = torch.repeat_interleave(torch.arange(graph.num_nodes, device=dev), deg)
    # Per-row weight sums on the host, each row's edges in order.
    w_np, deg_np = graph.weights.cpu().numpy(), deg.cpu().numpy()
    row_sum = np.zeros(graph.num_nodes, np.float32)
    if w_np.size:
        nz = deg_np > 0
        row_sum[nz] = np.add.reduceat(w_np, graph.indptr[:-1].cpu().numpy()[nz])
    wnorm = graph.weights / torch.from_numpy(row_sum).to(dev).clamp_min(1e-12)[src]
    # Edges are grouped by source, so each target's sources come ascending.
    return edge_slices(src, graph.indices, wnorm, n, SLICE)


def _ppr_columns(push: EdgeSlices, sources: torch.Tensor, alpha: float,
                 num_iterations: int, group=None) -> torch.Tensor:
    """[N, B] PPR mass, one column per source; ``group`` sums the pushes of
    a sharded graph's ranks."""
    n, b, dev = push.num_nodes, sources.shape[0], push.nbrs.device
    r = torch.zeros((n, b), device=dev)
    r[sources.long(), torch.arange(b, device=dev)] = 1.0
    ppr = torch.zeros_like(r)
    for _ in range(num_iterations):
        ppr = ppr + alpha * r
        r = (1.0 - alpha) * coll.all_reduce_(slice_sum(r, push), group)
    return ppr


def ppr_scores(graph: DeviceGraph, sources, num_nodes: int, alpha: float = 0.15,
               num_iterations: int = 10, push: EdgeSlices | None = None) -> torch.Tensor:
    """[B, num_nodes] approximate PPR mass per source, on the graph's device.
    ``push`` is ``push_operator(graph, num_nodes)``, built here if absent."""
    if push is None:
        push = push_operator(graph, num_nodes)
    sources = torch.as_tensor(sources, device=push.nbrs.device)
    return _ppr_columns(push, sources, alpha, num_iterations, _group(graph)).t()


def _group(graph) -> object:
    return graph.group if isinstance(graph, ShardedDeviceGraph) else None


def precompute_top_neighbors(csr, graph: DeviceGraph, nodes, num_neighbors: int = 10,
                             alpha: float = 0.15, num_iterations: int = 10,
                             batch: int = 8) -> dict[int, tuple[list[int], list[float]]]:
    """Top-``num_neighbors`` nodes by PPR score with weights normalized over
    the positive ones, per node of ``nodes`` (the JAX package's dict)."""
    out: dict[int, tuple[list[int], list[float]]] = {}
    nodes = np.asarray(nodes, dtype=np.int32)
    n = csr.num_nodes
    push = push_operator(graph, n)
    for i in range(0, nodes.shape[0], batch):
        chunk = nodes[i:i + batch]
        pad = batch - chunk.shape[0]
        padded = np.pad(chunk, (0, pad), mode="edge") if pad else chunk
        scores = ppr_scores(graph, torch.from_numpy(padded), n, alpha=alpha,
                            num_iterations=num_iterations, push=push)
        top_scores, top_idx = (t[:chunk.shape[0]].cpu().numpy()
                               for t in top_k(scores, min(num_neighbors, n)))
        for row, src in enumerate(chunk):
            s = top_scores[row]
            keep = s > 0
            s, idx = s[keep], top_idx[row][keep]
            tot = s.sum()
            w = (s / tot).tolist() if tot > 0 else []
            out[int(src)] = (idx.tolist(), w)
    return out


def _top_neighbors_chunk(push: EdgeSlices, sources: torch.Tensor, num_neighbors: int,
                         alpha: float, num_iterations: int,
                         restrict_below: int | None,
                         group=None) -> tuple[torch.Tensor, torch.Tensor]:
    num_nodes = push.num_nodes
    scores = _ppr_columns(push, sources, alpha, num_iterations, group).t()
    if restrict_below is not None:
        # Rank only movie-node targets (walk.count_nodes="movies").
        scores[:, restrict_below:] = 0.0
    top, idx = top_k(scores, min(num_neighbors, num_nodes))
    empty = top <= 0.0
    nbrs = torch.where(empty, num_nodes, idx).to(torch.int32)
    w = torch.where(empty, 0.0, top)
    tot = w.sum(dim=1, keepdim=True)
    w = torch.where(tot > 0, w / tot.clamp_min(1e-12), 0.0)
    if num_neighbors > num_nodes:
        pad = num_neighbors - num_nodes
        nbrs = torch.nn.functional.pad(nbrs, (0, pad), value=num_nodes)
        w = torch.nn.functional.pad(w, (0, pad))
    return nbrs, w


def all_node_neighborhood_tables_ppr(graph: DeviceGraph, num_layers: int, num_neighbors: int,
                                     num_nodes: int | None = None,
                                     restrict_below: int | None = None, alpha: float = 0.15,
                                     num_iterations: int = 10, batch: int = 512
                                     ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer ([N, K] int32 ids, [N, K] f32 weights) tables ranked by PPR
    mass (``walk.strategy="ppr"``), for the first ``num_nodes`` rows (ids
    past the graph's last node repeat it). PPR draws no random numbers, so
    every layer shares one table. Empty slots hold the sentinel (the
    graph's node count) with weight 0; the source keeps its teleport mass
    and usually ranks first."""
    n = num_nodes if num_nodes is not None else graph.num_nodes
    push = push_operator(graph)
    ids = torch.arange(-(-n // batch) * batch, device=push.nbrs.device)
    ids = ids.clamp(0, graph.num_nodes - 1)
    nb_chunks, w_chunks = [], []
    for i in range(0, ids.shape[0], batch):
        nb, w = _top_neighbors_chunk(push, ids[i:i + batch], num_neighbors, alpha,
                                     num_iterations, restrict_below, _group(graph))
        nb_chunks.append(nb)
        w_chunks.append(w)
    nbrs = torch.cat(nb_chunks)[:n]
    weights = torch.cat(w_chunks)[:n]
    return [(nbrs, weights) for _ in range(num_layers)]
