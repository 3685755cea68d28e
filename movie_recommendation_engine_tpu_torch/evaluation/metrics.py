"""Batched evaluation: Hit-Rate@k, scaled MRR, recommendations.

Port of ``movie_recommendation_engine_tpu/evaluation/metrics.py``. Ranks come
from a similarity-count compare, so no full sort is needed:

    rank(gt) = 1 + |{j : sim[j] > sim[gt]}|

- HR@k for each k: gt within top-k.
- scaled MRR = mean(1 / (rank / scale)) with scale=100 (reference
  utils/evaluation.py:66-69); the standard MRR is reported too.

JAX jits ``_ranks`` (a scan over whole query chunks) and ``recommend``, one
program per static shape. Given ``graphs`` (a ``core.graphs.ProgramGraphs``)
on ``cuda`` each runs as one CUDA graph per key: ``_ranks`` per (rows, dim,
padded queries, chunk), ``recommend`` per (rows, dim, queries, ``k``,
``exclude_query``); ``graphed=False`` runs them eager.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..core.graphs import ProgramGraphs, on_device, use_graphs
from ..core.ranking import top_k


def _ranks(embeddings: torch.Tensor, query_idx: torch.Tensor,
           gt_idx: torch.Tensor, chunk: int = 1024, graphs: ProgramGraphs | None = None,
           graphed: bool | None = None) -> torch.Tensor:
    """[Q] 1-based rank of each ground-truth item among all items by
    dot-product similarity to the query. The queries are padded to whole
    chunks as JAX's are (padded rows read item 0 and are sliced off; each
    row is ranked on its own)."""
    q = query_idx.shape[0]
    if q == 0:
        return torch.zeros(0, dtype=torch.int64, device=embeddings.device)
    pad = (-q) % chunk
    qi, gi = (torch.cat([x.long(), x.new_zeros(pad, dtype=torch.int64)])
              for x in (query_idx, gt_idx))
    fn = partial(_chunked_ranks, chunk=chunk)
    if use_graphs(graphs, graphed, embeddings.device):
        n, d = embeddings.shape
        out = graphs.run(("ranks", n, d, q + pad, chunk), fn, (embeddings, qi, gi))
    else:
        out = fn(embeddings, qi, gi)
    return out[:q]


def _chunked_ranks(embeddings: torch.Tensor, qi: torch.Tensor, gi: torch.Tensor,
                   chunk: int) -> torch.Tensor:
    out = torch.empty(qi.shape[0], dtype=torch.int64, device=embeddings.device)
    for s in range(0, qi.shape[0], chunk):
        # One chunk's [C, N] products are freed before the next's are made.
        out[s:s + chunk] = _chunk_ranks(embeddings, qi[s:s + chunk], gi[s:s + chunk])
    return out


def _chunk_ranks(embeddings: torch.Tensor, qc: torch.Tensor, gc: torch.Tensor) -> torch.Tensor:
    return _vector_ranks(embeddings, embeddings[qc], gc)


def _vector_ranks(items: torch.Tensor, qe: torch.Tensor, gc: torch.Tensor) -> torch.Tensor:
    sims = qe @ items.T                                           # [C, N]
    gt_sim = (qe * items[gc]).sum(dim=1)
    return 1 + (sims > gt_sim[:, None]).sum(dim=1)


def query_ranks(items: torch.Tensor, queries: torch.Tensor, gt_idx: torch.Tensor,
                chunk: int = 1024, graphs: ProgramGraphs | None = None,
                graphed: bool | None = None) -> torch.Tensor:
    """[Q] 1-based rank of each ground-truth item among all ``items`` [N, D]
    by dot product with its query vector (``queries`` [Q, D], e.g. user
    states), padded to whole chunks and graphed as ``_ranks`` is (key
    ``query_ranks``)."""
    q = queries.shape[0]
    if q == 0:
        return torch.zeros(0, dtype=torch.int64, device=items.device)
    pad = (-q) % chunk
    qv = torch.cat([queries, queries.new_zeros((pad, queries.shape[1]))])
    gi = torch.cat([gt_idx.long(), gt_idx.new_zeros(pad, dtype=torch.int64)])
    fn = partial(_chunked_query_ranks, chunk=chunk)
    if use_graphs(graphs, graphed, items.device):
        n, d = items.shape
        out = graphs.run(("query_ranks", n, d, q + pad, chunk), fn, (items, qv, gi))
    else:
        out = fn(items, qv, gi)
    return out[:q]


def _chunked_query_ranks(items: torch.Tensor, qv: torch.Tensor, gi: torch.Tensor,
                         chunk: int) -> torch.Tensor:
    out = torch.empty(qv.shape[0], dtype=torch.int64, device=items.device)
    for s in range(0, qv.shape[0], chunk):
        out[s:s + chunk] = _vector_ranks(items, qv[s:s + chunk], gi[s:s + chunk])
    return out


def rank_metrics(ranks: np.ndarray, k_values=(10, 50, 100, 500),
                 mrr_scale: float = 100.0) -> dict[str, float]:
    """HR@k and NDCG@k for each k, scaled and standard MRR of 1-based ranks
    (one relevant item per query: NDCG@k is 1 / log2(rank + 1) within k)."""
    ranks = np.asarray(ranks, np.float64)
    out: dict[str, float] = {}
    for k in k_values:
        out[f"hit_rate@{k}"] = float((ranks <= k).mean())
        out[f"ndcg@{k}"] = float(np.where(ranks <= k, 1.0 / np.log2(ranks + 1.0), 0.0).mean())
    out["mrr"] = float((mrr_scale / ranks).mean())
    out["mrr_standard"] = float((1.0 / ranks).mean())
    out["num_pairs"] = int(ranks.shape[0])
    return out


def evaluate_embeddings(embeddings, positive_pairs, k_values=(10, 50, 100, 500),
                        mrr_scale: float = 100.0, chunk: int = 1024,
                        graphs: ProgramGraphs | None = None,
                        graphed: bool | None = None) -> dict[str, float]:
    """HR@k / MRR over [Q, 2] (query_idx, gt_idx) pairs. Pairs whose query
    or gt index is out of range are dropped first. The ranks reach the host
    in one copy."""
    emb = torch.as_tensor(embeddings)
    pairs = np.asarray(positive_pairs)
    n = emb.shape[0]
    ok = ((pairs[:, 0] >= 0) & (pairs[:, 0] < n)
          & (pairs[:, 1] >= 0) & (pairs[:, 1] < n))
    pairs = pairs[ok]
    if pairs.shape[0] == 0:
        out = {f"hit_rate@{k}": 0.0 for k in k_values}
        out.update({"mrr": 0.0, "mrr_standard": 0.0, "num_pairs": 0})
        return out
    q, g = on_device(emb.device, np.ascontiguousarray(pairs[:, :2].T), torch.int64)
    ranks = _ranks(emb, q, g, chunk=min(chunk, 4096), graphs=graphs,
                   graphed=graphed).cpu().numpy().astype(np.float64)
    out: dict[str, float] = {}
    for k in k_values:
        out[f"hit_rate@{k}"] = float((ranks <= k).mean())
    out["mrr"] = float((mrr_scale / ranks).mean())
    out["mrr_standard"] = float((1.0 / ranks).mean())
    out["num_pairs"] = int(ranks.shape[0])
    return out


def recommend(embeddings: torch.Tensor, query_idx: torch.Tensor, k: int = 10,
              exclude_query: bool = True, graphs: ProgramGraphs | None = None,
              graphed: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k by inner product per query: (scores [Q, k], indices [Q, k]),
    the lower index first among equal scores."""
    fn = partial(_recommend, k=k, exclude_query=exclude_query)
    if use_graphs(graphs, graphed, embeddings.device):
        n, d = embeddings.shape
        key = ("recommend", n, d, int(query_idx.shape[0]), k, exclude_query)
        return graphs.run(key, fn, (embeddings, query_idx.long()))
    return fn(embeddings, query_idx)


def _recommend(embeddings: torch.Tensor, query_idx: torch.Tensor, k: int,
               exclude_query: bool) -> tuple[torch.Tensor, torch.Tensor]:
    sims = embeddings[query_idx] @ embeddings.T
    if exclude_query:
        # A scalar fill: no host tensor to copy inside a capture.
        sims.scatter_(1, query_idx.long()[:, None], -torch.inf)
    return top_k(sims, k)
