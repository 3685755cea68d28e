"""Batched evaluation: Hit-Rate@k, scaled MRR, recommendations.

Port of ``movie_recommendation_engine_tpu/evaluation/metrics.py``. Ranks come
from a similarity-count compare, so no full sort is needed:

    rank(gt) = 1 + |{j : sim[j] > sim[gt]}|

- HR@k for each k: gt within top-k.
- scaled MRR = mean(1 / (rank / scale)) with scale=100 (reference
  utils/evaluation.py:66-69); the standard MRR is reported too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ranking import top_k


def _ranks(embeddings: torch.Tensor, query_idx: torch.Tensor,
           gt_idx: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """[Q] 1-based rank of each ground-truth item among all items by
    dot-product similarity to the query, chunked over queries."""
    out = []
    for s in range(0, query_idx.shape[0], chunk):
        qe = embeddings[query_idx[s:s + chunk]]                  # [C, D]
        sims = qe @ embeddings.T                                  # [C, N]
        gt_sim = (qe * embeddings[gt_idx[s:s + chunk]]).sum(dim=1)
        out.append(1 + (sims > gt_sim[:, None]).sum(dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=embeddings.device)
    return torch.cat(out)


def evaluate_embeddings(embeddings, positive_pairs, k_values=(10, 50, 100, 500),
                        mrr_scale: float = 100.0, chunk: int = 1024) -> dict[str, float]:
    """HR@k / MRR over [Q, 2] (query_idx, gt_idx) pairs. Pairs whose query
    or gt index is out of range are dropped first."""
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
    q = torch.as_tensor(pairs[:, 0], dtype=torch.int64, device=emb.device)
    g = torch.as_tensor(pairs[:, 1], dtype=torch.int64, device=emb.device)
    ranks = _ranks(emb, q, g, chunk=min(chunk, 4096)).cpu().numpy().astype(np.float64)
    out: dict[str, float] = {}
    for k in k_values:
        out[f"hit_rate@{k}"] = float((ranks <= k).mean())
    out["mrr"] = float((mrr_scale / ranks).mean())
    out["mrr_standard"] = float((1.0 / ranks).mean())
    out["num_pairs"] = int(ranks.shape[0])
    return out


def recommend(embeddings: torch.Tensor, query_idx: torch.Tensor, k: int = 10,
              exclude_query: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k by inner product per query: (scores [Q, k], indices [Q, k]),
    the lower index first among equal scores."""
    sims = embeddings[query_idx] @ embeddings.T
    if exclude_query:
        rows = torch.arange(query_idx.shape[0], device=sims.device)
        sims[rows, query_idx] = -torch.inf
    return top_k(sims, k)
