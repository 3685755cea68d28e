"""Exact brute-force retrieval: one matmul + top-k.

Port of ``movie_recommendation_engine_tpu/retrieval/exact.py`` (replaces
FAISS ``IndexFlatL2``). Squared-L2 distances come from inner products:

    ||q - x||^2 = ||q||^2 + ||x||^2 - 2 q.x

JAX jits ``_l2_topk`` per query rows and ``k``; on ``cuda`` the search is
one CUDA graph per (query rows, ``k``), captured at the key's second call
(``core/graphs.SearchGraphs``): the GEMM and the keyed top-k read the
queries from a static [Q, D] buffer and write static [Q, k] outputs.
"""

from __future__ import annotations

from functools import partial

import torch

from ..core.device import resolve_device
from ..core.graphs import SearchGraphs
from ..core.ranking import top_k


class ExactIndex:
    """build(embeddings) then search(queries, k) -> (distances, indices),
    on ``device`` (``cuda`` unless ``"cpu"`` is asked for). ``graphed``
    (on by default on ``cuda``) runs the search as CUDA graphs."""

    def __init__(self, dim: int, device=None):
        self.dim = dim
        self.device = resolve_device(device)
        self._emb: torch.Tensor | None = None
        self._sqnorm: torch.Tensor | None = None
        self.graphed = self.device.type == "cuda"
        self.graphs = SearchGraphs(self.device)

    @property
    def ntotal(self) -> int:
        return 0 if self._emb is None else int(self._emb.shape[0])

    def build(self, embeddings) -> None:
        self.graphs.drop()
        self._emb = torch.as_tensor(embeddings, dtype=torch.float32, device=self.device)
        self._sqnorm = (self._emb * self._emb).sum(dim=1)

    def search(self, queries, k: int = 10):
        fn = partial(_l2_topk, emb=self._emb, sqnorm=self._sqnorm, k=k)
        return self.graphs.search(("exact", k), fn, queries, (self._emb, self._sqnorm),
                                  self.graphed)


def _l2_topk(q: torch.Tensor, emb: torch.Tensor, sqnorm: torch.Tensor, k: int):
    ip = q @ emb.T
    dist = (q * q).sum(dim=1, keepdim=True) + sqnorm[None, :] - 2.0 * ip
    return top_k(dist, k, largest=False)


def similarity_topk(q: torch.Tensor, emb: torch.Tensor, k: int):
    """Inner-product variant (the same ranking for unit-norm embeddings)."""
    return top_k(q @ emb.T, k)
