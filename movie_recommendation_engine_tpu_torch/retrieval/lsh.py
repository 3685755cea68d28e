"""LSH retrieval: random-hyperplane signatures + batched Hamming top-k.

Port of ``movie_recommendation_engine_tpu/retrieval/lsh.py`` (replaces FAISS
``IndexLSH(dim, 256, 16)``):

- ``num_tables`` independent random-hyperplane projections of ``num_bits``
  each; signatures are the sign bits (``proj >= 0``) packed 32 to an int32
  word holding the JAX package's uint32 bit pattern ([N, T, W]).
- Search scores each item by its minimum Hamming distance across tables,
  then takes an optional exact L2 re-rank of a shortlist. Two forms of the
  Hamming score (``hamming_impl``): ``"popcount"`` (default) through
  ``ops.hamming.hamming_topk`` (the CUDA kernel on the card), and
  ``"matmul"``, ±1 bf16 signatures [T, N, B] and one GEMM per table,
  ``ham = (B - q.s) / 2``: integer dot products accumulate exactly in f32,
  so both forms give the same ids and distances.

The hyperplanes are drawn from a ``torch.Generator`` seeded with ``seed``
(not JAX's numbers); ``planes=`` injects given ones.

JAX jits each form as one program per query rows and ``k``
(``_lsh_search_matmul[_rerank]``, ``_hamming_topk``, ``_exact_rerank``); on
``cuda`` each form's search is one CUDA graph per (form, shortlist, query
rows, ``k``), captured at the key's second call (``core/graphs.
SearchGraphs``): the query signatures, the Hamming kernel (popcount form)
or the 16 ±1 GEMMs, the tie-ordered top-k and the rerank.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.graphs import SearchGraphs
from ..core.ranking import top_k
from ..ops.hamming import hamming_topk, smallest_k
from ..ops.hub_pool import _mm_f32


def _pack_bits(signs: torch.Tensor) -> torch.Tensor:
    """[..., B] bool -> [..., B/32] int32 (bit i of word j is sign 32*j + i;
    bit 31 is the sign bit of the int32)."""
    *lead, b = signs.shape
    x = signs.reshape(*lead, b // 32, 32).to(torch.int64)
    shifts = torch.arange(32, device=signs.device)
    words = (x << shifts).sum(dim=-1)                      # [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


class LSHIndex:
    """build(embeddings) / search(queries, k), on ``device``; ``graphed``
    (on by default on ``cuda``) runs the search as CUDA graphs."""

    def __init__(self, dim: int, num_bits: int = 256, num_tables: int = 16,
                 seed: int = 0, rerank: int = 0,
                 planes: torch.Tensor | None = None, device=None,
                 hamming_impl: str | None = None):
        if num_bits % 32:
            raise ValueError("num_bits must be a multiple of 32")
        self.dim = dim
        self.num_bits = num_bits
        self.num_tables = num_tables
        # rerank > 0: re-score that many min-Hamming candidates with exact
        # squared-L2 distances; 0 = plain Hamming ranking (FAISS IndexLSH).
        self.rerank = int(rerank)
        self.device = resolve_device(device)
        if planes is None:
            gen = torch.Generator(device="cpu").manual_seed(seed)
            planes = torch.randn((num_tables, dim, num_bits), generator=gen)
        elif not torch.is_tensor(planes):
            planes = torch.tensor(np.asarray(planes))
        planes = planes.to(device=self.device, dtype=torch.float32)
        if planes.shape != (num_tables, dim, num_bits):
            raise ValueError(f"planes must be {(num_tables, dim, num_bits)}, "
                             f"got {tuple(planes.shape)}")
        self.planes = planes                                    # [T, D, B]
        self._planes_flat = planes.permute(1, 0, 2).reshape(dim, -1)
        # The Hamming form; without an argument, MRE_LSH_IMPL or "popcount".
        if hamming_impl is None:
            hamming_impl = os.environ.get("MRE_LSH_IMPL", "popcount")
        if hamming_impl not in ("popcount", "matmul"):
            raise ValueError(f"unknown hamming_impl {hamming_impl!r}")
        self.hamming_impl = hamming_impl
        self._sigs: torch.Tensor | None = None
        self._sigs_pm: torch.Tensor | None = None   # [T, N, B] ±1 bf16 (matmul form)
        self._emb: torch.Tensor | None = None
        self._sqnorm: torch.Tensor | None = None
        self.graphed = self.device.type == "cuda"
        self.graphs = SearchGraphs(self.device)

    @property
    def ntotal(self) -> int:
        return 0 if self._sigs is None else int(self._sigs.shape[0])

    def _signs(self, x: torch.Tensor) -> torch.Tensor:
        """[N, D] -> [N, T, B] bool ``proj >= 0``, one GEMM per chunk of
        rows (both forms sign queries here, so their bits are the same)."""
        t, b = self.num_tables, self.num_bits
        if x.shape[0] == 0:
            return torch.zeros((0, t, b), dtype=torch.bool, device=x.device)
        return torch.cat([(xc @ self._planes_flat >= 0).reshape(xc.shape[0], t, b)
                          for xc in x.split(4096)])

    def _signatures(self, x: torch.Tensor) -> torch.Tensor:
        """[N, D] -> packed [N, T, W] int32, chunked over rows so the full
        [N, T, B] projection never materializes."""
        t, b = self.num_tables, self.num_bits
        out = [_pack_bits(self._signs(xc)) for xc in x.split(4096)]
        if not out:
            return torch.zeros((0, t, b // 32), dtype=torch.int32, device=x.device)
        return torch.cat(out)

    def build(self, embeddings) -> None:
        self.graphs.drop()
        x = torch.as_tensor(embeddings, dtype=torch.float32, device=self.device)
        self._sigs = self._signatures(x)
        # The ±1 form holds 16x the packed bytes: built only when used.
        self._sigs_pm = _unpack_pm(self._sigs) if self.hamming_impl == "matmul" else None
        self._emb = x
        self._sqnorm = (x * x).sum(dim=1)

    def search(self, queries, k: int = 10):
        """(distances [Q, k], indices [Q, k]), ascending. Without rerank the
        distances are min-table Hamming distances; with rerank they are the
        squared L2 distances of the re-scored shortlist."""
        c = 0 if self.rerank <= 0 else min(max(self.rerank, k), self.ntotal)
        if self.hamming_impl == "matmul" and self._sigs_pm is None:
            self._sigs_pm = _unpack_pm(self._sigs)   # built before the form was switched
        reads = (self._planes_flat, self._emb, self._sqnorm,
                 self._sigs_pm if self.hamming_impl == "matmul" else self._sigs)
        return self.graphs.search((f"lsh_{self.hamming_impl}", k, c),
                                  partial(self._search, k=k, c=c), queries, reads,
                                  self.graphed)

    def _search(self, q: torch.Tensor, k: int, c: int):
        if self.hamming_impl == "matmul":
            dist = (self.num_bits - _best_table_ip(self._signs(q), self._sigs_pm)) * 0.5
            d, i = smallest_k(dist.to(torch.int32), max(c, k))
        else:
            tw = self.num_tables * (self.num_bits // 32)
            qsig = self._signatures(q).reshape(q.shape[0], tw)
            d, i = hamming_topk(qsig, self._sigs.reshape(-1, tw), max(c, k),
                                self.num_tables, self.num_bits // 32)
        if c > 0:
            return _exact_rerank(q, self._emb, self._sqnorm, i, k)
        return d, i


def _exact_rerank(q: torch.Tensor, emb: torch.Tensor, sqnorm: torch.Tensor,
                  cand: torch.Tensor, k: int):
    """Exact re-scoring of a [Q, C] candidate shortlist by squared L2
    distance (the ExactIndex expansion), top-k in ``lax.top_k``'s order."""
    ip = torch.einsum("qd,qcd->qc", q, emb[cand])
    dist = (q * q).sum(dim=1, keepdim=True) + sqnorm[cand] - 2.0 * ip
    d, j = top_k(dist, k, largest=False)
    return d, cand.gather(1, j)


def _unpack_pm(sigs: torch.Tensor, rows: int = 4096) -> torch.Tensor:
    """Packed [N, T, W] int32 -> ±1 bf16 [T, N, W*32] (bit 1 -> +1), in row
    chunks so the [rows, T, W, 32] bit buffer stays small."""
    n, t, w = sigs.shape
    out = torch.empty((t, n, w * 32), dtype=torch.bfloat16, device=sigs.device)
    shifts = torch.arange(32, dtype=torch.int32, device=sigs.device)
    for s in range(0, n, rows):
        bits = (sigs[s:s + rows, :, :, None] >> shifts) & 1        # [r, T, W, 32]
        pm = bits.to(torch.bfloat16) * 2 - 1
        out[:, s:s + rows] = pm.reshape(-1, t, w * 32).permute(1, 0, 2)
    return out


def _best_table_ip(signs: torch.Tensor, sigs_pm: torch.Tensor) -> torch.Tensor:
    """[Q, N] f32 best (max) ±1 inner product across tables of the queries'
    sign bits [Q, T, B] (bit 1 -> +1) and the ±1 signatures [T, N, B]: one
    GEMM per table accumulated in f32, running max."""
    qs = torch.where(signs, 1.0, -1.0).to(sigs_pm.dtype)
    best = None
    for ti in range(sigs_pm.shape[0]):
        ip = _mm_f32(qs[:, ti], sigs_pm[ti].t())
        best = ip if best is None else torch.maximum(best, ip)
    return best
