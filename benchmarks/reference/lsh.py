"""The plain reference of the LSH serving cell: random-hyperplane
signatures, min-table Hamming distances, the shortlist in the port's tie
order, and an exact rerank in float64, for the comparison that decides
``correct``. Nothing of the port: float64 PyTorch over the embeddings the
server searched and the hyperplanes it was given (``planes=``).

The shortlist holds the ``c`` items of least Hamming distance, the lower
index first among equal distances; ``c`` is the larger of the index's
``lsh_rerank`` and the rows the server asks of its index (its ``max_k``
plus its exclusion headroom). The rerank orders the shortlist by squared
L2 distance, the lower index first among ties; the query's excluded ids
are dropped and the first ``k`` kept, as the server does. A sign bit is
``projection >= 0``; a projection within float32's rounding of 0 may read
the other way in the program, which moves an item by one in one table's
distance, so a rare answer may differ at the shortlist's edge: the cell
judges the share of answers that differ. Each answer also gets ``sure``,
the k-th distance it must reach however such bits read: a projection
within ``SIGN_TOL`` of the sum of its terms' magnitudes may read either
sign (float32's error on 128 terms stays under 4e-7 of that sum, measured
on 20M projections), so each item's distance lies within the count of
such bits in the query's and its signatures of a table; an item is surely
shortlisted if fewer than ``c`` items can rank ahead of it at their least
distances, and ``sure`` is the k-th nearest of those, excluded ids left
out. With no such bit it is the reference's own k-th distance.
"""

from __future__ import annotations

import torch

SIGN_TOL = 2.0 ** -18


def planes(seed: int, dim: int, num_bits: int, num_tables: int) -> torch.Tensor:
    """[T, D, B] float32 N(0, 1) hyperplanes drawn on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((num_tables, dim, num_bits), generator=g)


def _signs(x: torch.Tensor, planes_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(±1 signs [M, B] of ``x @ planes_t``, ``projection >= 0``; [M] the
    count of bits whose projection lies within ``SIGN_TOL`` of its terms'
    magnitudes), float64."""
    proj = x @ planes_t
    unsure = proj.abs() <= SIGN_TOL * (x.abs() @ planes_t.abs())
    return torch.where(proj >= 0, 1.0, -1.0), unsure.sum(1).double()


@torch.no_grad()
def answers(emb: torch.Tensor, planes_: torch.Tensor, queries: torch.Tensor, excludes: list,
            k: int, c: int, block: int = 64) -> tuple[list, list, list]:
    """(ids, scores, sure) of each query: the float64 rerank of its Hamming
    shortlist of ``c`` items, excluded ids dropped, the first ``k`` kept;
    scores are minus the squared L2 distances; ``sure`` the squared
    distance the k-th id must reach (module docstring; infinite where
    fewer than ``k`` items are surely shortlisted)."""
    e = emb.double()
    p = planes_.to(e.device).double()                       # [T, D, B]
    n, bits = e.shape[0], p.shape[2]
    item = [_signs(e, p[t]) for t in range(p.shape[0])]     # ([N, B] ±1, [N] unsure bits)
    sq = (e * e).sum(1)
    order = torch.arange(n, device=e.device, dtype=torch.float64)
    out_ids, out_scores, out_sure = [], [], []
    for s in range(0, queries.shape[0], block):
        q = queries[s:s + block].to(e.device).double()
        ham = lo = hi = None
        for t, (item_pm, item_unsure) in enumerate(item):
            q_pm, q_unsure = _signs(q, p[t])
            d = (bits - q_pm @ item_pm.T) / 2
            u = q_unsure[:, None] + item_unsure[None, :]
            ham = d if ham is None else torch.minimum(ham, d)
            lo = d - u if lo is None else torch.minimum(lo, d - u)
            hi = d + u if hi is None else torch.minimum(hi, d + u)
        short = torch.topk(ham * n + order, c, dim=1, largest=False).indices   # [b, c]
        # Items that at most c - 1 others can pass, each at its least distance.
        ahead = torch.searchsorted(torch.sort(lo * n + order, dim=1).values,
                                   hi * n + order)
        inside = torch.where(ahead < c, (q * q).sum(1, keepdim=True) + sq - 2 * q @ e.T,
                             float("inf"))                                    # [b, n]
        short = torch.sort(short, dim=1).values           # index order, for the ties below
        dist = (q * q).sum(1, keepdim=True) + sq[short] - 2 * torch.einsum(
            "bd,bcd->bc", q, e[short])
        best = torch.sort(dist, dim=1, stable=True).indices
        dist, short = dist.gather(1, best), short.gather(1, best)
        for i in range(q.shape[0]):
            drop = set(int(x) for x in excludes[s + i])
            keep = [j for j, idx in enumerate(short[i].tolist()) if idx not in drop][:k]
            out_ids.append(short[i, keep].tolist())
            out_scores.append((-dist[i, keep]).tolist())
            row = inside[i].clone()
            row[torch.as_tensor(sorted(drop), dtype=torch.long, device=e.device)] = float("inf")
            out_sure.append(float(torch.topk(row, k, largest=False).values[-1]) if k else 0.0)
    return out_ids, out_scores, out_sure
