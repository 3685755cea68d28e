"""CSR adjacency — the device-resident graph representation.

The reference keeps the graph as a ``[2, E]`` edge_index plus a Python
adjacency list rebuilt with an O(E) interpreter loop
(``utils/random_walk.py:33-50``, ``data/graph_builder.py:118-145``). Here the
graph is packed once, host-side and fully vectorized, into CSR arrays that live
in HBM and feed the batched walk kernel:

- ``indptr``  [N+1] int32 — row offsets
- ``indices`` [E]  int32  — neighbor ids, grouped by source row
- ``weights`` [E]  float32 — edge weights (ratings / co-occurrence counts)
- ``cumprob`` [E]  float32 — per-row cumulative transition probabilities in
  (0, 1]; the walk kernel binary-searches these for weighted next-hop draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray   # [N+1] int32
    indices: np.ndarray  # [E] int32
    weights: np.ndarray  # [E] float32
    cumprob: np.ndarray  # [E] float32, cumulative within each row
    num_nodes: int

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.num_edges else 0

    def neighbors(self, node: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[node], self.indptr[node + 1]
        return self.indices[s:e], self.weights[s:e]


def csr_from_edge_index(
    edge_index: np.ndarray,
    edge_weights: np.ndarray | None = None,
    num_nodes: int | None = None,
) -> CSRGraph:
    """Pack a [2, E] COO edge list into CSR. Vectorized (argsort + cumsum)
    replacement for the reference's per-edge Python loop
    (utils/random_walk.py:42-50)."""
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    if num_nodes is None:
        num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    if edge_weights is None:
        w = np.ones(src.shape[0], dtype=np.float32)
    else:
        w = np.asarray(edge_weights, dtype=np.float32)

    order = np.argsort(src, kind="stable")
    src_s, dst_s, w_s = src[order], dst[order], w[order]

    counts = np.bincount(src_s, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])

    cumprob = _row_cumprob(indptr, w_s)
    return CSRGraph(
        indptr=indptr.astype(np.int32),
        indices=dst_s.astype(np.int32),
        weights=w_s,
        cumprob=cumprob,
        num_nodes=num_nodes,
    )


def _row_cumprob(indptr: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Per-row cumulative probabilities: within each CSR row, cumsum(w)/sum(w).

    Vectorized over all rows at once: take a global cumsum, subtract the value
    at each row start, divide by the row total.
    """
    e = weights.shape[0]
    if e == 0:
        return weights.astype(np.float32)
    csum = np.cumsum(weights, dtype=np.float64)
    row_of_edge = np.repeat(
        np.arange(indptr.shape[0] - 1), np.diff(indptr)
    )
    row_start_csum = np.where(indptr[:-1] > 0, csum[np.maximum(indptr[:-1] - 1, 0)], 0.0)
    row_start_csum[indptr[:-1] == 0] = 0.0
    row_base = row_start_csum[row_of_edge]
    row_end = csum[np.maximum(indptr[1:] - 1, 0)]
    row_total = row_end - row_start_csum
    row_total_e = row_total[row_of_edge]
    with np.errstate(divide="ignore", invalid="ignore"):
        cp = (csum - row_base) / row_total_e
    cp = np.nan_to_num(cp, nan=1.0, posinf=1.0)
    # Guarantee the last entry of each nonempty row is exactly 1.0 so a
    # uniform draw in [0,1) always lands inside the row.
    ends = indptr[1:][np.diff(indptr) > 0] - 1
    cp[ends] = 1.0
    return cp.astype(np.float32)
