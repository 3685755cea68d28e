"""Block-sparse importance pooling: the pooling matrix as [bs, cs] tiles.

Port of ``movie_recommendation_engine_tpu/ops/block_sparse.py``. Nodes are
reordered so that co-visited neighbours land in nearby columns, A is tiled
into [bs, cs] blocks, and each row block keeps its ``bmax`` heaviest column
blocks:

    a_blocks [R, bmax, bs, cs]   (R = ceil(N / bs) row blocks)
    col_idx  [R, bmax]           which column block each slot holds

Pooling is then one batched GEMM over contiguous [cs, D] slabs of the
reordered table. Entries outside the kept blocks are dropped (lightest first)
and each row renormalized over what it keeps; the builder reports the dropped
mass so the trainer can fall back to gather.

The order is ``mass_permutation`` (columns by descending pooling mass, the
default ``model.block_pool_order="mass"``). ``cluster_permutation`` (the
feature k-means order) needs the IVF k-means, which is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hub_pool import _as_numpy, scatter_cells

_EPS = 1e-12


class BlockPool(NamedTuple):
    """One layer's block operator (tensors on one device)."""

    a_blocks: torch.Tensor   # [R, bmax, bs, cs] pooling weights (storage dtype)
    col_idx: torch.Tensor    # [R, bmax] int64 column-block ids (0 if unused slot)
    perm: torch.Tensor       # [R*bs] int64 new->old row id (pad rows = N)
    inv: torch.Tensor        # [N] int64 old->new row position


def cluster_permutation(*args, **kwargs) -> np.ndarray:
    """The feature k-means order (``block_pool_order="feature"``): not
    ported yet, it needs the IVF k-means (ROADMAP queue 1, IVF)."""
    raise NotImplementedError(
        "block_pool_order='feature' (cluster_permutation) is not ported to the PyTorch "
        "package yet: it needs the IVF k-means (ROADMAP queue 1)")


def mass_permutation(nbrs, weights, valid_limit: int | None = None) -> np.ndarray:
    """Node order by descending total pooling mass per column (ties: lower
    id first), so the hub columns every row block needs fill the leading
    column blocks."""
    nbrs = _as_numpy(nbrs)
    weights = _as_numpy(weights).astype(np.float32)
    n = nbrs.shape[0]
    limit = n if valid_limit is None else min(valid_limit, n)
    valid = nbrs < limit
    w = np.where(valid, weights, 0.0)
    wsum = w.sum(axis=1, keepdims=True)
    w = np.where(wsum > 0, w / np.maximum(wsum, _EPS), 0.0)
    col_mass = np.bincount(np.clip(nbrs, 0, n - 1).reshape(-1),
                           weights=w.reshape(-1), minlength=n)
    return np.argsort(-col_mass, kind="stable").astype(np.int32)


def build_block_pool(nbrs, weights, perm: np.ndarray, valid_limit: int | None = None,
                     block_size: int = 512, max_blocks: int = 32,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> tuple[BlockPool, dict]:
    """Tile the pooling matrix: the index math in numpy on the host, then
    one scatter (``hub_pool.scatter_cells``) into the [R*bmax*bs, cs]
    layout on ``device`` (``nbrs``' device when it is a tensor, else the
    CPU), reshaped to [R, bmax, bs, cs].

    Returns (BlockPool, stats) where ``dropped_mass`` is the share of the
    pooling weight outside every row block's top ``max_blocks`` column
    blocks (0.0 = exact)."""
    if device is None:
        device = nbrs.device if torch.is_tensor(nbrs) else "cpu"
    nbrs = _as_numpy(nbrs)
    weights = _as_numpy(weights).astype(np.float32)
    perm = _as_numpy(perm)
    n, k = nbrs.shape
    bs = cs = int(block_size)
    r_blocks = -(-max(n, 1) // bs)
    n_pad = r_blocks * bs
    ncb = r_blocks  # square tiling: same padded length on both axes
    bmax = int(min(max_blocks, ncb))

    limit = n if valid_limit is None else min(valid_limit, n)
    pos = np.empty(n, dtype=np.int64)
    pos[perm] = np.arange(n)

    valid = nbrs < limit
    w = np.where(valid, weights, 0.0)
    wsum = w.sum(axis=1, keepdims=True)
    w = np.where(wsum > 0, w / np.maximum(wsum, _EPS), 0.0)

    rows_new = pos[np.arange(n)]
    cols_new = pos[np.clip(nbrs, 0, n - 1)]
    rb = (rows_new // bs)[:, None].repeat(k, axis=1)       # [N, K]
    cb = cols_new // cs                                     # [N, K]

    # Weight mass per (row block, column block); keep each row block's top bmax.
    mass = np.zeros((r_blocks, ncb), np.float32)
    np.add.at(mass, (rb.reshape(-1), cb.reshape(-1)), w.reshape(-1))
    if bmax < ncb:
        top = np.argpartition(-mass, bmax - 1, axis=1)[:, :bmax]
    else:
        top = np.broadcast_to(np.arange(ncb), (r_blocks, ncb)).copy()
    # Slots in ascending column-block order, so the slab gathers ascend.
    col_idx = np.sort(top, axis=1).astype(np.int64)
    slot_map = np.full((r_blocks, ncb), -1, np.int64)
    np.put_along_axis(slot_map, col_idx, np.arange(bmax)[None, :].repeat(r_blocks, axis=0),
                      axis=1)

    slot = slot_map[rb.reshape(-1), cb.reshape(-1)].reshape(n, k)
    kept = (slot >= 0) & (w > 0)

    total_mass = float(w.sum())
    kept_mass = float(w[kept].sum())
    dropped = 1.0 - kept_mass / total_mass if total_mass > 0 else 0.0

    row_kept = np.where(kept, w, 0.0).sum(axis=1, keepdims=True)
    w = np.where(row_kept > 0, w / np.maximum(row_kept, _EPS), 0.0)

    # 2-D coordinates in [R*bmax*bs, cs] (as the JAX package, whose indices
    # must fit int32; here they are int64 either way).
    srow = ((rb[kept] * bmax + slot[kept]) * bs
            + (rows_new[:, None].repeat(k, axis=1)[kept] % bs))
    scol = cols_new[kept] % cs
    a2 = scatter_cells((r_blocks * bmax * bs, cs), torch.from_numpy(srow),
                       torch.from_numpy(scol),
                       torch.from_numpy(w[kept].astype(np.float32)).to(device), dtype)
    a_blocks = a2.reshape(r_blocks, bmax, bs, cs)

    perm_pad = np.full(n_pad, n, np.int64)
    perm_pad[:n] = perm
    bp = BlockPool(a_blocks=a_blocks, col_idx=torch.from_numpy(col_idx).to(device),
                   perm=torch.from_numpy(perm_pad).to(device),
                   inv=torch.from_numpy(pos).to(device))
    stats = {"dropped_mass": dropped, "row_blocks": r_blocks, "col_blocks_kept": bmax,
             "col_blocks_total": ncb, "a_bytes": a_blocks.numel() * a_blocks.element_size()}
    return bp, stats


def block_pool_matmul(bp: BlockPool, h: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``A @ h`` [N, D] in ``dtype`` through the tiling: permute the rows,
    gather each row block's [cs, D] slabs, one batched contraction over the
    kept blocks and their columns (f32 accumulation, one rounding), and
    undo the permutation. Gathers are advanced indexing, whose gradient is
    the deterministic sort-based ``index_put_``."""
    n, d = h.shape
    r_blocks, bmax, bs, cs = bp.a_blocks.shape
    n_pad = r_blocks * bs
    # Pad rows read row n-1, but every A entry addressing them is zero.
    h_p = h.to(dtype)[bp.perm.clamp(max=n - 1)]
    gathered = h_p.reshape(r_blocks, cs, d)[bp.col_idx]          # [R, bmax, cs, D]
    out_p = torch.einsum("rbic,rbcd->rid", bp.a_blocks.to(dtype), gathered)
    return out_p.reshape(n_pad, d)[bp.inv].to(dtype)
