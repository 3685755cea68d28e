"""Hub-factorized importance pooling: a dense head plus a sparse residual.

Port of ``movie_recommendation_engine_tpu/ops/hub_pool.py``, the pooling form
above the dense rungs' row limit. Pooling is ``out = A @ h`` with A
row-stochastic and K (~50) nonzeros a row. Walk tables concentrate their mass
on popular columns, so A is factored as ``A_head + A_res``:

    a_head [N, H]  the top-H mass columns as a dense slab: one GEMM
                   ``a_head @ h[head_ids]``;
    res    [N, R]  each row's R heaviest entries outside the head, in the
                   walk tables' id/weight format: one gather-pool.

Rows are renormalized over what they keep (head + residual); the builders
report ``dropped_mass``, the weight beyond both parts, so the trainer can
fall back to another rung.

Numerics follow the JAX package: the head product is accumulated in f32, the
residual pooled in f32, and their sum rounded once to the compute dtype. The
slab is storage only: a float8 slab is converted to the compute dtype in row
chunks (``_CHUNK_BYTES``), so no full-size copy is made. With
``gather_impl="pallas"`` the residual runs through ``ops.pool.gather_pool``,
the CUDA kernel on a CUDA tensor. Selections break ties toward the lower id,
as JAX's stable argsort and ``lax.top_k`` do, and every sum the builders make
is deterministic (sort-based), so a refresh on the same tables gives the same
operator.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .pool import SegmentLayout, gather_pool

_EPS = 1e-12
# Bytes of the converted slab rows one GEMM of the head product takes when
# the slab's dtype is not the compute dtype (a float8 slab, or f32 compute).
_CHUNK_BYTES = 1 << 28
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def auto_head(n: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Head width used when ``head <= 0``: N/8, at least 4096, capped at
    32 KB of slab a row (16384 columns in bf16, 32768 in float8)."""
    cap = 32768 // max(1, dtype.itemsize)
    return min(max(4096, n // 8), cap)


def resolve_pool_matrix_dtype(choice: str, n_rows: int, rung: str,
                              head_cfg: int = 0) -> torch.dtype:
    """``model.pool_matrix_dtype`` as a torch dtype. ``"auto"`` is float8
    exactly where the bf16 byte cap of ``auto_head`` binds on the hub rung
    with the head not pinned by config (above 131,072 rows), else bf16."""
    if choice == "auto":
        if (rung == "hub" and head_cfg <= 0
                and auto_head(n_rows, torch.float8_e4m3fn)
                > auto_head(n_rows, torch.bfloat16)):
            return torch.float8_e4m3fn
        return torch.bfloat16
    return {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}[choice]


class HubPool(NamedTuple):
    """One layer's hub operator (tensors on one device)."""

    a_head: torch.Tensor    # [N, H] head pooling weights (storage dtype)
    head_ids: torch.Tensor  # [H] int64 table row of each head column
    res_nbrs: torch.Tensor  # [N, R] int32 residual neighbour ids (0 = padding)
    res_w: torch.Tensor     # [N, R] f32 residual weights (0 = padding)


def take_rows(a: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``a[rows]`` for any dtype: one-byte floats are gathered as bytes."""
    if a.element_size() == 1 and a.is_floating_point():
        return a.view(torch.uint8)[rows].view(a.dtype)
    return a[rows]


def scatter_cells(shape: tuple[int, int], rows: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A zero [rows, cols] matrix of ``dtype`` with each ``vals[i]`` added at
    ``(rows[i], cols[i])``: entries of one cell are summed in f32 first
    (sort-based, so deterministic), then each cell is written once, rounded
    once. Where a row's ids are distinct this equals JAX's scatter-add into
    ``dtype``, which then writes each cell once too; where a cell gets two
    entries, JAX rounds each before adding and may land one step away. The
    matrix is written through its integer view, so float8 needs no
    arithmetic of its own."""
    dev = vals.device
    key = rows.to(device=dev, dtype=torch.int64) * shape[1] + cols.to(device=dev,
                                                                        dtype=torch.int64)
    uniq, inv = torch.unique(key, return_inverse=True)
    summed = torch.zeros(uniq.shape, dtype=torch.float32, device=dev)
    summed.index_put_((inv,), vals.float(), accumulate=True)
    bits = _BITS[dtype.itemsize]
    out = torch.zeros(shape, dtype=bits, device=dev)
    out.index_put_((uniq // shape[1], uniq % shape[1]), summed.to(dtype).view(bits))
    return out.view(dtype)


def _as_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def build_hub_pool(nbrs, weights, valid_limit: int | None = None, head: int = 4096,
                   residual: int = 8, dtype: torch.dtype = torch.bfloat16,
                   device=None, rows: tuple[int, int] | None = None) -> tuple[HubPool, dict]:
    """Factor the pooling matrix: the index math in numpy on the host, then
    one scatter into the [N, H] slab on ``device`` (``nbrs``' device when it
    is a tensor, else the CPU).

    ``rows = (r0, r1)`` builds the operator's rows r0..r1-1 only (a rank's
    share of a row-sharded operator); the head and the stats are the whole
    table's, so the rows equal those of the whole operator.

    Returns (HubPool, stats) with ``dropped_mass``, the share of the pooling
    weight outside head + per-row top-``residual`` (0.0 = exact)."""
    if device is None:
        device = nbrs.device if torch.is_tensor(nbrs) else "cpu"
    nbrs = _as_numpy(nbrs)
    weights = _as_numpy(weights).astype(np.float32)
    n, k = nbrs.shape
    if head <= 0:
        head = auto_head(n, dtype)
    h = int(min(head, n))
    r = int(min(residual, k))

    limit = n if valid_limit is None else min(valid_limit, n)
    valid = nbrs < limit
    w = np.where(valid, weights, 0.0)
    wsum = w.sum(axis=1, keepdims=True)
    w = np.where(wsum > 0, w / np.maximum(wsum, _EPS), 0.0)

    cols = np.clip(nbrs, 0, n - 1)
    col_mass = np.bincount(cols.reshape(-1), weights=w.reshape(-1), minlength=n)
    head_ids = np.argsort(-col_mass, kind="stable")[:h]
    head_pos = np.full(n, -1, np.int64)
    head_pos[head_ids] = np.arange(h)

    in_head = (head_pos[cols] >= 0) & (w > 0)
    w_tail = np.where(~in_head & (w > 0), w, 0.0)
    if r > 0:
        res_slot = np.argsort(-w_tail, axis=1, kind="stable")[:, :r]
        res_w = np.take_along_axis(w_tail, res_slot, axis=1)
        res_ids = np.take_along_axis(cols, res_slot, axis=1).astype(np.int32)
        res_ids = np.where(res_w > 0, res_ids, 0)
    else:
        res_w = np.zeros((n, 1), np.float32)
        res_ids = np.zeros((n, 1), np.int32)

    total = float(w.sum())
    kept = float(w[in_head].sum()) + float(res_w.sum())
    dropped = 1.0 - kept / total if total > 0 else 0.0

    row_kept = (np.where(in_head, w, 0.0).sum(axis=1, keepdims=True)
                + res_w.sum(axis=1, keepdims=True))
    scale = np.where(row_kept > 0, 1.0 / np.maximum(row_kept, _EPS), 0.0)
    w_head = np.where(in_head, w, 0.0) * scale
    res_w = (res_w * scale).astype(np.float32)

    r0, r1 = (0, n) if rows is None else rows
    sel = in_head[r0:r1]
    res_ids, res_w = res_ids[r0:r1], res_w[r0:r1]
    cells = np.repeat(np.arange(r1 - r0, dtype=np.int64), k).reshape(r1 - r0, k)[sel]
    a_head = scatter_cells((r1 - r0, h), torch.from_numpy(cells),
                           torch.from_numpy(head_pos[cols[r0:r1]][sel]),
                           torch.from_numpy(w_head[r0:r1][sel].astype(np.float32)).to(device),
                           dtype)
    hp = HubPool(a_head=a_head,
                 head_ids=torch.from_numpy(head_ids.astype(np.int64)).to(device),
                 res_nbrs=torch.from_numpy(np.ascontiguousarray(res_ids, np.int32)).to(device),
                 res_w=torch.from_numpy(res_w).to(device))
    stats = {"dropped_mass": dropped, "head_cols": h, "residual_per_row": r,
             "a_bytes_built": (r1 - r0) * h * dtype.itemsize,
             "head_mass": float(w[in_head].sum()) / total if total > 0 else 0.0}
    return hp, stats


def build_hub_pool_device(nbrs: torch.Tensor, weights: torch.Tensor,
                          valid_limit: int | None = None, head: int = 4096,
                          residual: int = 8, dtype: torch.dtype = torch.bfloat16,
                          rows: tuple[int, int] | None = None) -> tuple[HubPool, dict]:
    """``build_hub_pool`` in tensor ops on the tables' device: the column
    mass by a sort-based scatter, the head and each row's residual by stable
    descending sorts (lower id first on ties), the slab by ``scatter_cells``
    straight into ``dtype`` (one rounding from f32). The two stats are the
    only values read back to the host. ``rows`` as ``build_hub_pool``."""
    n, k = nbrs.shape
    if head <= 0:
        head = auto_head(n, dtype)
    if residual <= 0:   # degenerate config: the host builder handles r = 0
        return build_hub_pool(nbrs, weights, valid_limit=valid_limit, head=head,
                              residual=residual, dtype=dtype, rows=rows)
    h = int(min(head, n))
    r = int(min(residual, k))
    limit = n if valid_limit is None else min(valid_limit, n)
    dev = nbrs.device
    valid = nbrs < limit
    w = torch.where(valid, weights.float(), 0.0)
    wsum = w.sum(dim=1, keepdim=True)
    w = torch.where(wsum > 0, w / wsum.clamp_min(_EPS), 0.0)
    cols = nbrs.long().clamp(0, n - 1)

    col_mass = torch.zeros(n, dtype=torch.float32, device=dev)
    col_mass.index_put_((cols.reshape(-1),), w.reshape(-1), accumulate=True)
    head_ids = torch.sort(col_mass, descending=True, stable=True).indices[:h]
    head_pos = torch.full((n,), -1, dtype=torch.int64, device=dev)
    head_pos[head_ids] = torch.arange(h, device=dev)

    pos = head_pos[cols]                                   # [N, K]
    in_head = (pos >= 0) & (w > 0)
    w_tail = torch.where(~in_head & (w > 0), w, 0.0)
    res_w, res_slot = torch.sort(w_tail, dim=1, descending=True, stable=True)
    res_w, res_slot = res_w[:, :r], res_slot[:, :r]
    res_ids = torch.where(res_w > 0, cols.gather(1, res_slot), 0).to(torch.int32)

    total = w.sum()
    w_in_head = torch.where(in_head, w, 0.0)
    head_mass = w_in_head.sum()
    dropped = torch.where(total > 0, 1.0 - (head_mass + res_w.sum()) / total.clamp_min(_EPS),
                          0.0)
    head_frac = torch.where(total > 0, head_mass / total.clamp_min(_EPS), 0.0)

    row_kept = w_in_head.sum(dim=1, keepdim=True) + res_w.sum(dim=1, keepdim=True)
    scale = torch.where(row_kept > 0, 1.0 / row_kept.clamp_min(_EPS), 0.0)
    w_head = w_in_head * scale
    res_w = (res_w * scale).float().contiguous()

    r0, r1 = (0, n) if rows is None else rows
    sel, pos = in_head[r0:r1], pos[r0:r1]
    cells = torch.arange(r1 - r0, device=dev)[:, None].expand(r1 - r0, k)
    a_head = scatter_cells((r1 - r0, h), cells[sel], pos[sel], w_head[r0:r1][sel], dtype)
    dropped, head_frac = torch.stack([dropped, head_frac]).tolist()
    hp = HubPool(a_head=a_head, head_ids=head_ids, res_nbrs=res_ids[r0:r1].contiguous(),
                 res_w=res_w[r0:r1].contiguous())
    stats = {"dropped_mass": dropped, "head_cols": h, "residual_per_row": r,
             "a_bytes_built": (r1 - r0) * h * dtype.itemsize, "head_mass": head_frac}
    return hp, stats


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in and returned as f32 (``a``, ``b`` of one
    dtype): bf16 products are exact in f32, so this is JAX's
    ``dot(..., preferred_element_type=f32)``."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _row_chunks(a: torch.Tensor, dtype: torch.dtype) -> list[tuple[int, int]]:
    """Row ranges of ``a`` converted to ``dtype`` one at a time: all rows at
    once where no conversion is needed, else ``_CHUNK_BYTES`` of them."""
    m = a.shape[0]
    if a.dtype == dtype:
        return [(0, m)]
    step = max(1, _CHUNK_BYTES // max(1, a.shape[1] * dtype.itemsize))
    return [(r, min(r + step, m)) for r in range(0, m, step)]


class _SlabProduct(torch.autograd.Function):
    """``a @ x`` in f32 for a constant slab ``a`` [M, H] in its storage
    dtype and ``x`` [H, D] in the compute dtype; ``a`` is converted to the
    compute dtype in row chunks, in the forward and again in the backward,
    so no converted copy of the whole slab is made or kept. The gradient in
    ``x`` is ``a^T g``, with the f32 cotangent rounded to the compute dtype
    (JAX multiplies it in f32: at bf16 compute the two differ by g's
    rounding), returned in ``x``'s dtype."""

    @staticmethod
    def forward(ctx, a, x):
        ctx.save_for_backward(a, x)
        out = torch.empty((a.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
        for r0, r1 in _row_chunks(a, x.dtype):
            out[r0:r1] = _mm_f32(a[r0:r1].to(x.dtype), x)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        d_x = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for r0, r1 in _row_chunks(a, x.dtype):
            d_x += _mm_f32(a[r0:r1].to(x.dtype).t(), g[r0:r1].to(x.dtype))
        return None, d_x.to(x.dtype)


def _residual(h: torch.Tensor, nbrs: torch.Tensor, w: torch.Tensor, gather_impl: str,
              bwd_layout: SegmentLayout | None) -> torch.Tensor:
    """[B, D] f32 ``sum_r w[b, r] * h[nbrs[b, r]]`` over the whole table
    (no masking, no renormalization: the builder already renormalized)."""
    n = h.shape[0]
    if gather_impl == "pallas":
        return gather_pool(h.contiguous(), nbrs.contiguous(), w.contiguous(), n,
                           bwd_layout=bwd_layout)
    if gather_impl != "xla":
        raise ValueError(f"gather impl must be 'xla' or 'pallas', got {gather_impl!r}")
    if bwd_layout is not None:
        raise ValueError("bwd_layout is for the kernel's backward (gather_impl='pallas')")
    feats = h[nbrs.long().clamp(0, n - 1)]                       # [B, R, D]
    return torch.bmm(w.float().unsqueeze(1), feats.float()).squeeze(1)


def hub_pool_matmul(hp: HubPool, h: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
                    gather_impl: str = "xla",
                    bwd_layout: SegmentLayout | None = None) -> torch.Tensor:
    """``A @ h`` [N, D] in ``dtype`` through the factorization: the head
    GEMM plus the residual gather-pool, added in f32. ``bwd_layout``
    (``gather_impl="pallas"``) is ``segment_layout(hp.res_nbrs, N)``, built
    ahead for the residual's backward."""
    hd = h.to(dtype)
    out = _SlabProduct.apply(hp.a_head, hd[hp.head_ids])
    return (out + _residual(hd, hp.res_nbrs, hp.res_w, gather_impl, bwd_layout)).to(dtype)


def hub_pool_matmul_batch(hp: HubPool, h: torch.Tensor, batch_nodes: torch.Tensor,
                          dtype: torch.dtype = torch.bfloat16,
                          gather_impl: str = "xla", take=take_rows) -> torch.Tensor:
    """Rows ``batch_nodes`` (clamped into the table ``h``) of
    ``hub_pool_matmul(hp, h)`` without pooling the whole graph: rows of A
    are independent, so a [B, H] row gather of the slab and a [B, R]
    residual replace the full product. ``take(a, rows)`` gathers the
    operator's rows (across ranks where it is row-sharded)."""
    hd = h.to(dtype)
    rows = batch_nodes.long().clamp(0, h.shape[0] - 1)
    out = _SlabProduct.apply(take(hp.a_head, rows), hd[hp.head_ids])
    res = _residual(hd, take(hp.res_nbrs, rows), take(hp.res_w, rows), gather_impl, None)
    return (out + res).to(dtype)
