"""Fused weighted row gather-pool: ``out[b] = sum_k w[b, k] * table[nbrs[b, k]]``.

Port of ``movie_recommendation_engine_tpu/ops/pallas/pool.py:gather_pool``.
On a CUDA tensor ``gather_pool`` launches the hand-written kernel
``csrc/gather_pool.cu`` by the route and tiling ``plan`` picks; on a CPU
tensor it runs ``gather_pool_plain``, the same function in plain PyTorch. Ids
``< 0`` or ``>= valid_limit`` get weight 0 and are clamped into range; the
result is f32 whatever the table's dtype. Only the forward is ported (serving
needs no backward).

Routes (see ``csrc/gather_pool.cu``): ``"direct"``, a warp per output row
reading every gathered row from L2, takes any table; ``"resident"`` holds a
column slice of the table's reachable rows in each block's shared memory and
gathers from there, for tables whose slice fits. Both give bitwise equal
results. ``plan`` picks ``direct`` unless told otherwise: on an H100 it beat
``resident`` at the serving shape (``PERF.md``, measured by ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

# Kernel launches by this process (the wrapper adds one per launch).
LAUNCHES = 0
ROUTES = ("direct", "resident")
_MAX_SMEM = 227 * 1024       # dynamic shared memory a block may use on an H100
_SMS = 132                   # H100 SXM streaming multiprocessors
_DIRECT_WARPS = 8            # csrc/gather_pool.cu kWarpsPerBlock
_MAX_WARPS = 16              # csrc/gather_pool.cu kMaxResidentWarps
_MIN_WARPS = 4               # fewer warps per block leave the SM idle on latency
_CHUNKS = (4, 2, 1)          # 16-byte chunks per slice row (CH), widest first
# The direct route stages each warp's K (id, weight) pairs in shared memory:
# 8 warps * K * 8 bytes must fit the 227 KB a block may use.
MAX_K = _MAX_SMEM // (_DIRECT_WARPS * 8)

_fn = None


class Plan(NamedTuple):
    """One call's route and tiling (see csrc/gather_pool.cu)."""
    route: str              # "direct" or "resident"
    dc: int                 # table columns per block: a slice (resident), D (direct)
    chunks: int             # 16-byte chunks per slice row, CH (resident; 0 direct)
    slices: int             # column slices S (grid x of resident; 1 direct)
    groups: int             # row groups G (grid y of resident); blocks of direct
    rows_per_group: int     # output rows per group (resident); 8 per block (direct)
    warps: int              # warps per block
    smem: int               # bytes of dynamic shared memory per block
    vectorized: bool        # 16-byte loads (else the direct route's scalar path)


def _element_size(dtype: torch.dtype) -> int:
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"table must be bfloat16 or float32, got {dtype}")
    return 2 if dtype == torch.bfloat16 else 4


def _pair_bytes(k: int, chunks: int) -> int:
    """One warp's (offset, weight) buffer: 32 / CH rows of K rounded up to
    2 mod 4 pairs (csrc/gather_pool.cu pair_stride)."""
    return (32 // chunks) * (((k + 1) | 3) - 1) * 8


def max_resident_rows(d: int, k: int, dtype: torch.dtype, chunks: int = 1) -> int:
    """The most reachable table rows (``valid_limit``) the resident route
    takes with slices of ``chunks`` 16-byte chunks a row (1, the narrowest,
    gives the route's limit) for rows of ``d`` elements and K neighbours:
    the slice beside the pair buffers of the fewest warps. 0 where the row
    is not a whole number of 16-byte chunks or is narrower than the slice."""
    if d == 0 or d * _element_size(dtype) % 16 or chunks * 16 > d * _element_size(dtype):
        return 0
    return max(0, (_MAX_SMEM - _MIN_WARPS * _pair_bytes(k, chunks)) // (16 * chunks))


def _resident(n: int, d: int, b: int, k: int, es: int) -> Plan | None:
    """The resident tiling, or None where no slice fits: the widest slice
    (CH = 4, 2, 1 chunks; no wider than the row) that fits beside the pair
    buffers of at least ``_MIN_WARPS`` warps, as many warps as fit up to 16,
    and enough row groups to give each of the 132 SMs one block."""
    row_chunks = d * es // 16
    for ch in _CHUNKS:
        if ch > row_chunks:
            continue
        slice_bytes = n * ch * 16
        warps = min(_MAX_WARPS, (_MAX_SMEM - slice_bytes) // _pair_bytes(k, ch))
        if warps < _MIN_WARPS:
            continue
        rows = 32 // ch
        slices = -(-row_chunks // ch)
        passes = -(-b // rows)
        groups = max(1, min(_SMS // slices, passes))
        rows_per_group = rows * -(-passes // groups)
        groups = -(-b // rows_per_group)
        return Plan("resident", ch * 16 // es, ch, slices, groups, rows_per_group,
                    warps, slice_bytes + warps * _pair_bytes(k, ch), True)
    return None


def plan(n: int, d: int, b: int, k: int, dtype: torch.dtype, route: str | None = None,
         aligned: bool = True) -> Plan:
    """Route and tiling for B output rows of K neighbours over a table whose
    ids can reach ``n`` rows (``valid_limit``) of ``d`` elements of ``dtype``.

    ``route=None`` picks ``direct``, the faster route at the serving shape;
    ``route="resident"`` forces the other. A forced route raises ValueError
    where it cannot run; so does anything beyond the kernels' limits (shared
    memory, grid, 32-bit indexing)."""
    es = _element_size(dtype)
    if route not in (None, *ROUTES):
        raise ValueError(f"route must be one of {ROUTES} or None, got {route!r}")
    if min(n, d, b, k) < 0 or max(n, b) >= 2**31 or b * k >= 2**31:
        raise ValueError(f"N={n}, B={b}, K={k}: the kernel takes fewer than 2**31 "
                         "rows and slots")
    vectorized = aligned and (d * es) % 16 == 0
    if route == "resident":
        res = _resident(n, d, b, k, es) if vectorized and d > 0 else None
        if res is None:
            why = ("a row that is not a whole number of 16-byte chunks or an "
                   "unaligned table" if not vectorized or d == 0 else
                   f"{n} rows: a 16-byte slice and {_MIN_WARPS} warps' pairs need "
                   f"{n * 16 + _MIN_WARPS * _pair_bytes(k, 1)} bytes of shared "
                   f"memory, above the limit of {_MAX_SMEM}")
            raise ValueError(f"the resident route does not take {why}")
        return res
    smem = _DIRECT_WARPS * k * 8
    if smem > _MAX_SMEM:
        raise ValueError(f"K={k} needs {smem} bytes of shared memory per block, "
                         f"above the direct route's limit of {_MAX_SMEM} (K <= {MAX_K})")
    blocks = -(-b // _DIRECT_WARPS)
    return Plan("direct", d, 0, 1, blocks, _DIRECT_WARPS, _DIRECT_WARPS, smem, vectorized)


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("gather_pool")
        direct = lib.gather_pool_launch
        direct.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
        direct.restype = ctypes.c_int
        resident = lib.gather_pool_resident_launch
        resident.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 10,
                             ctypes.c_void_p]
        resident.restype = ctypes.c_int
        lib.gather_pool_error_string.argtypes = [ctypes.c_int]
        lib.gather_pool_error_string.restype = ctypes.c_char_p
        _fn = (direct, resident, lib.gather_pool_error_string)
    return _fn


def gather_pool_plain(table: torch.Tensor, nbrs: torch.Tensor,
                      weights: torch.Tensor, valid_limit: int) -> torch.Tensor:
    """Masked ``index_select`` + weighted sum in f32: [B, D]."""
    valid = (nbrs >= 0) & (nbrs < valid_limit)
    w = torch.where(valid, weights.float(), 0.0)
    idx = nbrs.clamp(0, valid_limit - 1).long()
    feats = table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, -1)
    return torch.bmm(w.unsqueeze(1), feats.float()).squeeze(1)


def gather_pool(table: torch.Tensor, nbrs: torch.Tensor, weights: torch.Tensor,
                valid_limit: int, *, route: str | None = None) -> torch.Tensor:
    """[B, D] f32 pooled rows. ``table`` [N, D] bf16 or f32, ``nbrs`` [B, K]
    int32, ``weights`` [B, K] f32, ``1 <= valid_limit <= N``. ``route``
    forces ``"direct"`` or ``"resident"`` on the card (tests and
    ``chip_smoke.py``); ``None`` lets ``plan`` pick."""
    if table.dim() != 2 or nbrs.dim() != 2 or weights.shape != nbrs.shape:
        raise ValueError(
            f"expected table [N, D] and nbrs/weights [B, K], got "
            f"{tuple(table.shape)}, {tuple(nbrs.shape)}, {tuple(weights.shape)}")
    n, d = table.shape
    b, k = nbrs.shape
    if not 1 <= valid_limit <= n:
        raise ValueError(f"valid_limit must be in [1, {n}], got {valid_limit}")
    if route not in (None, *ROUTES):
        raise ValueError(f"route must be one of {ROUTES} or None, got {route!r}")
    devices = {table.device, nbrs.device, weights.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    if table.device.type == "cpu":
        return gather_pool_plain(table, nbrs, weights, valid_limit)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if nbrs.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"nbrs must be int32 and weights float32, got "
                        f"{nbrs.dtype}, {weights.dtype}")
    if not (table.is_contiguous() and nbrs.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("gather_pool needs contiguous tensors")
    p = plan(valid_limit, d, b, k, table.dtype, route=route,
             aligned=table.data_ptr() % 16 == 0)
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    direct, resident, err_str = _kernel()
    bf16 = int(table.dtype == torch.bfloat16)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        if p.route == "resident":
            rc = resident(table.data_ptr(), bf16, nbrs.data_ptr(), weights.data_ptr(),
                          out.data_ptr(), b, k, d, valid_limit, p.chunks, p.slices,
                          p.groups, p.rows_per_group, p.warps, p.smem, stream)
        else:
            rc = direct(table.data_ptr(), bf16, nbrs.data_ptr(), weights.data_ptr(),
                        out.data_ptr(), b, k, d, valid_limit, int(p.vectorized), stream)
    if rc != 0:
        raise RuntimeError(f"gather_pool kernel launch failed ({p.route} route): "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    global LAUNCHES
    LAUNCHES += 1
    return out
