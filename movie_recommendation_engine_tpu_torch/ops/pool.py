"""Fused weighted row gather-pool: ``out[b] = sum_k w[b, k] * table[nbrs[b, k]]``,
and its gradient.

Port of ``movie_recommendation_engine_tpu/ops/pallas/pool.py:gather_pool`` and
of ``gather_pool_ad``'s backward. On a CUDA tensor ``gather_pool`` launches
the hand-written kernel ``csrc/gather_pool.cu`` by the route and tiling
``plan`` picks; on a CPU tensor it runs ``gather_pool_plain``, the same
function in plain PyTorch. Ids ``< 0`` or ``>= valid_limit`` get weight 0 and
are clamped into range; the result is f32 whatever the table's dtype.

Where the table or the weights require grad, ``gather_pool`` runs through
``GatherPoolFunction``, whose backward is ``gather_pool_bwd``; on a CPU
tensor that is ``gather_pool_bwd_plain``. On a CUDA tensor the table's
gradient takes one of two routes. ``"segment"`` (the default) is
``csrc/gather_pool_bwd_segment.cu``, a segment reduction over the walk
table's transpose (``segment_layout``): it uses no atomics, so it is bitwise
the same on every run and equal to ``gather_pool_bwd_segment_plain``.
``"atomic"`` is ``csrc/gather_pool_bwd.cu``, which scatters with f32 atomics,
so the order of its sums changes from run to run. The weights' gradient
(never asked for on the training path) is always the latter kernel's,
which is deterministic. The table's gradient comes back in the table's
dtype, as in JAX.

Routes (see ``csrc/gather_pool.cu``): ``"direct"``, a warp per output row
reading every gathered row from L2, takes any table; ``"resident"`` holds a
column slice of the table's reachable rows in each block's shared memory and
gathers from there, for tables whose slice fits. Both give bitwise equal
results. ``plan`` picks ``direct`` unless told otherwise: on an H100 it beat
``resident`` at the serving shape (``PERF.md``, measured by ``chip_smoke.py``).

``edge_slices`` / ``slice_sum`` sum a weighted edge list by target through
the kernel (a target's incoming edges cut into slices, one ``gather_pool``
call, then each target's slices in order): the PPR push and the edge
forward's message sum, bitwise repeatable where ``index_add_`` is not.

``compact_rows`` / ``compact_grad`` give a bag's table gradient over the
rows its batch touched alone: one sort of the batch's ids numbers the
distinct ones in [0, B * K), and the segment route's passes run on those
compact ids with ``limit = B * K``, so nothing of the table's size is made
(DLRM-DCNv2's tables, ``models/dlrm.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

# Kernel launches by this process (each wrapper adds one per launch; the
# backward adds one to BWD_LAUNCHES per call that launches, and one to
# SEGMENT_LAUNCHES per call that takes the segment route; PLAN_LAUNCHES
# adds PLAN_KERNELS per segment layout planned on the card).
LAUNCHES = 0
BWD_LAUNCHES = 0
SEGMENT_LAUNCHES = 0
PLAN_LAUNCHES = 0
ROUTES = ("direct", "resident")
BWD_ROUTES = ("segment", "atomic")
_MAX_SMEM = 227 * 1024       # dynamic shared memory a block may use on an H100
_SMS = 132                   # H100 SXM streaming multiprocessors
_DIRECT_WARPS = 8            # csrc/gather_pool.cu kWarpsPerBlock
_BWD_WARPS = 8               # csrc/gather_pool_bwd.cu kWarpsPerBlock
_MAX_WARPS = 16              # csrc/gather_pool.cu kMaxResidentWarps
_MIN_WARPS = 4               # fewer warps per block leave the SM idle on latency
_CHUNKS = (4, 2, 1)          # 16-byte chunks per slice row (CH), widest first
# The direct route stages each warp's K (id, weight) pairs in shared memory:
# 8 warps * K * 8 bytes must fit the 227 KB a block may use.
MAX_K = _MAX_SMEM // (_DIRECT_WARPS * 8)
# The segment route's pass 1 stages a chunk's (g row, weight) pairs the same
# way (csrc/gather_pool_bwd_segment.cu, 8 warps a block).
SEGMENT_CHUNK = 32           # valid slots a warp of pass 1 sums
MAX_CHUNK = _MAX_SMEM // (_BWD_WARPS * 8)
PLAN_TILE = 1024             # ids a block of the plan kernels scans (kPlanThreads)
PLAN_KERNELS = 3             # launches of one plan: tile sums, tile offsets, writes

_fn = None
_bwd_fn = None
_segment_fn = None


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
    feats = table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, table.shape[1])
    return torch.bmm(w.unsqueeze(1), feats.float()).squeeze(1)


def _check(table: torch.Tensor, nbrs: torch.Tensor, weights: torch.Tensor,
           valid_limit: int) -> None:
    if table.dim() != 2 or nbrs.dim() != 2 or weights.shape != nbrs.shape:
        raise ValueError(
            f"expected table [N, D] and nbrs/weights [B, K], got "
            f"{tuple(table.shape)}, {tuple(nbrs.shape)}, {tuple(weights.shape)}")
    if not 1 <= valid_limit <= table.shape[0]:
        raise ValueError(f"valid_limit must be in [1, {table.shape[0]}], got {valid_limit}")
    devices = {table.device, nbrs.device, weights.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")


def _check_cuda(*tensors: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather_pool needs contiguous tensors")


def gather_pool(table: torch.Tensor, nbrs: torch.Tensor, weights: torch.Tensor,
                valid_limit: int, *, route: str | None = None,
                bwd_layout: SegmentLayout | None = None) -> torch.Tensor:
    """[B, D] f32 pooled rows. ``table`` [N, D] bf16 or f32, ``nbrs`` [B, K]
    int32, ``weights`` [B, K] f32, ``1 <= valid_limit <= N``. ``route``
    forces ``"direct"`` or ``"resident"`` on the card (tests and
    ``chip_smoke.py``); ``None`` lets ``plan`` pick. Differentiable in
    ``table`` and ``weights``; ``bwd_layout`` is ``segment_layout(nbrs,
    valid_limit[, weights=weights])`` built ahead for the backward (else it
    builds one)."""
    _check(table, nbrs, weights, valid_limit)
    if route not in (None, *ROUTES):
        raise ValueError(f"route must be one of {ROUTES} or None, got {route!r}")
    if bwd_layout is not None:
        _check_layout(bwd_layout, nbrs, valid_limit)
    if torch.is_grad_enabled() and (table.requires_grad or weights.requires_grad):
        return GatherPoolFunction.apply(table, nbrs, weights, valid_limit, route, bwd_layout)
    return _forward(table, nbrs, weights, valid_limit, route)


def _forward(table: torch.Tensor, nbrs: torch.Tensor, weights: torch.Tensor,
             valid_limit: int, route: str | None) -> torch.Tensor:
    if table.device.type == "cpu":
        return gather_pool_plain(table, nbrs, weights, valid_limit)
    if nbrs.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"nbrs must be int32 and weights float32, got "
                        f"{nbrs.dtype}, {weights.dtype}")
    _check_cuda(table, nbrs, weights)
    n, d = table.shape
    b, k = nbrs.shape
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


class GatherPoolFunction(torch.autograd.Function):
    """``gather_pool`` with its gradient in ``table`` and ``weights`` (the
    counterpart of JAX's ``gather_pool_ad``). The backward computes only the
    gradients autograd asks for: on the training path the weights are
    constants, so ``d_w`` is skipped there. ``bwd_layout`` (or None) goes to
    ``gather_pool_bwd`` as its ``layout``."""

    @staticmethod
    def forward(ctx, table, nbrs, weights, valid_limit, route, bwd_layout):
        ctx.save_for_backward(table, nbrs, weights)
        ctx.valid_limit = valid_limit
        ctx.bwd_layout = bwd_layout
        return _forward(table, nbrs, weights, valid_limit, route)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        table, nbrs, weights = ctx.saved_tensors
        d_table, d_w = gather_pool_bwd(table, nbrs, weights, ctx.valid_limit,
                                       g.float().contiguous(),
                                       need_table=ctx.needs_input_grad[0],
                                       need_weights=ctx.needs_input_grad[2],
                                       layout=ctx.bwd_layout)
        return d_table, None, d_w, None, None, None


def gather_pool_bwd_plain(table: torch.Tensor, nbrs: torch.Tensor, weights: torch.Tensor,
                          valid_limit: int, g: torch.Tensor, need_table: bool = True,
                          need_weights: bool = True):
    """(d_table in the table's dtype or None, d_w f32 or None): ``index_add_``
    of ``w * g`` in f32 over the clamped ids of the valid slots, and the
    ``einsum`` of ``g`` with the gathered rows, 0 at masked slots."""
    valid = (nbrs >= 0) & (nbrs < valid_limit)
    w = torch.where(valid, weights.float(), 0.0)
    idx = nbrs.clamp(0, valid_limit - 1).long()
    g32 = g.float()
    d_table = d_w = None
    if need_table:
        contrib = (w[..., None] * g32[:, None, :]).reshape(w.numel(), table.shape[1])
        d_table = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
        d_table = d_table.index_add_(0, idx.reshape(-1), contrib).to(table.dtype)
    if need_weights:
        feats = table.float().index_select(0, idx.reshape(-1)).reshape(*idx.shape,
                                                                       table.shape[1])
        d_w = torch.where(valid, torch.einsum("bd,bkd->bk", g32, feats), 0.0)
    return d_table, d_w


# ---------------------------------------------------------------------------
# The segment route: the walk table's transpose, and the sum in its order
# ---------------------------------------------------------------------------

class SegmentLayout(NamedTuple):
    """The transpose of a [B, K] walk table over its valid slots (ids in
    ``[0, limit)``, and a nonzero weight where the layout was built with
    weights), built by ``segment_layout`` for ``shape`` and ``limit``.
    A layout built with weights is valid only for calls whose weights are
    0 wherever its weights were: a zero-weight slot adds ``0 * g``, so
    leaving it out changes no sum but its rounding order.

    ``slots`` [B * K] holds the flat slot ``b * K + k`` of every slot,
    grouped by id and ascending within each id, the masked slots last; id
    r's slots are ``slots[row_ptr[r]:row_ptr[r + 1]]``. ``chunks`` cuts each
    id's run into pieces of at most ``chunk`` slots, in id order, one row
    ``(row, start, end, part)`` each: every id in ``[0, limit)`` appears, an
    id without slots as one empty chunk. ``part`` is -1 where the chunk is
    its row's only one; else the index of the f32 partial sum it writes.
    ``splits`` has one row ``(row, first part, end part)`` per id of more
    than one chunk: its partials, in chunk order. ``totals`` holds (C, S, P),
    the counts of chunks, splits and partials: only the first C rows of
    ``chunks`` and S rows of ``splits`` are the plan's, as their sizes are
    bounds known without reading the ids (so a layout built on the card
    never waits for it)."""

    shape: tuple[int, int]
    limit: int
    chunk: int
    row_ptr: torch.Tensor       # int32 [limit + 1]
    slots: torch.Tensor         # int32 [B * K]
    chunks: torch.Tensor        # int32 [limit + B * K // chunk, 4], first C rows
    splits: torch.Tensor        # int32 [min(limit, B * K // (chunk + 1)), 3], first S rows
    totals: torch.Tensor        # int32 [3]: C, S, P


def segment_layout(nbrs: torch.Tensor, valid_limit: int, chunk: int = SEGMENT_CHUNK,
                   weights: torch.Tensor | None = None) -> SegmentLayout:
    """The ``SegmentLayout`` of ``nbrs`` [B, K] for ids in
    ``[0, valid_limit)``, on ``nbrs``' device: a stable sort of the ids
    (masked slots sort last; 16-bit keys where the ids fit), row pointers
    by ``searchsorted``, then the chunk plan: on the card the plan kernels of
    ``csrc/gather_pool_bwd_segment.cu`` (``_segment_plan``), which read
    nothing back to the host; on the CPU ``segment_plan_plain``.

    With ``weights`` [B, K], a slot whose weight is exactly 0 is masked
    too, so a table padded with (id 0, weight 0), as the hub residual is,
    does not pile its padding onto row 0 for one warp to sum. Without
    them, every slot with an id in range is kept."""
    if nbrs.dim() != 2:
        raise ValueError(f"expected nbrs [B, K], got {tuple(nbrs.shape)}")
    if weights is not None and (weights.shape != nbrs.shape or weights.device != nbrs.device):
        raise ValueError(f"weights must be {tuple(nbrs.shape)} on {nbrs.device}, got "
                         f"{tuple(weights.shape)} on {weights.device}")
    b, k = nbrs.shape
    if not 1 <= valid_limit < 2**31 - 1 or b * k >= 2**31:
        raise ValueError(f"valid_limit={valid_limit}, B*K={b * k}: the layout takes "
                         "1 <= valid_limit and both below 2**31 - 1")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}] (shared memory), got {chunk}")
    dev = nbrs.device
    flat = nbrs.reshape(-1)
    key_t = torch.int16 if valid_limit < 2**15 - 1 else torch.int32
    keep = (flat >= 0) & (flat < valid_limit)
    if weights is not None:
        keep &= weights.reshape(-1) != 0
    key = torch.where(keep, flat, valid_limit).to(key_t)
    sorted_key, order = torch.sort(key, stable=True)
    row_ptr = torch.searchsorted(sorted_key, torch.arange(valid_limit + 1, dtype=key_t,
                                                          device=dev), out_int32=True)
    plan = _segment_plan if dev.type == "cuda" else segment_plan_plain
    chunks, splits, totals = plan(row_ptr, chunk, valid_limit + b * k // chunk,
                                  min(valid_limit, b * k // (chunk + 1)))
    return SegmentLayout((b, k), valid_limit, chunk, row_ptr, order.to(torch.int32),
                         chunks, splits, totals)


def segment_plan_plain(row_ptr: torch.Tensor, chunk: int, max_chunks: int,
                       max_splits: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chunk plan of ``segment_layout`` from the row pointers, in plain
    tensor ops: (chunks [max_chunks, 4], splits [max_splits, 3], totals
    [3]), int32, the rows past the totals zero. It reads the totals back to
    the host."""
    limit, dev = row_ptr.shape[0] - 1, row_ptr.device
    ptr = row_ptr.long()
    ids = torch.arange(limit, device=dev)
    nch = ((ptr[1:] - ptr[:-1] + chunk - 1) // chunk).clamp_min(1)   # chunks per id
    split = nch > 1
    npart = torch.where(split, nch, 0)
    part0 = torch.cumsum(npart, 0) - npart                           # first part per id
    totals = torch.stack([nch.sum(), split.sum(), npart.sum()])
    c, s, _ = totals.tolist()
    row = torch.repeat_interleave(ids, nch, output_size=c)
    j = torch.arange(c, device=dev) - (torch.cumsum(nch, 0) - nch)[row]
    start = ptr[row] + j * chunk
    end = torch.minimum(start + chunk, ptr[row + 1])
    srow = torch.repeat_interleave(ids, split.long(), output_size=s)
    chunks = torch.zeros((max_chunks, 4), dtype=torch.int32, device=dev)
    chunks[:c] = torch.stack([row, start, end, torch.where(split[row], part0[row] + j, -1)], 1)
    splits = torch.zeros((max_splits, 3), dtype=torch.int32, device=dev)
    splits[:s] = torch.stack([srow, part0[srow], part0[srow] + nch[srow]], 1)
    return chunks, splits, totals.to(torch.int32)


def _check_layout(layout: SegmentLayout, nbrs: torch.Tensor, valid_limit: int) -> None:
    if (layout.shape != tuple(nbrs.shape) or layout.limit != valid_limit
            or layout.slots.device != nbrs.device):
        raise ValueError(
            f"the segment layout was built for nbrs {layout.shape}, valid_limit "
            f"{layout.limit} on {layout.slots.device}; this call has "
            f"{tuple(nbrs.shape)}, {valid_limit} on {nbrs.device}")


def gather_pool_bwd_segment_plain(table: torch.Tensor, nbrs: torch.Tensor,
                                  weights: torch.Tensor, valid_limit: int, g: torch.Tensor,
                                  layout: SegmentLayout) -> torch.Tensor:
    """d_table in the table's dtype, summed in exactly the segment kernel's
    order: per chunk from 0, slot by slot, ``acc + w * g`` as a separate f32
    multiply and add; then each split row's partials, from 0, in chunk
    order; rows without slots, and rows in ``[limit, N)``, are 0."""
    _check_layout(layout, nbrs, valid_limit)
    n, d = table.shape
    k = nbrs.shape[1]
    f32 = torch.float32
    c, s, p = layout.totals.tolist()
    slots = layout.slots.long()
    g32, b_of = g.float(), slots // max(k, 1)             # g's row per sorted slot
    ws = weights.float().reshape(-1)[slots]
    ch = layout.chunks[:c].long()
    lens = ch[:, 2] - ch[:, 1]
    acc = torch.zeros((c, d), dtype=f32, device=table.device)
    for j in range(int(lens.max()) if c else 0):
        on = (lens > j)[:, None]
        at = (ch[:, 1] + j).clamp(max=max(slots.shape[0] - 1, 0))
        acc = torch.where(on, acc + ws[at, None] * g32[b_of[at]], acc)
    out = torch.zeros((n, d), dtype=f32, device=table.device)
    single = ch[:, 3] < 0
    out[ch[single, 0]] = acc[single]
    partials = torch.empty((p, d), dtype=f32, device=table.device)
    partials[ch[~single, 3]] = acc[~single]
    sp = layout.splits[:s].long()
    counts = sp[:, 2] - sp[:, 1]
    tot = torch.zeros((s, d), dtype=f32, device=table.device)
    for j in range(int(counts.max()) if s else 0):
        on = (counts > j)[:, None]
        tot = torch.where(on, tot + partials[(sp[:, 1] + j).clamp(max=p - 1)], tot)
    out[sp[:, 0]] = tot
    return out.to(table.dtype)


# ---------------------------------------------------------------------------
# The backward wrapper
# ---------------------------------------------------------------------------

def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        lib = _build.library("gather_pool_bwd")
        fn = lib.gather_pool_bwd_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gather_pool_bwd_error_string.argtypes = [ctypes.c_int]
        lib.gather_pool_bwd_error_string.restype = ctypes.c_char_p
        _bwd_fn = (fn, lib.gather_pool_bwd_error_string)
    return _bwd_fn


def _segment_kernel():
    global _segment_fn
    if _segment_fn is None:
        lib = _build.library("gather_pool_bwd_segment")
        fn = lib.gather_pool_bwd_segment_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, *[ctypes.c_int] * 6,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        plan = lib.gather_pool_bwd_segment_plan_launch
        plan.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        plan.restype = ctypes.c_int
        lib.gather_pool_bwd_segment_error_string.argtypes = [ctypes.c_int]
        lib.gather_pool_bwd_segment_error_string.restype = ctypes.c_char_p
        _segment_fn = (fn, plan, lib.gather_pool_bwd_segment_error_string)
    return _segment_fn


def _segment_plan(row_ptr: torch.Tensor, chunk: int, max_chunks: int, max_splits: int):
    """``segment_plan_plain`` on the card: ``PLAN_KERNELS`` launches, one
    block a tile of ``PLAN_TILE`` ids, which write the totals on the device
    (the rows past them are unset)."""
    dev = row_ptr.device
    limit = row_ptr.shape[0] - 1
    chunks = torch.empty((max_chunks, 4), dtype=torch.int32, device=dev)
    splits = torch.empty((max_splits, 3), dtype=torch.int32, device=dev)
    totals = torch.empty(3, dtype=torch.int32, device=dev)
    sums = torch.empty(3 * -(-limit // PLAN_TILE), dtype=torch.int32, device=dev)
    _, plan, err_str = _segment_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = plan(row_ptr.data_ptr(), chunks.data_ptr(), splits.data_ptr(), totals.data_ptr(),
                  sums.data_ptr(), limit, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"segment plan kernel launch failed: {err_str(rc).decode()} "
                           f"(cudaError {rc})")
    global PLAN_LAUNCHES
    PLAN_LAUNCHES += PLAN_KERNELS
    return chunks, splits, totals


def _bwd_limits(n: int, d: int, b: int, k: int, chunk: int = SEGMENT_CHUNK) -> None:
    """The backward kernels' own limits: 32-bit sizes, and the shared memory
    of the staged (id, weight) pairs: K of them a warp in the atomic kernel
    (which also computes d_w), ``chunk`` a warp in the segment route."""
    if max(n, d, b, k) >= 2**31 or b * k >= 2**31:
        raise ValueError(f"N={n}, D={d}, B={b}, K={k}: the backward kernel takes fewer "
                         "than 2**31 rows, columns and slots")
    for what, m in (("K", k), ("chunk", chunk)):
        smem = _BWD_WARPS * m * 8
        if smem > _MAX_SMEM:
            raise ValueError(f"{what}={m} needs {smem} bytes of shared memory per block, "
                             f"above the backward kernel's limit of {_MAX_SMEM}")


def _segment_d_table(table, nbrs, weights, valid_limit, g, layout) -> torch.Tensor:
    """The segment route's d_table [N, D] in the table's dtype: pass 1 and
    pass 2 (one C call), their grids sized by the layout's bounds; the
    kernels read the true counts from ``layout.totals``. A layout built
    here leaves out the zero-weight slots."""
    if layout is None:
        layout = segment_layout(nbrs, valid_limit, weights=weights)
    n, d = table.shape
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    # Every partial belongs to a chunk: at most as many as chunks.
    partials = torch.empty((layout.chunks.shape[0], d), dtype=torch.float32,
                           device=table.device)
    fn, _, err_str = _segment_kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(layout.slots.data_ptr(), layout.chunks.data_ptr(), layout.chunks.shape[0],
                layout.splits.data_ptr(), layout.splits.shape[0], layout.totals.data_ptr(),
                weights.data_ptr(), g.data_ptr(), out.data_ptr(),
                int(table.dtype == torch.bfloat16), partials.data_ptr(), valid_limit, n,
                nbrs.shape[1], d, layout.chunk, int(d % 4 == 0 and g.data_ptr() % 16 == 0),
                stream)
    if rc != 0:
        raise RuntimeError(f"gather_pool_bwd segment kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    global SEGMENT_LAUNCHES
    SEGMENT_LAUNCHES += 1
    return out


def gather_pool_bwd(table: torch.Tensor, nbrs: torch.Tensor, weights: torch.Tensor,
                    valid_limit: int, g: torch.Tensor, need_table: bool = True,
                    need_weights: bool = True, *, route: str = "segment",
                    layout: SegmentLayout | None = None):
    """The gradient of ``gather_pool`` for the f32 cotangent ``g`` [B, D]:
    (d_table [N, D] in the table's dtype or None, d_w [B, K] f32 or None),
    each computed only when asked for. On a CUDA tensor the kernels, else
    ``gather_pool_bwd_plain``. ``route`` is ``"segment"`` (deterministic;
    ``layout`` is ``segment_layout(nbrs, valid_limit, weights=weights)``,
    or one without weights; built here with them when None) or
    ``"atomic"`` (f32 atomics; takes no layout)."""
    _check(table, nbrs, weights, valid_limit)
    if route not in BWD_ROUTES:
        raise ValueError(f"route must be one of {BWD_ROUTES}, got {route!r}")
    if layout is not None:
        if route != "segment":
            raise ValueError(f"a layout is for the segment route, not {route!r}")
        _check_layout(layout, nbrs, valid_limit)
    n, d = table.shape
    b, k = nbrs.shape
    if g.shape != (b, d) or g.device != table.device:
        raise ValueError(f"g must be [{b}, {d}] on {table.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if table.device.type == "cpu":
        return gather_pool_bwd_plain(table, nbrs, weights, valid_limit, g,
                                     need_table, need_weights)
    if (nbrs.dtype != torch.int32 or weights.dtype != torch.float32
            or g.dtype != torch.float32):
        raise TypeError(f"nbrs must be int32, weights and g float32, got "
                        f"{nbrs.dtype}, {weights.dtype}, {g.dtype}")
    _element_size(table.dtype)
    _check_cuda(table, nbrs, weights, g)
    _bwd_limits(n, d, b, k, SEGMENT_CHUNK if layout is None else layout.chunk)
    if b == 0 or d == 0 or not (need_table or need_weights):
        dev = table.device
        return (torch.zeros((n, d), dtype=table.dtype, device=dev) if need_table else None,
                torch.zeros((b, k), device=dev) if need_weights else None)
    d_table = d_w = None
    if need_table and route == "segment":
        d_table = _segment_d_table(table, nbrs, weights, valid_limit, g, layout)
    atomic_table = need_table and route == "atomic"
    if atomic_table or need_weights:
        d32 = (torch.zeros((n, d), dtype=torch.float32, device=table.device)
               if atomic_table else None)
        d_w = (torch.zeros((b, k), dtype=torch.float32, device=table.device)
               if need_weights else None)
        vectorized = (d % 4 == 0 and g.data_ptr() % 16 == 0
                      and table.data_ptr() % (4 * table.element_size()) == 0)
        fn, err_str = _bwd_kernel()
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream(table.device).cuda_stream
            rc = fn(table.data_ptr(), int(table.dtype == torch.bfloat16), nbrs.data_ptr(),
                    weights.data_ptr(), g.data_ptr(), None if d32 is None else d32.data_ptr(),
                    None if d_w is None else d_w.data_ptr(), b, k, d, valid_limit,
                    int(vectorized), stream)
        if rc != 0:
            raise RuntimeError(f"gather_pool_bwd kernel launch failed: "
                               f"{err_str(rc).decode()} (cudaError {rc})")
        if atomic_table:
            d_table = d32.to(table.dtype)
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return d_table, d_w


# ---------------------------------------------------------------------------
# The compact route: a bag's table gradient over the rows its batch touched
# ---------------------------------------------------------------------------

class CompactRows(NamedTuple):
    """The distinct ids of a [B, K] id table, as compact rows: the id of slot
    ``i`` in sorted order gets the compact row of its run of equal ids,
    numbered from 0 in id order, so every compact row lies in ``[0, B * K)``
    whatever the table's size. Every shape is fixed by B and K, so a step
    that makes one stays inside its CUDA graph, and nothing is read back.

    ``layout`` is the ``SegmentLayout`` of the compact ids over the limit
    ``B * K`` (equal to ``segment_layout`` of them: the same stable order
    of the slots, so the same sums); ``rows`` [B * K] int64 holds the id of
    compact row r for r below ``count`` and a spare row past it; ``count``
    (0-d int32, on the device) is the number of distinct ids."""

    layout: SegmentLayout
    rows: torch.Tensor
    count: torch.Tensor


def compact_rows(ids: torch.Tensor, spare: int | torch.Tensor) -> CompactRows:
    """The ``CompactRows`` of ``ids`` [B, K] (every id valid) on their
    device: one stable sort of the ids, the first slot of each run marked,
    the compact row of each sorted slot by a running count of the marks,
    row pointers by ``searchsorted``, then the chunk plan of
    ``segment_layout``. ``spare``, a row no id names (or [B * K]
    such rows), fills ``rows`` past the count, so that a write through
    ``rows`` changes no touched row twice."""
    if ids.dim() != 2:
        raise ValueError(f"expected ids [B, K], got {tuple(ids.shape)}")
    b, k = ids.shape
    m = b * k
    if not 1 <= m < 2**31 - 1:
        raise ValueError(f"B*K={m}: the compact route takes 1 <= B*K < 2**31 - 1")
    dev, chunk = ids.device, SEGMENT_CHUNK
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
    first = torch.ones(m, dtype=torch.bool, device=dev)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    run = torch.cumsum(first, 0, dtype=torch.int32) - 1            # compact row of each slot
    row_ptr = torch.searchsorted(run, torch.arange(m + 1, dtype=torch.int32, device=dev),
                                 out_int32=True)
    plan = _segment_plan if dev.type == "cuda" else segment_plan_plain
    chunks, splits, totals = plan(row_ptr, chunk, m + m // chunk, min(m, m // (chunk + 1)))
    layout = SegmentLayout((b, k), m, chunk, row_ptr, order.to(torch.int32), chunks, splits,
                           totals)
    # Each compact row's slots all write its one id: the same value.
    pad = (torch.full((m,), spare, dtype=torch.int64, device=dev) if isinstance(spare, int)
           else spare)
    rows = pad.scatter(0, run.long(), sorted_ids.long())
    return CompactRows(layout, rows, run[-1] + 1)


def compact_grad(g: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                 compact: CompactRows) -> torch.Tensor:
    """[B * K, D] f32: row r the gradient of ``gather_pool``'s table row
    ``compact.rows[r]`` for the f32 cotangent ``g`` [B, D], zero past the
    count; the segment route's passes over the compact ids with ``limit =
    B * K`` (on the CPU ``gather_pool_bwd_segment_plain``, its bits). Each
    touched row's sum is the one the dense segment route makes for it, and
    nothing of the table's size is made. ``ids`` [B, K] give the shape
    only; ``weights`` [B, K] f32 are the forward's."""
    b, k = ids.shape
    m, d = b * k, g.shape[1]
    if g.shape != (b, d) or weights.shape != ids.shape:
        raise ValueError(f"expected g [{b}, D] and weights {tuple(ids.shape)}, got "
                         f"{tuple(g.shape)}, {tuple(weights.shape)}")
    # The segment passes read the shape, dtype and device of the table only.
    like = torch.zeros((), dtype=torch.float32, device=g.device).expand(m, d)
    if g.device.type == "cpu":
        return gather_pool_bwd_segment_plain(like, ids, weights, m, g.float(), compact.layout)
    _check_cuda(weights, g)
    _bwd_limits(m, d, b, k, compact.layout.chunk)
    return _segment_d_table(like, ids, weights, m, g, compact.layout)


class EdgeSlices(NamedTuple):
    """A weighted edge list summed by target through the gather-pool kernel:
    slice s sums ``weights[s, c] * x[nbrs[s, c]]`` (empty slots hold the
    sentinel ``num_nodes`` and weight 0), and target t adds its ``slices[t]``
    (at least 1) consecutive slices."""

    nbrs: torch.Tensor      # [S, width] int32 source ids
    weights: torch.Tensor   # [S, width] f32 edge weights
    slices: torch.Tensor    # [N] int64 slices per target row
    num_nodes: int


def edge_slices(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
                num_nodes: int, width: int = 16) -> EdgeSlices:
    """Each target's incoming edges, in the order they are given, cut into
    slices of at most ``width`` edges, on the edges' device."""
    dev = src.device
    order = torch.sort(dst, stable=True).indices
    src, weights = src[order], weights[order].float()
    in_deg = torch.bincount(dst, minlength=num_nodes)
    first_edge = torch.cumsum(in_deg, 0) - in_deg
    slices = (-(-in_deg // width)).clamp_min(1)
    row = torch.repeat_interleave(torch.arange(num_nodes, device=dev), slices)
    first_slice = torch.cumsum(slices, 0) - slices
    j = torch.arange(row.shape[0], device=dev) - first_slice[row]      # slice within row
    slot = torch.arange(width, device=dev)
    edge = (first_edge[row] + j * width)[:, None] + slot[None, :]
    valid = slot[None, :] < (in_deg[row] - j * width)[:, None]
    if src.numel():
        edge = edge.clamp(max=src.shape[0] - 1)
        nbrs = torch.where(valid, src[edge], num_nodes)
        w = torch.where(valid, weights[edge], 0.0)
    else:
        nbrs = torch.full(edge.shape, num_nodes, device=dev)
        w = torch.zeros(edge.shape, device=dev)
    return EdgeSlices(nbrs.to(torch.int32).contiguous(), w.contiguous(), slices, num_nodes)


def slice_sum(x: torch.Tensor, es: EdgeSlices) -> torch.Tensor:
    """[num_nodes, D] f32: row t sums ``weight * x[src]`` over t's incoming
    edges: one ``gather_pool`` call over the slices, then each target's
    slices in order (``segment_reduce``). Both sum in a fixed order, so the
    result repeats bit for bit."""
    partial = gather_pool(x.contiguous(), es.nbrs, es.weights, es.num_nodes)    # [S, D]
    return torch.segment_reduce(partial, "sum", lengths=es.slices)


def slice_sum_plain(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                    weights: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """``slice_sum``'s plain version: ``index_add_`` of ``weight * x[src]``
    into ``dst`` in f32 (on the card its sums' order is not fixed)."""
    out = torch.zeros((num_nodes, x.shape[1]), dtype=torch.float32, device=x.device)
    return out.index_add_(0, dst.long(), x[src.long()].float() * weights.float()[:, None])
