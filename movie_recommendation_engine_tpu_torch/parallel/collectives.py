"""Explicit collectives for row-sharded tables and a batch shared over ranks.

Port of ``movie_recommendation_engine_tpu/parallel/collectives.py``
(``sharded_gather``, ``ring_shift``), plus the collectives the sharded
forward runs, each an ``autograd.Function`` whose backward is the adjoint
collective:

- ``all_gather_rows``: every rank's rows, concatenated in group order (a
  share may be empty or shorter than the largest); its backward sums the
  gradient over the group and keeps the rank's rows (a reduce-scatter);
- ``all_reduce_sum``: the sum over the group; its backward sums the
  gradients, which is right where each rank's loss is its own share.

``group=None`` is a world of one: each is then the identity. NCCL takes
CUDA tensors as they are. Gloo takes CPU tensors; a CUDA tensor given to a
gloo group is staged through the host (copied out and back), logged once per
collective as ``collective_staged``. Sums of integer or bit-view data are
exact: a masked gather adds one row to zeros.
"""

from __future__ import annotations

import sys
import time

import torch
import torch.distributed as dist

from ..core.logging import MetricsLogger

_STAGED_LOGGED: set[str] = set()
# Calls and bytes each collective moved (the rank's own input); read and
# reset by the smoke run around a step.
STATS: dict[str, list[float]] = {}


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def reset_stats() -> None:
    STATS.clear()


def _count(op: str, x: torch.Tensor, t0: float) -> None:
    s = STATS.setdefault(op, [0, 0, 0.0])
    s[0] += 1
    s[1] += x.numel() * x.element_size()
    s[2] += time.perf_counter() - t0


def _staged(op: str, x: torch.Tensor, group) -> bool:
    stage = x.is_cuda and dist.get_backend(group) != "nccl"
    if stage and op not in _STAGED_LOGGED:
        _STAGED_LOGGED.add(op)
        MetricsLogger(stream=sys.stderr, pretty=False).log(
            "collective_staged", op=op, backend=dist.get_backend(group),
            reason="gloo takes CPU tensors: copied through the host")
    return stage


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in a new tensor."""
    if size(group) == 1:
        return x.clone()
    t0 = time.perf_counter()
    if _staged("all_reduce", x, group):
        buf = x.cpu()
        dist.all_reduce(buf, group=group)
        out = buf.to(x.device)
    else:
        out = x.clone()
        dist.all_reduce(out, group=group)
    _count("all_reduce", x, t0)
    return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Equal shares of every rank, concatenated along dim 0 in group order."""
    s = size(group)
    if s == 1:
        return x.clone()
    t0 = time.perf_counter()
    x = x.contiguous()
    if _staged("all_gather", x, group) or dist.get_backend(group) != "nccl":
        src = x.cpu()
        parts = [torch.empty_like(src) for _ in range(s)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts).to(x.device)
    else:
        out = torch.empty((s * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
    _count("all_gather", x, t0)
    return out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The rank's equal share of the sum over the group."""
    s = size(group)
    if s == 1:
        return x.clone()
    t0 = time.perf_counter()
    x = x.contiguous()
    rows = x.shape[0] // s
    if dist.get_backend(group) == "nccl" and x.is_cuda:
        out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
    else:
        # Gloo: a sum over the group, then the rank's rows of it.
        staged = _staged("reduce_scatter", x, group)
        buf = x.cpu() if staged else x.clone()
        dist.all_reduce(buf, group=group)
        r = rank(group)
        out = buf[r * rows:(r + 1) * rows].to(x.device)
    _count("reduce_scatter", x, t0)
    return out


def _padded(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    pad = x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad])


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sizes):
        ctx.group, ctx.sizes = group, sizes
        top = max(sizes)
        full = _all_gather(_padded(x, top), group)
        return torch.cat([full[i * top:i * top + n] for i, n in enumerate(sizes)])

    @staticmethod
    def backward(ctx, g):
        sizes, top = ctx.sizes, max(ctx.sizes)
        offsets = [sum(sizes[:i]) for i in range(len(sizes))]
        padded = torch.cat([_padded(g[o:o + n], top) for o, n in zip(offsets, sizes)])
        mine = _reduce_scatter(padded.contiguous(), ctx.group)
        return mine[:sizes[rank(ctx.group)]], None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group), None


def all_gather_rows(x: torch.Tensor, group, sizes: list[int] | None = None) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated in group order; ``sizes`` gives
    each rank's row count where they differ (default: all ``x``'s)."""
    if size(group) == 1:
        return x
    sizes = [x.shape[0]] * size(group) if sizes is None else list(sizes)
    if x.shape[0] != sizes[rank(group)]:
        raise ValueError(f"rank {rank(group)} holds {x.shape[0]} rows, sizes say {sizes}")
    return _AllGatherRows.apply(x, group, sizes)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if size(group) == 1 else _AllReduceSum.apply(x, group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the group of a tensor outside autograd (gradients,
    counters)."""
    if size(group) > 1:
        x.copy_(_all_reduce(x, group))
    return x


def _summable_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` in a dtype whose sum with zeros is exact and which both
    backends add: 1-byte floats gathered as bytes, 2-byte floats widened to
    f32 (after the gather, so no copy of the whole table is made)."""
    if table.is_floating_point() and table.element_size() == 1:
        return table.view(torch.uint8)[idx]
    rows = table[idx]
    if rows.is_floating_point() and rows.element_size() == 2:
        return rows.float()
    return rows.to(torch.uint8) if rows.dtype == torch.bool else rows


def sharded_gather(table: torch.Tensor, idx: torch.Tensor, group) -> torch.Tensor:
    """Rows ``idx`` [B] (global ids, the same on every rank) of a table
    row-sharded over ``group``, the rank holding ``table`` = rows
    ``[r*C, (r+1)*C)``: a masked local gather, then one sum over the group.
    Exact in every dtype (one rank contributes each row). Returns [B, ...]
    on every rank."""
    byte_float = table.is_floating_point() and table.element_size() == 1
    if size(group) == 1:
        return table.view(torch.uint8)[idx.long()].view(table.dtype) if byte_float \
            else table[idx.long()]
    c = table.shape[0]
    local = idx.long() - rank(group) * c
    mine = (local >= 0) & (local < c)
    rows = _summable_rows(table, local.clamp(0, c - 1))
    rows = torch.where(mine.view((-1,) + (1,) * (rows.dim() - 1)), rows, 0)
    out = _all_reduce(rows, group)
    return out.view(table.dtype) if byte_float else out.to(table.dtype)


def sharded_rows(table: torch.Tensor, idx: torch.Tensor, group) -> torch.Tensor:
    """``sharded_gather`` where each rank of the group asks for its own rows
    ``idx``: the ids are all-gathered first, every rank answers them all,
    and each keeps its own."""
    s = size(group)
    if s == 1:
        return sharded_gather(table, idx, group)
    counts = _all_gather(torch.tensor([idx.numel()], device=idx.device), group)
    sizes = [int(c) for c in counts.tolist()]
    every = all_gather_rows(idx.reshape(-1).long(), group, sizes)
    start = sum(sizes[:rank(group)])
    return sharded_gather(table, every, group)[start:start + idx.numel()]


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """The rank's block moves ``shift`` places around the group's ring: rank
    ``r`` receives the block of rank ``(r - shift) % S`` (one send and one
    receive a rank)."""
    s = size(group)
    if s == 1 or shift % s == 0:
        return x.clone()
    r = rank(group)
    staged = _staged("ring_shift", x, group)
    src = (x.cpu() if staged else x).contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, dist.get_global_rank(group, (r + shift) % s), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % s), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device)
