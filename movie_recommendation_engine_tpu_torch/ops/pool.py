"""Fused weighted row gather-pool: ``out[b] = sum_k w[b, k] * table[nbrs[b, k]]``.

Port of ``movie_recommendation_engine_tpu/ops/pallas/pool.py:gather_pool``.
On a CUDA tensor ``gather_pool`` launches the hand-written kernel
``csrc/gather_pool.cu``; on a CPU tensor it runs ``gather_pool_plain``, the
same function in plain PyTorch. Ids ``< 0`` or ``>= valid_limit`` get weight 0
and are clamped into range; the result is f32 whatever the table's dtype.
Only the forward is ported (serving needs no backward).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Kernel launches by this process (the wrapper adds one per launch).
LAUNCHES = 0
# The kernel stages each warp's K (id, weight) pairs in shared memory:
# 8 warps * K * 8 bytes must fit the 227 KB a block may use.
MAX_K = 3584

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("gather_pool")
        fn = lib.gather_pool_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gather_pool_error_string.argtypes = [ctypes.c_int]
        lib.gather_pool_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.gather_pool_error_string)
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
                valid_limit: int) -> torch.Tensor:
    """[B, D] f32 pooled rows. ``table`` [N, D] bf16 or f32, ``nbrs`` [B, K]
    int32, ``weights`` [B, K] f32, ``1 <= valid_limit <= N``."""
    if table.dim() != 2 or nbrs.dim() != 2 or weights.shape != nbrs.shape:
        raise ValueError(
            f"expected table [N, D] and nbrs/weights [B, K], got "
            f"{tuple(table.shape)}, {tuple(nbrs.shape)}, {tuple(weights.shape)}")
    n, d = table.shape
    b, k = nbrs.shape
    if not 1 <= valid_limit <= n:
        raise ValueError(f"valid_limit must be in [1, {n}], got {valid_limit}")
    devices = {table.device, nbrs.device, weights.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    if table.device.type == "cpu":
        return gather_pool_plain(table, nbrs, weights, valid_limit)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"table must be bfloat16 or float32, got {table.dtype}")
    if nbrs.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"nbrs must be int32 and weights float32, got "
                        f"{nbrs.dtype}, {weights.dtype}")
    if not (table.is_contiguous() and nbrs.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("gather_pool needs contiguous tensors")
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the kernel's limit of {MAX_K}")
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    vectorized = (d * table.element_size()) % 16 == 0 and table.data_ptr() % 16 == 0
    fn, err_str = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(table.data_ptr(), int(table.dtype == torch.bfloat16),
                nbrs.data_ptr(), weights.data_ptr(), out.data_ptr(),
                b, k, d, valid_limit, int(vectorized), stream)
    if rc != 0:
        raise RuntimeError(f"gather_pool kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    global LAUNCHES
    LAUNCHES += 1
    return out
