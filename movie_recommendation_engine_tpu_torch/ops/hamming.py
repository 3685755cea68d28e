"""Multi-table Hamming distance for LSH retrieval, and its top-k.

Port of ``movie_recommendation_engine_tpu/ops/pallas/hamming.py``:
``dist[q, n] = min_t sum_w popcount(qsig[q, t*W + w] ^ sigs[n, t*W + w])``.
Signatures are [rows, T*W] int32 holding the uint32 bit patterns of the JAX
package (torch has little uint32 support; bit 31 becomes the sign). On a CUDA
tensor ``hamming_distance`` launches ``csrc/hamming.cu`` with the tiling
``plan`` picks from Q (queries per block) and the signatures' alignment (16-byte
or scalar loads); on a CPU tensor it runs ``hamming_distance_plain``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

# Kernel launches by this process (the wrapper adds one per launch).
LAUNCHES = 0
_MAX_SMEM = 227 * 1024     # dynamic shared memory a block may use on an H100
_MAX_GRID_Y = 65535
_ROWS = 32                 # corpus rows per block (csrc/hamming.cu kRows)
_VEC_WORDS = (4, 8, 16)    # words per table read as 16-byte loads
_QUERY_TILES = (1, 4, 8, 16, 32)

_fn = None


class Plan(NamedTuple):
    """The kernel's tiling for one call (see csrc/hamming.cu)."""
    qt: int             # queries per block
    wc: int             # words per table read as uint4, or 0 for scalar reads
    grid: tuple[int, int]
    smem: int           # bytes of dynamic shared memory


def plan(nq: int, ns: int, num_tables: int, words: int,
         aligned: bool = True) -> Plan:
    """Tiling for Q queries against N rows of T tables of W words. The query
    tile is the smallest of 1, 4, 8, 16, 32 that holds Q (32 above that), so
    Q = 1 does 1/64 of the work of Q = 64. Raises ValueError, naming the
    limit, on what the kernel does not take."""
    if num_tables < 1 or words < 1:
        raise ValueError(f"need T >= 1 and W >= 1, got T={num_tables}, W={words}")
    qt = next((t for t in _QUERY_TILES if t >= nq), _QUERY_TILES[-1])
    wc = words if aligned and words in _VEC_WORDS else 0
    grid_y = -(-nq // qt)
    smem = 4 * qt * (num_tables * words + _ROWS)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"T*W={num_tables * words} words (T={num_tables}, W={words}) need "
            f"{smem} bytes of shared memory per block, above the kernel's "
            f"limit of {_MAX_SMEM}")
    if grid_y > _MAX_GRID_Y:
        raise ValueError(f"Q={nq} needs {grid_y} query tiles of {qt}, above the "
                         f"grid's limit of {_MAX_GRID_Y}")
    if ns >= 2**31 or nq >= 2**31:
        raise ValueError(f"Q={nq}, N={ns}: the kernel takes fewer than 2**31 rows")
    return Plan(qt, wc, (-(-ns // _ROWS), grid_y), smem)


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("hamming")
        fn = lib.hamming_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       *[ctypes.c_int] * 7, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.hamming_error_string.argtypes = [ctypes.c_int]
        lib.hamming_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.hamming_error_string)
    return _fn


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of the low 32 bits of an int64 tensor (torch has no
    popcount op)."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance_plain(qsig: torch.Tensor, sigs: torch.Tensor,
                           num_tables: int, words: int) -> torch.Tensor:
    """XOR + popcount in int64, chunked over N to bound the [Q, C, T*W]
    intermediate: [Q, N] int32."""
    nq, ns = qsig.shape[0], sigs.shape[0]
    q = qsig.long()[:, None, :]
    chunk = max(1, (1 << 24) // max(nq * num_tables * words, 1))
    out = []
    for s in range(0, ns, chunk):
        x = q ^ sigs[s:s + chunk].long()[None, :, :]
        ham = _popcount32(x).reshape(nq, -1, num_tables, words).sum(-1)
        out.append(ham.amin(-1))
    if not out:
        return torch.empty((nq, 0), dtype=torch.int32, device=qsig.device)
    return torch.cat(out, dim=1).to(torch.int32)


def hamming_distance(qsig: torch.Tensor, sigs: torch.Tensor, num_tables: int,
                     words: int) -> torch.Tensor:
    """[Q, N] int32 min-table Hamming distances of [Q, T*W] and [N, T*W]
    int32 signatures."""
    tw = num_tables * words
    if qsig.dim() != 2 or sigs.dim() != 2 or qsig.shape[1] != tw \
            or sigs.shape[1] != tw:
        raise ValueError(f"expected [Q, {tw}] and [N, {tw}] signatures, got "
                         f"{tuple(qsig.shape)} and {tuple(sigs.shape)}")
    if qsig.dtype != torch.int32 or sigs.dtype != torch.int32:
        raise TypeError(f"signatures must be int32, got {qsig.dtype}, {sigs.dtype}")
    if qsig.device != sigs.device:
        raise ValueError(f"tensors on different devices: {qsig.device}, {sigs.device}")
    if qsig.device.type == "cpu":
        return hamming_distance_plain(qsig, sigs, num_tables, words)
    if qsig.device.type != "cuda":
        raise ValueError(f"unsupported device {qsig.device}")
    if not (qsig.is_contiguous() and sigs.is_contiguous()):
        raise ValueError("hamming_distance needs contiguous signatures")
    nq, ns = qsig.shape[0], sigs.shape[0]
    dev = qsig.device
    p = plan(nq, ns, num_tables, words,
             aligned=qsig.data_ptr() % 16 == 0 and sigs.data_ptr() % 16 == 0)
    out = torch.empty((nq, ns), dtype=torch.int32, device=dev)
    if nq == 0 or ns == 0:
        return out
    fn, err_str = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(qsig.data_ptr(), sigs.data_ptr(), out.data_ptr(), nq, ns,
                num_tables, words, p.qt, p.wc, p.smem, stream)
    if rc != 0:
        raise RuntimeError(f"hamming kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    global LAUNCHES
    LAUNCHES += 1
    return out


def smallest_k(dist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values [Q, k] ascending, indices [Q, k] int64) of the k smallest
    non-negative integer distances per row, the lower index first among
    equal distances — ``jax.lax.top_k(-dist, k)``'s order, which plain
    ``torch.topk`` does not promise. Ranks the unique key dist * N + index."""
    n = dist.shape[1]
    key = dist.long() * n + torch.arange(n, device=dist.device)
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return (top // n).to(dist.dtype), top % n


def hamming_topk(qsig: torch.Tensor, sigs: torch.Tensor, k: int,
                 num_tables: int, words: int):
    """(distances [Q, k] int32, indices [Q, k] int64): kernel distances +
    the tie-ordered top-k of ``smallest_k``."""
    return smallest_k(hamming_distance(qsig, sigs, num_tables, words), k)
