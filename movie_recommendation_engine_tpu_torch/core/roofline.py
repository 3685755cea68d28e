"""Least device times (bounds) of the port's kernels on an NVIDIA H100 SXM.

A bound is the larger of the bytes the function must move (each input read
once, each output written once) over the memory rate and, for each kind of
operation, its count over the card's rate for that kind. ``chip_smoke.py``
prints them beside the measured times, with an estimate of the gather-pool
routes' L2 traffic. Pure arithmetic, no device needed.

Rates: NVIDIA's H100 SXM data sheet (3.35 TB/s HBM3, 67 TFLOP/s float32
outside the tensor cores, 1,979 TOP/s int8 dense) and the CUDA C++
Programming Guide's table of arithmetic-instruction throughput for compute
capability 9.0 (results per clock per SM: 64 for 32-bit integer add, logic
and min, 16 for population count), times 132 SMs and the SM clock.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12
SMS = 132
INT32_PER_CLOCK_SM = 64
POPC_PER_CLOCK_SM = 16
SM_CLOCK_MHZ = 1980            # H100 SXM maximum SM clock


def bound_ms(nbytes: float, *ops_and_rates: tuple[float, float]) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of nbytes over the memory
    rate and each (count, rate per second) pair's count over its rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max((n / rate for n, rate in ops_and_rates), default=0.0)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def hamming_bytes(q: int, n: int, tables: int, words: int) -> int:
    """Queries and signatures read once (int32 words), distances written once."""
    return (q + n) * tables * words * 4 + q * n * 4


def hamming_bound(q: int, n: int, tables: int, words: int,
                  sm_clock_mhz: float = SM_CLOCK_MHZ) -> dict:
    """Bound of ``dist[q, n] = min_t sum_w popc(qsig ^ sig)``: the least,
    over the routes that compute it, of each route's bound. Per (query, row,
    table):

    - ``popc_per_word``: W POPC; an XOR and an add per word and a min
      (2W + 1 int32 ops).
    - ``carry_save`` (``csrc/hamming.cu`` for W a multiple of 8): per 8
      words, 8 XORs, 4 carry-save steps of two LOP3s, 4 POPC and 3 ops to
      sum them; a min per table. Other W as ``popc_per_word``.
    - ``int8_tensor_core``: popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b),
      the last term a 0/1 int8 product of depth 32W (2 operations a
      multiply-add); 3 int32 ops to combine and take the min.

    ``ms``/``by``/``route`` are the least route's; ``routes`` holds each
    route's ms, ``bytes_ms`` the bytes' share of each."""
    clock = sm_clock_mhz * 1e6
    popc_rate = POPC_PER_CLOCK_SM * SMS * clock
    int32_rate = INT32_PER_CLOCK_SM * SMS * clock
    qnt = q * n * tables
    nbytes = hamming_bytes(q, n, tables, words)
    if words % 8 == 0:
        csa = ((qnt * words // 2, popc_rate), (qnt * (19 * words // 8 + 1), int32_rate))
    else:
        csa = ((qnt * words, popc_rate), (qnt * (2 * words + 1), int32_rate))
    routes = {
        "popc_per_word": bound_ms(nbytes, (qnt * words, popc_rate),
                                  (qnt * (2 * words + 1), int32_rate)),
        "carry_save": bound_ms(nbytes, *csa),
        "int8_tensor_core": bound_ms(nbytes, (2 * qnt * words * 32, INT8_TENSOR_OPS_PER_S),
                                     (3 * qnt, int32_rate)),
    }
    route = min(routes, key=lambda r: routes[r][0])
    ms, by = routes[route]
    return {"ms": ms, "by": by, "route": route, "bytes": nbytes,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "routes": {r: v[0] for r, v in routes.items()}}


def gather_pool_bound(n: int, d: int, b: int, k: int, table_bytes: int) -> dict:
    """Bound of ``out[b] = sum_k w[b, k] * table[nbrs[b, k]]``: the table,
    ids and weights read once, the f32 output written once; a multiply-add
    per gathered element at the float32 rate."""
    nbytes = n * d * table_bytes + b * k * 4 * 2 + b * d * 4
    ms, by = bound_ms(nbytes, (2 * b * k * d, FP32_OPS_PER_S))
    return {"ms": ms, "by": by, "bytes": nbytes, "flops": 2 * b * k * d}


def gather_pool_l2_bytes(route: str, n: int, d: int, b: int, k: int, table_bytes: int,
                         plan=None) -> int:
    """Estimated bytes a gather-pool call moves through L2 (a diagnostic
    beside ``gather_pool_bound``, which counts each byte once). ``n`` is the
    rows the ids can reach. ``direct`` reads every gathered row segment (all
    B * K slots: masked ones read their clamped row too) and the ids and
    weights once; ``resident`` reads the reachable table once per row group
    (``plan.groups``) and the ids and weights once per column slice
    (``plan.slices``). Both write the f32 output once."""
    pairs, out = b * k * 8, b * d * 4
    if route == "direct":
        return b * k * d * table_bytes + pairs + out
    if route == "resident":
        return plan.groups * n * d * table_bytes + plan.slices * pairs + out
    raise ValueError(f"unknown gather_pool route {route!r}")


def gather_pool_bwd_bound(n: int, d: int, b: int, k: int, table_bytes: int,
                          valid_slots: int | None = None) -> dict:
    """Bound of the gather-pool backward's ``d_table`` (the training path
    never asks for ``d_w``) for ``valid_slots`` of the B * K slots valid (all
    by default): the f32 cotangent g [B, D], ids and weights read once,
    d_table [N, D] written once in the table's dtype, and a multiply and an
    add per valid slot and column at the float32 rate. ``atomics`` is the
    count of f32 adds the kernel's scatter makes (one per valid slot and
    column), printed beside the bound: the L2 carries them, and no published
    rate bounds them."""
    slots = b * k if valid_slots is None else valid_slots
    nbytes = b * d * 4 + b * k * 8 + n * d * table_bytes
    flops = 2 * slots * d
    ms, by = bound_ms(nbytes, (flops, FP32_OPS_PER_S))
    return {"ms": ms, "by": by, "bytes": nbytes, "flops": flops, "atomics": slots * d}


def gather_pool_bwd_l2_bytes(route: str, n: int, d: int, b: int, k: int, table_bytes: int,
                             valid_slots: int, chunks: int = 0, parts: int = 0) -> int:
    """Estimated bytes a gather-pool backward call (``d_table`` only) moves
    through L2, beside ``gather_pool_bwd_bound``, which counts each byte
    once. ``segment`` (given its layout's ``chunks`` and ``parts``): the
    f32 row of g of every valid slot, each slot's index, id-sorted position
    and weight, the 16-byte chunk descriptors, the f32 partials written and
    read once, and d_table written once in the table's dtype. ``atomic``:
    g, the ids and weights read once, the f32 d_table zeroed, one 4-byte
    atomic add per valid slot and column (read and written by the L2's
    atomic unit), and the cast to the table's dtype (f32 read, result
    written)."""
    if route == "segment":
        return (valid_slots * (d * 4 + 12) + chunks * 16 + parts * d * 8
                + n * d * table_bytes)
    if route == "atomic":
        return (b * d * 4 + b * k * 8 + n * d * 4 + valid_slots * d * 8
                + n * d * (4 + table_bytes))
    raise ValueError(f"unknown gather_pool_bwd route {route!r}")
