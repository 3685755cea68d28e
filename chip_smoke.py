"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  — the card (``nvidia-smi`` name and power limit; the raw line too)
   and its maximum SM clock (``clocks.max.sm``), which the bounds use.
2. kernels — builds the hand-written CUDA kernels from ``ops/csrc`` with
   ``nvcc`` (one process a source, in parallel; the backward's two routes
   are checked in 6) and holds the
   gather-pool forward and Hamming against their plain PyTorch versions
   at the serving shapes and at edge shapes (``gather_pool`` to 1e-4 abs on
   each of its routes, the routes bitwise equal to each other; Hamming
   exactly), and times Hamming, its plain version and a PyTorch library call
   at every server batch bucket (Q = 1..64). Times are device times: CUDA
   events around calls that run back to back on the card behind a spin that
   outlasts the host's enqueue, cross-checked against the profiler's device
   time per call; the host's cost per call (us) is reported beside them
   (``cuda_ms``, ``timed``). Bounds come from ``core/roofline.py``.
3. serve   — the main path: ``api.Engine`` on ``cuda`` at the default model
   width (synthetic 4000 movies / 12000 users / 400k ratings, features 128,
   hidden 256, embed 128, K = 50, 100 walks of length 2, LSH 256 bits x 16
   tables) with ``pool_impl=gather``, ``gather_impl=pallas``,
   ``search_method=lsh`` and the port's seeded init: tables, one embedding
   pass (two ``gather_pool`` launches), then a ``BatchingRecommender`` that
   answers requests from several threads plus one GET and one POST over HTTP
   on 127.0.0.1. The kernel launch counts are zeroed just before and read
   just after. Reports embed time (also with the torch gather formulation
   that ``gather_impl=auto`` picks), request latency, LSH recall@10 and a
   ``torch.profiler`` split of host and device time for an embedding pass
   and for one search of the largest and smallest batch bucket.
4. gather_pool — both ``gather_pool`` routes timed (as in 2) on (a) the
   serve phase's own layer-0 walk table, (b) uniform ids at N = B = 4000,
   (c) uniform ids at N = B = 59,392, each beside its bound, its share of it
   and an L2-traffic estimate; ``plan``'s pick at (a) must be the faster;
   the plain version and ``embedding_bag`` at (a); the resident route at
   K = 1, on an 8-row table, both, and without bank conflicts (where its
   time goes); how the walk table's ids repeat.
5. serve_default — the default config (dense pool matrices, exact search).
6. train   — the training path at the same width (batch 512, 500 shared
   random negatives, NCE, dropout 0.2, bf16 compute): ``Engine.fit`` for 2
   epochs (epoch 1 adds one hard negative per query) with ``pool_impl=gather``,
   ``gather_impl=pallas`` (each step launches the gather-pool forward and
   backward kernels twice: layer 0 over the whole graph, the batch layer),
   the launch counts zeroed just before and read just after; the loss is
   finite, ``last_model`` reloads and evaluates to the same HR@k; then the
   default (dense) config the same way. Every backward call of the fit must
   take the segment route. One step with the kernels and one with
   ``gather_impl=xla`` from the same params, tables and draws (float32
   compute) agree in loss, gradients and updated params; two identical
   steps through the kernels are compared bit for bit (reported, with the
   first op that differs, not gated). Both backward routes are held against
   ``gather_pool_bwd_plain`` at the step's shapes (layer 0, B = 3980; the
   batch layer, B = 1524 and 4596) and at edge shapes; there the segment
   plan kernel must equal ``segment_plan_plain`` and the segment route must
   be bitwise equal to ``gather_pool_bwd_segment_plain`` and across calls.
   Both routes are timed (as in 2) at layer 0 and B = 1524 and with uniform
   ids at layer 0's shape, beside the bound and an L2-byte estimate: the
   segment kernel with its layout built ahead, its whole call with the
   layout built in it, and the layout alone, the plain versions and
   ``embedding_bag``'s backward; the step's wall time, device time and busy
   share, and examples per second.
7. train_hub — the at-scale rung: ``api.Engine`` at the same width on a
   59,393-movie synthetic corpus (above the dense and hybrid rungs' 32,768
   rows) with the default ``pool_impl=auto`` and ``gather_impl=pallas``, its
   walk tables replaced by the popularity tables of the JAX package's
   at-scale figure (a copy of ``bench.py:_setup_numpy``). The trainer must
   pick the hub rung for both layers (``hubf``: each residual through the
   gather-pool kernels, K = 8) itself. One embedding pass, train steps at 0
   and 6 hard negatives (launch counts zeroed just before and read just
   after), two identical steps compared bit for bit, a kernel step against
   an ``xla`` step in f32, one step each of the gather and hybrid rungs on
   the same tables and draws, and both kernels timed at the hub residual's
   shapes (the full graph, B = N, and the batch layer, B = 1524).
8. check   — the outputs are finite, unit-norm and of the expected shape, and
   the CUDA engine agrees with the CPU engine (plain versions) on a small
   input given the same params and tables, on the gather config and on a
   ``pool_impl=hub`` config.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure ends the run with a non-zero
exit code and no result line. It exits non-zero at once without a card.
TF32 is off for matrix products and cuDNN (``main``), so float32 checks
compare float32 arithmetic.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ---------------------------------------------------------------------------
# Device timing. ``cuda_ms`` queues a spin (``torch.cuda._sleep``) ahead of
# the start event that outlasts the host's enqueue of all the timed calls, so
# they run back to back on the card and the events time the device. Without
# the spin, a call whose host cost exceeds its kernel's time is timed by the
# host.
# ---------------------------------------------------------------------------

# Cycles per second of the spin that torch.cuda._sleep counts (the SM clock;
# at a lower clock the spin only lasts longer).
GPU_SPIN_HZ = 1.98e9


def host_us(fn, iters: int = 50) -> float:
    """Host cost of one call (us): the time to enqueue ``iters`` calls while
    the device is held busy by a spin, so no call waits on the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.05 * GPU_SPIN_HZ))
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / iters


def cuda_ms(fn, iters: int = 50, reps: int = 11, warm_s: float = 0.2) -> dict:
    """Device time per call: the median over ``reps`` of the CUDA-event time
    of ``iters`` calls that run back to back on the card, after ``warm_s``
    seconds of calls (the clocks ramp up under load). A spin
    (``torch.cuda._sleep``) queued before the start event outlasts the host's
    enqueue of the ``iters`` calls (twice the measured host cost, plus
    0.1 ms), so the events time the device and not the host. Returns
    ``{"ms": device ms per call, "host_us": host us per call}``."""
    t_end = time.perf_counter() + warm_s
    while time.perf_counter() < t_end:
        fn()
        torch.cuda.synchronize()
    host = host_us(fn, iters)
    spin = int((2 * host * 1e-6 * iters + 1e-4) * GPU_SPIN_HZ)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return {"ms": statistics.median(times), "host_us": host}


def timed(fn, iters: int = 50, profile_calls: int = 20, kernels: int = 1) -> dict:
    """``cuda_ms`` and, as its cross-check, the profiler's device time per
    call (``device_profile``: the device events' own time, so no gap between
    launches) and its kernels per call. A call launches at least ``kernels``
    device kernels; a profiler window that recorded fewer (now and then one
    loses some or all of its device events, seen on an H100 with torch 2.11)
    is taken again, twice at most, and if the last still falls short its
    time is reported as unresolved (``profiler_ms`` None) rather than as a
    time."""
    t = cuda_ms(fn, iters)
    for _ in range(3):
        prof = device_profile(fn, profile_calls)
        if prof["device_ms"] is not None and prof["kernels_per_call"] >= kernels:
            break
    short = prof["device_ms"] is None or prof["kernels_per_call"] < kernels
    t["profiler_ms"] = None if short else prof["device_ms"]
    t["kernels_per_call"] = prof["kernels_per_call"]
    if short:
        t["profiler_unresolved"] = (f"{prof['kernels_per_call']} kernels a call recorded, "
                                    f"at least {kernels} launched")
    return t


def device_profile(fn, calls: int = 20) -> dict:
    """Host wall time per call against device time per call (sum of the
    device events' self time in a ``torch.profiler`` window; nothing here
    runs two kernels at once, so the sum is busy time), and the top kernels.
    Device fields are None when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # A warm-up cycle first: the tracer starts late, and a window opened
    # cold loses its first device events (one to three, measured on one
    # H100). Only the second cycle's events are kept.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        prof.step()
    # Device events only: a CPU op's device time repeats its kernels' time,
    # and so does the schedule's step annotation (``ProfilerStep#``).
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not e.key.startswith("ProfilerStep")]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / calls
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_ms": wall_ms,
            "device_ms": dev_ms if events else None,
            "kernels_per_call": sum(e.count for e in events) / calls,
            "busy_share": dev_ms / wall_ms if events else None,
            "top": [[e.key[:60], e.self_device_time_total / 1e3 / calls] for e in top]}


# ---------------------------------------------------------------------------
# 2. kernels
# ---------------------------------------------------------------------------

def pool_inputs(gen, n, d, b, k, limit, dtype, dev):
    table = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    nbrs = torch.randint(-2, n + 1, (b, k), generator=gen, device=dev, dtype=torch.int32)
    w = torch.rand((b, k), generator=gen, device=dev)
    return table, nbrs, w


def check_pool_routes(pool, table, nbrs, w, limit, what: str) -> float:
    """Every route ``plan`` lets run (and its own pick) against the plain
    version to 1e-4; the routes bitwise equal to each other; a route that
    ``plan`` refuses raises ValueError. Returns the largest error."""
    ref = pool.gather_pool_plain(table, nbrs, w, limit)
    outs = {}
    for route in pool.ROUTES:
        try:
            pool.plan(limit, table.shape[1], nbrs.shape[0], nbrs.shape[1], table.dtype,
                      route=route, aligned=table.data_ptr() % 16 == 0)
        except ValueError:
            try:
                pool.gather_pool(table, nbrs, w, limit, route=route)
            except ValueError:
                continue
            check(False, f"gather_pool {what}: {route} ran where plan refuses it")
        outs[route] = pool.gather_pool(table, nbrs, w, limit, route=route)
    outs["plan"] = pool.gather_pool(table, nbrs, w, limit)
    torch.cuda.synchronize()
    err = max((o - ref).abs().max().item() for o in outs.values())
    check(err <= 1e-4, f"gather_pool {what}: max err {err}")
    if "resident" in outs:
        check(torch.equal(outs["resident"], outs["direct"]),
              f"gather_pool {what}: resident and direct routes differ")
    return err


def kernel_phase(dev, sm_clock_mhz: float) -> tuple[float, dict]:
    from movie_recommendation_engine_tpu_torch.core import roofline
    from movie_recommendation_engine_tpu_torch.ops import _build, hamming, pool

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in _build.build_logs.items():
        print(f"[nvcc {name}]\n{log}", file=sys.stderr)
    gen = torch.Generator(device=dev).manual_seed(0)

    # gather_pool, every route at each shape: the scalar path (D * size not a
    # multiple of 16 bytes), K above one warp, slices of 4, 2 and 1 chunks,
    # a D that is not a whole number of slices, valid_limit below N, N just
    # inside and just outside the two-chunk slice's and the resident route's
    # limits, and the serving shape (N = B = 4000, K = 50, D = 256 bf16).
    bf16, f32 = torch.bfloat16, torch.float32
    two_chunk_rows = pool.max_resident_rows(256, 50, bf16, chunks=2)
    max_rows = pool.max_resident_rows(256, 50, bf16)
    gather_err = 0.0
    for n, d, b, k, limit, dtype in [(96, 128, 19, 11, 96, f32), (37, 100, 7, 6, 30, bf16),
                                     (29, 37, 5, 70, 29, f32), (500, 64, 300, 70, 450, bf16),
                                     (3980, 200, 997, 50, 3980, bf16),
                                     (3980, 256, 1201, 50, 3000, f32),
                                     (two_chunk_rows, 256, 700, 50, two_chunk_rows, bf16),
                                     (two_chunk_rows + 1, 256, 700, 50, two_chunk_rows + 1, bf16),
                                     (max_rows, 256, 600, 50, max_rows, bf16),
                                     (max_rows + 1, 256, 600, 50, max_rows + 1, bf16),
                                     (4000, 256, 4000, 50, 4000, bf16)]:
        table, nbrs, w = pool_inputs(gen, n, d, b, k, limit, dtype, dev)
        gather_err = max(gather_err, check_pool_routes(
            pool, table, nbrs, w, limit, f"{n}x{d} B={b} K={k} limit={limit} {dtype}"))

    # Hamming: edge shapes (ragged Q and N, scalar and vector paths, 32
    # tables), then the serving shape: Q = 64, the largest batch bucket;
    # N = 4000; T = 16 tables of W = 8 words.
    def sig_pair(q, n_s, t, wd):
        return (torch.randint(-2**31, 2**31, (q, t * wd), generator=gen, device=dev,
                              dtype=torch.int32),
                torch.randint(-2**31, 2**31, (n_s, t * wd), generator=gen, device=dev,
                              dtype=torch.int32))

    ham_err = 0
    for q, n_s, t, wd in [(5, 37, 3, 2), (33, 129, 3, 5), (2, 4000, 16, 8),
                          (17, 4001, 16, 8), (65, 129, 32, 8), (1, 4000, 16, 8),
                          (64, 4000, 16, 8)]:
        qs, ss = sig_pair(q, n_s, t, wd)
        got = hamming.hamming_distance(qs, ss, t, wd)
        ref = hamming.hamming_distance_plain(qs, ss, t, wd)
        torch.cuda.synchronize()
        mism = int((got != ref).sum().item())
        check(mism == 0, f"hamming Q={q} N={n_s} T={t} W={wd}: {mism} mismatches")
        ham_err = max(ham_err, int((got - ref).abs().max().item()))
    q, n_s, t, wd = 64, 4000, 16, 8
    by_q = {}
    for qq in (64, 32, 16, 8, 4, 2, 1):
        by_q[qq] = timed(lambda qq=qq: hamming.hamming_distance(qs[:qq], ss, t, wd))
    h_plain = cuda_ms(lambda: hamming.hamming_distance_plain(qs, ss, t, wd), iters=5)
    # Library yardstick: the +-1 matmul form (ham = (B - q.s) / 2, max over
    # tables), signatures unpacked once outside the timing as an index would.
    shifts = torch.arange(32, device=dev)

    def pm(x):
        bits = (x.long()[..., None] >> shifts) & 1                  # [R, T*W, 32]
        return (bits.reshape(x.shape[0], t, wd * 32).permute(1, 0, 2)
                .to(torch.bfloat16) * 2 - 1)                        # [T, R, B]

    q_pm, s_pm = pm(qs), pm(ss)
    lib_dist = (wd * 32 - torch.bmm(q_pm, s_pm.transpose(1, 2)).float().amax(0)) / 2
    check(torch.equal(lib_dist.int(), hamming.hamming_distance(qs, ss, t, wd)),
          "matmul-form Hamming yardstick disagrees")
    h_lib = timed(lambda: torch.bmm(q_pm, s_pm.transpose(1, 2)).amax(0))
    h_bound = roofline.hamming_bound(q, n_s, t, wd, sm_clock_mhz)
    h_bound_q1 = roofline.hamming_bound(1, n_s, t, wd, sm_clock_mhz)
    h = by_q[64]

    emit("kernels", build_s=build_s, sm_clock_mhz=sm_clock_mhz,
         gather_pool={"max_abs_err": gather_err, "routes_bitwise_equal": True},
         hamming={"shape": "qsig[Q,128] sigs[4000,128] int32 (T=16, W=8)",
                  "kernel_by_q": by_q,
                  "plain": h_plain, "library": h_lib,
                  "bound_q64": h_bound, "bound_q1": h_bound_q1,
                  "bound_share_q64": h_bound["ms"] / h["ms"],
                  "carry_save_share_q64": h_bound["routes"]["carry_save"] / h["ms"],
                  "bound_share_q1": h_bound_q1["ms"] / by_q[1]["ms"],
                  "max_abs_err": ham_err})
    return gather_err, {
        "name": "hamming_distance", "route": "cuda",
        "source": "movie_recommendation_engine_tpu_torch/ops/csrc/hamming.cu",
        "replaces": "movie_recommendation_engine_tpu/ops/pallas/hamming.py:51",
        "launches": None, "max_abs_err": ham_err, "ms": h["ms"],
        "profiler_ms": h["profiler_ms"], "host_us": h["host_us"],
        "ms_q1": by_q[1]["ms"], "profiler_ms_q1": by_q[1]["profiler_ms"],
        "plain_ms": h_plain["ms"], "bound_ms": h_bound["ms"], "bound_by": h_bound["by"],
        "library_ms": h_lib["ms"]}


# ---------------------------------------------------------------------------
# gather-pool timing (after serve: input (a) is the serve phase's walk table)
# ---------------------------------------------------------------------------

def table_reuse(nbrs: np.ndarray, limit: int) -> dict:
    """How the walk table's ids repeat: valid and masked slot shares, the
    share of valid slots that the most frequent 256 / 1024 ids take, and per
    block of 8..256 consecutive output rows the valid slots per distinct id
    (the reuse a block could get from rows it has already read)."""
    valid = (nbrs >= 0) & (nbrs < limit)
    counts = np.sort(np.bincount(nbrs[valid], minlength=limit))[::-1]
    out = {"valid_share": float(valid.mean()),
           "masked_ids": sorted(int(x) for x in np.unique(nbrs[~valid]))[:4],
           "top256_share": float(counts[:256].sum() / counts.sum()),
           "top1024_share": float(counts[:1024].sum() / counts.sum())}
    for rows in (8, 32, 64, 256):
        distinct = [np.unique(blk[ok]).size for blk, ok in
                    zip(np.array_split(nbrs, range(rows, len(nbrs), rows)),
                        np.array_split(valid, range(rows, len(nbrs), rows)))]
        out[f"slots_per_distinct_{rows}"] = float(valid.sum() / sum(distinct))
        out[f"distinct_rows_{rows}"] = float(np.mean(distinct))
    return out


def gather_pool_phase(dev, walk, table_rows: int, limit: int, width: int,
                      edge_err: float) -> dict:
    """Each route of ``gather_pool`` timed on three inputs, beside the bound
    and an L2-traffic estimate: (a) the serve phase's layer-0 walk table
    with its weights normalized as ``importance_pool`` does, over a random
    [table_rows, width] bf16 table, (b) uniform ids with the sentinel in the
    last 10 of 50 slots at N = B = 4000, (c) uniform ids at the at-scale
    corpus, N = B = 59,392. Each is checked against the plain version and
    across routes; ``plan``'s pick at (a) must be the faster route. Four
    diagnostic inputs split the resident route's time (see below). Returns
    the ``kernels`` entry: the route ``plan`` picks at (a); its error is the
    largest here or at the edge shapes (``edge_err``)."""
    from movie_recommendation_engine_tpu_torch.core import roofline
    from movie_recommendation_engine_tpu_torch.ops import pool

    gen = torch.Generator(device=dev).manual_seed(1)
    nb_a, w_a = walk
    valid = nb_a < limit
    w_a = torch.where(valid, w_a, 0.0)
    wsum = w_a.sum(1, keepdim=True)
    w_a = torch.where(wsum > 0, w_a / wsum.clamp_min(1e-12), 0.0).contiguous()
    table_a = torch.randn((table_rows, width), generator=gen, device=dev).bfloat16()

    n, d, b, k = 4000, 256, 4000, 50
    table_b = torch.randn((n, d), generator=gen, device=dev).bfloat16()
    nb_b = torch.randint(0, n, (b, k), generator=gen, device=dev, dtype=torch.int32)
    nb_b[:, 40:] = n
    w_b = torch.rand((b, k), generator=gen, device=dev) * (nb_b < n)
    w_b = w_b / w_b.sum(1, keepdim=True)

    n = b = 59392
    table_c = torch.randn((n, d), generator=gen, device=dev).bfloat16()
    nb_c = torch.randint(0, n, (b, k), generator=gen, device=dev, dtype=torch.int32)
    w_c = torch.rand((b, k), generator=gen, device=dev)

    inputs = {"a_serving_walk_table": (table_a, nb_a.contiguous(), w_a, limit),
              "b_uniform_4000": (table_b, nb_b, w_b, 4000),
              "c_uniform_59392": (table_c, nb_c, w_c, 59392)}
    readings, err = {}, edge_err
    for name, (table, nbrs, w, lim) in inputs.items():
        err = max(err, check_pool_routes(pool, table, nbrs, w, lim, name))
        bb, kk = nbrs.shape
        dd = table.shape[1]
        bound = roofline.gather_pool_bound(table.shape[0], dd, bb, kk, table_bytes=2)
        r = {"shape": f"table[{table.shape[0]},{dd}] bf16, nbrs/weights[{bb},{kk}], "
                      f"limit {lim}",
             "plan": pool.plan(lim, dd, bb, kk, table.dtype)._asdict(), "bound": bound}
        for route in pool.ROUTES:
            try:
                p = pool.plan(lim, dd, bb, kk, table.dtype, route=route)
            except ValueError as e:
                r[route] = {"runs": False, "why": str(e)}
                continue
            t = timed(lambda: pool.gather_pool(table, nbrs, w, lim, route=route))
            l2 = roofline.gather_pool_l2_bytes(route, lim, dd, bb, kk, 2, p)
            r[route] = {**t, "tiling": p._asdict(), "bound_share": bound["ms"] / t["ms"],
                        "l2_bytes_estimate": l2, "l2_tb_per_s": l2 / t["ms"] / 1e9}
        readings[name] = r
    a = readings["a_serving_walk_table"]
    picked = a["plan"]["route"]
    faster = min(pool.ROUTES, key=lambda rt: a[rt]["ms"])
    check(picked == faster, f"plan picks {picked} at the serving shape, but {faster} "
                            "was faster in this run")
    check(readings["c_uniform_59392"]["plan"]["route"] == "direct",
          "plan does not send the 59,392-row table to the direct route")

    # Where the resident route's time goes, at input (b)'s shape: K = 1 (the
    # slice copy and the fixed costs, almost no gather), K = 1 on an 8-row
    # table (the fixed costs alone), an 8-row table (no slice to copy), and
    # ids that put the 4 rows of every shared-memory phase in distinct bank
    # groups (the gather without bank conflicts).
    rows = torch.arange(4000, device=dev, dtype=torch.int32)[:, None]
    free = 4 * torch.randint(0, 1000, (4000, 50), generator=gen, device=dev,
                             dtype=torch.int32) + rows % 4
    diag_inputs = {"k1": (nb_b[:, :1].contiguous(), w_b[:, :1].contiguous(), 4000),
                   "k1_rows8": ((nb_b[:, :1] % 8).contiguous(), w_b[:, :1].contiguous(), 8),
                   "rows8": (nb_b % 8, w_b, 8),
                   "conflict_free": (free.contiguous(), w_b, 4000)}
    diagnostics = {}
    for name, (nbrs, w, lim) in diag_inputs.items():
        err = max(err, check_pool_routes(pool, table_b, nbrs, w, lim, f"diagnostic {name}"))
        diagnostics[name] = {rt: cuda_ms(lambda: pool.gather_pool(table_b, nbrs, w, lim, route=rt))
                             for rt in pool.ROUTES}
    g = a[picked]
    plain = cuda_ms(lambda: pool.gather_pool_plain(table_a, nb_a, w_a, limit))
    ids, wm = nb_a.clamp(max=limit - 1).long(), w_a.bfloat16()
    lib = timed(lambda: torch.nn.functional.embedding_bag(
        ids, table_a, per_sample_weights=wm, mode="sum"))
    emit("gather_pool", readings=readings, plan_route_at_a=picked, faster_route_at_a=faster,
         plain_a=plain, library_a=lib, resident_diagnostics=diagnostics,
         walk_table=table_reuse(nb_a.cpu().numpy(), limit), max_abs_err=err)
    return {"name": "gather_pool", "route": "cuda",
            "source": "movie_recommendation_engine_tpu_torch/ops/csrc/gather_pool.cu",
            "replaces": "movie_recommendation_engine_tpu/ops/pallas/pool.py:141",
            "plan_route": picked, "launches": None, "max_abs_err": err, "ms": g["ms"],
            "profiler_ms": g["profiler_ms"], "host_us": g["host_us"],
            "plain_ms": plain["ms"], "bound_ms": a["bound"]["ms"], "bound_by": a["bound"]["by"],
            "library_ms": lib["ms"]}


# ---------------------------------------------------------------------------
# 3./4. serving
# ---------------------------------------------------------------------------

def drive_server(srv, num_movies: int, threads: int = 8, per_thread: int = 6) -> list[float]:
    """Requests by item and by history from several threads; checks that
    every answer excludes its query items. Returns client latencies (ms)."""
    lat, errors = [], []
    lock = threading.Lock()

    def client(c):
        rng = np.random.default_rng(c)
        try:
            for r in range(per_thread):
                t0 = time.perf_counter()
                if r % 2:
                    i = int(rng.integers(num_movies))
                    out, query = srv.recommend_by_item(i, k=10), {i}
                else:
                    hist = [int(x) for x in rng.choice(num_movies, 3, replace=False)]
                    out, query = srv.recommend_by_history(hist, k=10), set(hist)
                dt = (time.perf_counter() - t0) * 1e3
                ok = len(out["indices"]) == 10 and not query & set(out["indices"])
                with lock:
                    lat.append(dt)
                    if not ok:
                        errors.append(out)
        except Exception as e:  # reported by the check below
            with lock:
                errors.append(repr(e))

    ts = [threading.Thread(target=client, args=(c,)) for c in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    check(not any(t.is_alive() for t in ts), "server clients did not finish")
    check(not errors, f"bad server answers: {errors[:3]}")
    return lat


def http_roundtrip(srv, data) -> dict:
    from movie_recommendation_engine_tpu_torch.retrieval.server import make_http_server

    httpd = make_http_server(srv, "127.0.0.1", 0, movie_ids=data.movie_ids,
                             titles=data.titles)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        mid = int(data.movie_ids[5])
        with urllib.request.urlopen(f"{base}/recommend?movie_id={mid}&k=5", timeout=30) as r:
            got = json.loads(r.read())
        check(len(got["movie_ids"]) == 5 and mid not in got["movie_ids"], f"GET: {got}")
        hist = [int(m) for m in data.movie_ids[[1, 2, 3]]]
        req = urllib.request.Request(f"{base}/recommend", method="POST",
                                     data=json.dumps({"history": hist, "k": 5}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            posted = json.loads(r.read())
        check(len(posted["movie_ids"]) == 5 and not set(hist) & set(posted["movie_ids"]),
              f"POST: {posted}")
        return {"get": got["movie_ids"], "post": posted["movie_ids"]}
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)


def check_embeddings(emb: np.ndarray, shape, what: str) -> None:
    check(emb.shape == shape, f"{what}: shape {emb.shape} != {shape}")
    check(bool(np.isfinite(emb).all()), f"{what}: non-finite embeddings")
    norms = np.linalg.norm(emb, axis=1)
    check(bool(np.allclose(norms, 1.0, atol=1e-2)), f"{what}: norms {norms.min()}..{norms.max()}")


def serve_phase(dev) -> tuple[dict, tuple]:
    from movie_recommendation_engine_tpu_torch import api, default_config
    from movie_recommendation_engine_tpu_torch.ops import hamming, pool
    from movie_recommendation_engine_tpu_torch.retrieval.exact import ExactIndex

    cfg = default_config().override({
        "data.source": "synthetic", "model.pool_impl": "gather",
        "model.gather_impl": "pallas", "search.search_method": "lsh"})
    pool.LAUNCHES = 0
    hamming.LAUNCHES = 0
    t0 = time.perf_counter()
    eng = api.Engine(cfg, device=dev)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.trainer.refresh_neighborhoods()
    torch.cuda.synchronize()
    tables_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    emb = eng.embeddings()                       # host copy = sync
    first_embed_ms = (time.perf_counter() - t0) * 1e3
    check(pool.LAUNCHES == 2, f"gather_pool launched {pool.LAUNCHES} times in one "
                              "embedding pass, expected 2 (one per layer)")
    srv = eng.serve()
    try:
        srv.reset_stats()
        lat = drive_server(srv, eng.data.num_movies)
        http = http_roundtrip(srv, eng.data)
        stats = srv.stats()
    finally:
        srv.close()
    launches = {"gather_pool": pool.LAUNCHES, "hamming_distance": hamming.LAUNCHES}
    check(launches["hamming_distance"] > 0, "hamming kernel never launched while serving")
    check(stats["num_requests"] >= 32, f"only {stats['num_requests']} requests answered")
    check_embeddings(emb, (eng.data.num_movies, cfg.model.embed_dim), "serve")

    # Warm embedding passes (after the counted run).
    def embed():
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.trainer.movie_embeddings()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3
    embed_ms = statistics.median(embed() for _ in range(7))
    # The same pass with the torch gather + einsum formulation (what
    # gather_impl="auto" resolves to), for the kernel-vs-auto comparison.
    eng.trainer.gather_impl = "xla"
    embed_ms_xla = statistics.median(embed() for _ in range(7))
    eng.trainer.gather_impl = "pallas"

    # LSH recall@10 against exact search, 256 movie queries.
    qi = np.random.default_rng(0).choice(emb.shape[0], 256, replace=False)
    exact = ExactIndex(emb.shape[1], device=dev)
    exact.build(emb)
    _, ei = exact.search(emb[qi], 10)
    _, li = srv.index.search(emb[qi], 10)
    ei, li = ei.cpu().numpy(), li.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ei, li)]))
    # Where the time goes in one embedding pass and in one search of the
    # largest (64) and smallest (1) batch bucket, at the server's search_k.
    sk = srv._search_k
    profiles = {"embed": device_profile(eng.trainer.movie_embeddings, 10),
                "search_q64": device_profile(lambda: srv.index.search(emb[qi[:64]], sk)[1].cpu()),
                "search_q1": device_profile(lambda: srv.index.search(emb[qi[:1]], sk)[1].cpu())}
    out = {"init_s": init_s, "tables_ms": tables_ms, "first_embed_ms": first_embed_ms,
           "embed_ms": embed_ms, "embed_ms_xla": embed_ms_xla,
           "requests": stats["num_requests"],
           "batches": stats["num_batches"], "mean_batch": stats["mean_batch_size"],
           "latency_ms_p50": stats["latency_ms_p50"], "latency_ms_p99": stats["latency_ms_p99"],
           "client_ms_p50": float(np.percentile(lat, 50)),
           "client_ms_p99": float(np.percentile(lat, 99)),
           "lsh_recall_at_10": recall, "launches": launches, "http": http,
           "profiles": profiles,
           "num_movies": eng.data.num_movies, "num_edges": eng.trainer.csr.num_edges}
    emit("serve", **out)
    # Layer 0's walk table and the shape of the table it pools, for the
    # gather-pool timing.
    return launches, (eng.trainer.nbr_tables[0], eng.trainer.table_rows,
                      eng.trainer.valid_limit, cfg.model.hidden_dim)


def serve_default_phase(dev) -> None:
    from movie_recommendation_engine_tpu_torch import api, default_config

    cfg = default_config().override({"data.source": "synthetic"})
    eng = api.Engine(cfg, device=dev)
    t0 = time.perf_counter()
    emb = eng.embeddings()
    embed_ms = (time.perf_counter() - t0) * 1e3
    check(len(eng.trainer.pool_mats) == cfg.model.num_layers, "dense rung not selected")
    dense_embed = device_profile(eng.trainer.movie_embeddings, 10)
    check_embeddings(emb, (eng.data.num_movies, cfg.model.embed_dim), "serve_default")
    srv = eng.serve()
    try:
        lat = drive_server(srv, eng.data.num_movies, threads=4, per_thread=4)
        stats = srv.stats()
    finally:
        srv.close()
    mid = int(eng.data.movie_ids[3])
    recs = eng.recommend(movie_id=mid, k=5)
    check(len(recs) == 5 and all(r["movieId"] != mid for r in recs), "recommend")
    emit("serve_default", method=srv.method, pool="dense", first_embed_ms=embed_ms,
         embed_profile=dense_embed,
         requests=stats["num_requests"], latency_ms_p50=stats["latency_ms_p50"],
         latency_ms_p99=stats["latency_ms_p99"], client_ms_p50=float(np.median(lat)),
         metrics=eng.evaluate())


# ---------------------------------------------------------------------------
# 6. training
# ---------------------------------------------------------------------------

def zero_launches() -> None:
    from movie_recommendation_engine_tpu_torch.ops import pool

    pool.LAUNCHES = pool.BWD_LAUNCHES = pool.SEGMENT_LAUNCHES = pool.PLAN_LAUNCHES = 0


def read_launches() -> dict:
    from movie_recommendation_engine_tpu_torch.ops import pool

    return {"gather_pool": pool.LAUNCHES, "gather_pool_bwd": pool.BWD_LAUNCHES,
            "gather_pool_bwd_segment": pool.SEGMENT_LAUNCHES, "segment_plan": pool.PLAN_LAUNCHES}


def fit_config(dev, overrides: dict, ckpt_dir: str) -> tuple:
    """``Engine.fit`` for 2 epochs at the default width; the kernel counts
    are zeroed just before and read just after. Checks a finite loss, the
    curriculum's hard negative at epoch 1, and that ``last_model`` reloads
    into a fresh trainer and evaluates (on the same tables) to the same
    HR@k."""
    from movie_recommendation_engine_tpu_torch import api, default_config
    from movie_recommendation_engine_tpu_torch.train.trainer import Trainer

    cfg = default_config().override({"data.source": "synthetic", "train.epochs": 2,
                                     "paths.checkpoint_dir": ckpt_dir, **overrides})
    eng = api.Engine(cfg, device=dev)
    zero_launches()
    t0 = time.perf_counter()
    out = eng.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    hist = out["history"]
    check(len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist), f"train loss {hist}")
    check([h["num_hard"] for h in hist] == [0, 1], "curriculum hard negatives")
    tr = eng.trainer
    last = os.path.join(ckpt_dir, "last_model")
    check(os.path.exists(last + ".npz"), "last_model not written")
    again = Trainer(cfg, eng.data, device=dev)
    again.load_checkpoint(last)
    again.set_neighborhood_tables(tr.nbr_tables)
    ref, got = tr.evaluate(tr.val_pairs), again.evaluate(tr.val_pairs)
    hr = {k: v for k, v in ref.items() if k.startswith("hit_rate")}
    check(all(got[k] == v for k, v in hr.items()), f"reloaded model: {got} != {ref}")
    check(again.epoch == 2 and again.opt_state.step == tr.opt_state.step, "reloaded state")
    summary = {"fit_s": fit_s, "adam_steps": tr.opt_state.step, "launches": launches,
               "history": [{k: h[k] for k in ("loss", "num_hard", "examples_per_sec",
                                               "step_wall_seconds", "refresh_seconds",
                                               "val_hit_rate@10")} for h in hist],
               "reloaded_hit_rates": hr}
    return eng, summary


def copy_state(params, opt):
    from movie_recommendation_engine_tpu_torch.core import tree
    from movie_recommendation_engine_tpu_torch.train import optim

    clone = lambda t: tree.map_tree(lambda x: x.detach().clone(), t)  # noqa: E731
    return clone(params), optim.AdamState(opt.step, clone(opt.mu), clone(opt.nu))


def step_kernel_vs_xla(tr, q, p) -> dict:
    """One step through the kernels and one through the torch gather
    (``gather_impl=xla``), float32 compute, from the same params, optimizer
    state, tables and draws (negatives and keep masks). Loss within 1e-5
    relative and gradients within 1e-4 relative norm (the kernels sum in
    another order than the torch gather and its autograd). Updated params:
    Adam divides each gradient
    element by its own size, so an element whose gradient is within rounding
    of zero may step apart by up to 2 lr; all are within that, and at most
    1e-4 of them differ by more than 1e-5."""
    from movie_recommendation_engine_tpu_torch.core import tree
    from movie_recommendation_engine_tpu_torch.train.trainer import StepDraws

    lr = tr.plateau.lr
    dtype0, impl0 = tr.compute_dtype, tr.gather_impl
    tr.compute_dtype = torch.float32
    d = tr.draw_step(q, num_hard=1)
    keep = [torch.rand((tr.table_rows, tr.cfg.model.hidden_dim), generator=tr.generator,
                       device=q.device) < 1 - tr.cfg.model.dropout]
    draws = [StepDraws(d.random, d.hard, keep)]
    params0, opt0 = tr.params, tr.opt_state
    res = {}
    for impl in ("pallas", "xla"):
        tr.params, tr.opt_state = copy_state(params0, opt0)
        tr.gather_impl = impl
        loss, grads = tr.loss_and_grads(q, p, draws[0], 1.0)
        tr.train_steps(q[None], p[None], lr, 1.0, 1, draws=draws)
        res[impl] = (loss.item(), tree.flatten(grads), tree.flatten(tr.params))
    tr.params, tr.opt_state = params0, opt0
    tr.compute_dtype, tr.gather_impl = dtype0, impl0
    (lk, gk, pk), (lx, gx, px) = res["pallas"], res["xla"]
    loss_rel = abs(lk - lx) / abs(lx)
    grad_rel = max(float((gk[k] - gx[k]).norm() / gx[k].norm().clamp_min(1e-30)) for k in gk)
    diffs = torch.cat([(pk[k] - px[k]).abs().reshape(-1) for k in pk])
    over = int((diffs > 1e-5).sum())
    out = {"loss_kernel": lk, "loss_xla": lx, "loss_rel_diff": loss_rel,
           "grad_max_rel_norm_diff": grad_rel, "param_max_abs_diff": float(diffs.max()),
           "params_over_1e-5": over, "params": int(diffs.numel()), "lr": lr}
    check(loss_rel <= 1e-5, f"kernel vs xla step loss: {out}")
    check(grad_rel <= 1e-4, f"kernel vs xla gradients: {out}")
    check(float(diffs.max()) <= 2 * lr and over <= 1e-4 * diffs.numel(),
          f"kernel vs xla updated params: {out}")
    return out


def bwd_inputs(gen, tr, rows, limit, dtype):
    """A step's gather-pool inputs: the walk table's rows ``rows`` with the
    weights masked and renormalized as ``importance_pool`` does, a random
    [N, hidden] table of ``dtype`` and a random f32 cotangent."""
    nbrs, w = tr.nbr_tables[0]
    nbrs, w = nbrs[rows].contiguous(), w[rows]
    w = torch.where(nbrs < limit, w, 0.0)
    wsum = w.sum(1, keepdim=True)
    w = torch.where(wsum > 0, w / wsum.clamp_min(1e-12), 0.0).contiguous()
    table = torch.randn((tr.table_rows, tr.cfg.model.hidden_dim), generator=gen,
                        device=nbrs.device).to(dtype)
    g = torch.randn((nbrs.shape[0], table.shape[1]), generator=gen, device=nbrs.device)
    return table, nbrs, w, g


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality (floats compared as their bit patterns)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in ints:
        return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))
    return torch.equal(a, b)


def check_bwd(pool, table, nbrs, w, limit, g, what: str, route: str) -> dict:
    """One route of the backward against ``gather_pool_bwd_plain``: a f32
    d_table within 1e-4 (sums in another order; the atomic route's in a
    run-dependent one), a bf16 one within one bf16 step of the plain
    version's, or within 1e-4 where the sum cancels (a result so small that
    the two f32 sums' rounding exceeds its bf16 step), d_w within 1e-4."""
    d_t, d_w = pool.gather_pool_bwd(table, nbrs, w, limit, g, route=route)
    r_t, r_w = pool.gather_pool_bwd_plain(table, nbrs, w, limit, g)
    torch.cuda.synchronize()
    err_t = (d_t.float() - r_t.float()).abs()
    err_w = float((d_w - r_w).abs().max())
    out = {"d_w_max_abs_err": err_w, "d_table_max_abs_err": float(err_t.max())}
    if table.dtype == torch.bfloat16:
        step = torch.ldexp(torch.ones_like(r_t.float()),
                           torch.frexp(r_t.float()).exponent - 8)
        over = err_t > step
        out["d_table_over_one_step"] = int(over.sum())
        out["d_table_over_one_step_max_abs_ref"] = (
            float(r_t.float().abs()[over].max()) if over.any() else 0.0)
        check(bool((err_t[over] <= 1e-4).all()),
              f"gather_pool_bwd {route} {what}: bf16 d_table beyond one step: {out}")
    else:
        check(out["d_table_max_abs_err"] <= 1e-4, f"gather_pool_bwd {route} {what}: {out}")
    check(err_w <= 1e-4, f"gather_pool_bwd {route} {what}: d_w {err_w}")
    return out


def check_segment(pool, table, nbrs, w, limit, g, what: str) -> float:
    """The plan kernel's chunks, splits and totals equal to
    ``segment_plan_plain``'s from the same row pointers; the segment route's
    d_table, from a layout built ahead and from one built by the call,
    bitwise equal to ``gather_pool_bwd_segment_plain`` and the calls
    bitwise equal to each other. Returns the largest |kernel - plain| (0
    when bitwise equal)."""
    lay = pool.segment_layout(nbrs, limit)
    plan = pool.segment_plan_plain(lay.row_ptr, lay.chunk, lay.chunks.shape[0],
                                   lay.splits.shape[0])
    c, s, _ = plan[2].tolist()
    check(torch.equal(lay.totals, plan[2]) and torch.equal(lay.chunks[:c], plan[0][:c])
          and torch.equal(lay.splits[:s], plan[1][:s]),
          f"segment plan kernel {what}: differs from segment_plan_plain")
    outs = [pool.gather_pool_bwd(table, nbrs, w, limit, g, need_weights=False, layout=lay)[0]
            for _ in range(2)]
    outs.append(pool.gather_pool_bwd(table, nbrs, w, limit, g, need_weights=False)[0])
    ref = pool.gather_pool_bwd_segment_plain(table, nbrs, w, limit, g, lay)
    torch.cuda.synchronize()
    check(all(same_bits(o, outs[0]) for o in outs),
          f"gather_pool_bwd segment {what}: two calls differ")
    err = float((outs[0].float() - ref.float()).abs().max()) if ref.numel() else 0.0
    check(same_bits(outs[0], ref),
          f"gather_pool_bwd segment {what}: not bitwise equal to its plain version "
          f"(max abs err {err})")
    return err


def first_divergent_op(fn) -> dict:
    """Runs ``fn`` twice under a dispatch mode that keeps a copy of every
    aten op's tensor outputs (``empty*`` skipped: their values are whatever
    the memory held) and returns the first op whose outputs differ bitwise
    between the runs, or None, with the count of ops recorded. The kernels
    called through ctypes are not aten ops: their outputs show in the first
    op that reads them."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.outs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if "empty" not in func.__name__:
                self.outs.append((str(func), [t.detach().clone() for t in tree_flatten(out)[0]
                                              if isinstance(t, torch.Tensor)]))
            return out

    runs = []
    for _ in range(2):
        with Record() as rec:
            fn()
        torch.cuda.synchronize()
        runs.append(rec.outs)
    first = next(({"index": i, "op": a[0]} for i, (a, b) in enumerate(zip(*runs))
                  if a[0] != b[0] or not all(same_bits(x, y) for x, y in zip(a[1], b[1]))),
                 None)
    return {"ops_recorded": [len(r) for r in runs], "first": first}


def step_determinism(tr, q, p) -> dict:
    """Two identical steps through the kernels at the trainer's compute
    dtype (same params, optimizer state, tables and draws): whether the
    loss, the gradients and the updated params are bitwise equal, which
    leaves differ, and, if any do, the first op whose outputs differ.
    Reported, not gated: ops of the step beyond the backward kernel (cuBLAS,
    PyTorch's index kernels) decide it too."""
    from movie_recommendation_engine_tpu_torch.core import tree
    from movie_recommendation_engine_tpu_torch.train.trainer import StepDraws

    d = tr.draw_step(q, num_hard=1)
    keep = [torch.rand((tr.table_rows, tr.cfg.model.hidden_dim), generator=tr.generator,
                       device=q.device) < 1 - tr.cfg.model.dropout]
    draws = [StepDraws(d.random, d.hard, keep)]
    params0, opt0 = tr.params, tr.opt_state

    def step():
        tr.params, tr.opt_state = copy_state(params0, opt0)
        loss, grads = tr.loss_and_grads(q, p, draws[0], 1.0)
        tr.train_steps(q[None], p[None], tr.plateau.lr, 1.0, 1, draws=draws)
        return loss, tree.flatten(grads), tree.flatten(tr.params)

    (la, ga, pa), (lb, gb, pb) = step(), step()
    out = {"compute_dtype": str(tr.compute_dtype), "loss_bitwise_equal": same_bits(la, lb),
           "grads_differ": [k for k in ga if not same_bits(ga[k], gb[k])],
           "params_differ": [k for k in pa if not same_bits(pa[k], pb[k])]}
    out["grads_bitwise_equal"] = not out["grads_differ"]
    out["params_bitwise_equal"] = not out["params_differ"]
    if not (out["loss_bitwise_equal"] and out["grads_bitwise_equal"]
            and out["params_bitwise_equal"]):
        out["first_divergent_op"] = first_divergent_op(step)
    tr.params, tr.opt_state = params0, opt0
    return out


def train_phase(dev) -> tuple[dict, dict]:
    """Returns the ``gather_pool_bwd`` entry of the kernels line and the
    train path's launch counts."""
    from movie_recommendation_engine_tpu_torch.core import roofline
    from movie_recommendation_engine_tpu_torch.ops import pool

    with tempfile.TemporaryDirectory() as d_gather, tempfile.TemporaryDirectory() as d_dense:
        eng, gather_fit = fit_config(dev, {"model.pool_impl": "gather",
                                           "model.gather_impl": "pallas"}, d_gather)
        launches = gather_fit["launches"]
        steps = gather_fit["adam_steps"]
        check(launches["gather_pool_bwd"] == launches["gather_pool_bwd_segment"] == 2 * steps,
              f"gather_pool_bwd launched {launches} in {steps} steps: expected 2 a step, "
              "all on the segment route")
        check(launches["segment_plan"] >= steps,
              f"the segment plan kernel launched {launches['segment_plan']} times in {steps} "
              "steps: expected one a step (the batch layer) and one a table refresh")
        check(launches["gather_pool"] == 2 * steps + 2 * 2,
              f"gather_pool launched {launches['gather_pool']} times in {steps} steps "
              "and 2 validation passes")
        dense_eng, dense_fit = fit_config(dev, {}, d_dense)
        check(len(dense_eng.trainer.pool_mats) == 2 and dense_fit["launches"]["gather_pool"] == 0,
              "default config did not train on the dense rung")
    tr = eng.trainer
    check(tr.bwd_layouts is not None and tr.bwd_layouts[0] is not None,
          "the gather config's trainer built no backward layout for layer 0")
    pairs = tr._epoch_pairs(np.random.default_rng(0))
    q = torch.as_tensor(pairs[0, :, 0], dtype=torch.int32, device=dev)
    p = torch.as_tensor(pairs[0, :, 1], dtype=torch.int32, device=dev)
    xcheck = step_kernel_vs_xla(tr, q, p)
    determinism = step_determinism(tr, q, p)

    # The step: wall time of single steps (host clock, synchronized), device
    # time and busy share over a profiled window, at epoch 1 (one hard
    # negative per query: B = 2 * 512 + 500 + 512 in the batch layer).
    def step_ms(trainer):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_steps(q[None], p[None], trainer.plateau.lr, 1.0, 1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    steps_out = {}
    for name, trainer in (("gather_kernels", tr), ("dense_default", dense_eng.trainer)):
        walls = [step_ms(trainer) for _ in range(11)]
        prof = device_profile(lambda: trainer.train_steps(q[None], p[None], trainer.plateau.lr,
                                                          1.0, 1), calls=5)
        med = statistics.median(walls[1:])
        steps_out[name] = {"step_wall_ms_median": med, "step_wall_ms": walls,
                           "examples_per_sec": q.shape[0] / med * 1e3, "profile": prof,
                           # The profiler slows the host: busy share of the
                           # unprofiled step as well.
                           "busy_share_of_median_wall": (prof["device_ms"] or 0.0) / med}

    # The backward at the step's shapes: layer 0 (B = N = 3980) and the batch
    # layer at epoch 0 (B = 1524) and with six hard negatives (B = 4596,
    # batch nodes drawn over the movies). Both routes against
    # gather_pool_bwd_plain; the segment route bitwise against its own plain
    # version and from call to call.
    gen = torch.Generator(device=dev).manual_seed(2)
    limit, n = tr.valid_limit, tr.table_rows
    shapes = {"layer0_b3980": torch.arange(n, device=dev),
              "batch_b1524": torch.randint(0, n, (1524,), generator=gen, device=dev),
              "batch_b4596": torch.randint(0, n, (4596,), generator=gen, device=dev)}
    checks, timings, inputs, seg_err = {}, {}, {}, 0.0
    for name, rows in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            table, nbrs, w, g = bwd_inputs(gen, tr, rows, limit, dtype)
            what = f"{name}_{str(dtype)[6:]}"
            checks[what] = {rt: check_bwd(pool, table, nbrs, w, limit, g, what, rt)
                            for rt in pool.BWD_ROUTES}
            seg_err = max(seg_err, check_segment(pool, table, nbrs, w, limit, g, what))
            if dtype == torch.bfloat16:
                inputs[name] = (table, nbrs, w, g)
    # Edge shapes: the scalar path (D not a multiple of 4) in both dtypes, K
    # above one warp, valid_limit below N (rows past it written as zeros),
    # ids outside [0, limit).
    for n_e, d_e, b_e, k_e, lim_e, dt_e in [(96, 128, 19, 11, 96, torch.float32),
                                            (37, 100, 7, 6, 30, torch.bfloat16),
                                            (29, 37, 5, 70, 29, torch.float32),
                                            (29, 37, 5, 70, 29, torch.bfloat16),
                                            (500, 64, 300, 70, 450, torch.bfloat16)]:
        table, nbrs, w = pool_inputs(gen, n_e, d_e, b_e, k_e, lim_e, dt_e, dev)
        g = torch.randn((b_e, d_e), generator=gen, device=dev)
        name = f"edge_{n_e}x{d_e}_b{b_e}_k{k_e}_{str(dt_e)[6:]}"
        checks[name] = {rt: check_bwd(pool, table, nbrs, w, lim_e, g, name, rt)
                        for rt in pool.BWD_ROUTES}
        seg_err = max(seg_err, check_segment(pool, table, nbrs, w, lim_e, g, name))

    def bwd_times(table, nbrs, w, g, what: str) -> dict:
        """Both routes' d_table: the segment kernel with its layout built
        ahead (layer 0's case in the step), the segment route's whole call
        with the layout built in it (the batch layer's case), the layout
        alone, and the atomic route; bounds and L2-byte estimates."""
        b, k = nbrs.shape
        valid = int(((nbrs >= 0) & (nbrs < limit)).sum())
        lay = pool.segment_layout(nbrs, limit)
        bound = roofline.gather_pool_bwd_bound(n, table.shape[1], b, k, 2, valid_slots=valid)
        seg = timed(lambda: pool.gather_pool_bwd(table, nbrs, w, limit, g, need_weights=False,
                                                 layout=lay))
        # The atomic route launches three kernels: the f32 zero fill, the
        # kernel, the cast to the table's dtype.
        atomic = timed(lambda: pool.gather_pool_bwd(table, nbrs, w, limit, g,
                                                    need_weights=False, route="atomic"),
                       kernels=3)
        # 20 calls, not 50: 50 calls of ~20 kernels each fill the card's
        # launch queue behind the spin, and the host then blocks in it. The
        # layout launches 20 kernels (measured on one H100), the call more.
        whole = timed(lambda: pool.gather_pool_bwd(table, nbrs, w, limit, g,
                                                   need_weights=False), iters=20, kernels=20)
        layout = timed(lambda: pool.segment_layout(nbrs, limit), iters=20, kernels=20)
        layout["top"] = device_profile(lambda: pool.segment_layout(nbrs, limit), 10)["top"]
        chunks, splits, parts = lay.totals.tolist()
        l2 = {rt: roofline.gather_pool_bwd_l2_bytes(rt, n, table.shape[1], b, k, 2, valid,
                                                    chunks, parts)
              for rt in pool.BWD_ROUTES}
        return {"shape": f"table[{n},{table.shape[1]}] bf16, nbrs/weights[{b},{k}], "
                         f"g[{b},{table.shape[1]}] f32 ({what})",
                "valid_slots": valid, "chunks": chunks, "split_rows": splits, "parts": parts,
                "bound": bound,
                "segment": {**seg, "bound_share": bound["ms"] / seg["ms"],
                            "l2_bytes_estimate": l2["segment"],
                            "l2_tb_per_s": l2["segment"] / seg["ms"] / 1e9},
                "segment_with_layout_per_call": whole, "layout": layout,
                "atomic": {**atomic, "bound_share": bound["ms"] / atomic["ms"],
                           "l2_bytes_estimate": l2["atomic"],
                           "l2_tb_per_s": l2["atomic"] / atomic["ms"] / 1e9}}

    for name in ("layer0_b3980", "batch_b1524"):
        table, nbrs, w, g = inputs[name]
        t = bwd_times(table, nbrs, w, g, "the walk table's rows")
        lay = pool.segment_layout(nbrs, limit)
        t["plain_segment"] = cuda_ms(lambda: pool.gather_pool_bwd_segment_plain(
            table, nbrs, w, limit, g, lay), iters=5)
        t["plain_index_add"] = cuda_ms(lambda: pool.gather_pool_bwd_plain(
            table, nbrs, w, limit, g, need_weights=False), iters=10)
        # Library yardstick: embedding_bag(mode="sum", per_sample_weights)'s
        # backward in the table, through torch.autograd.grad (bf16, as the
        # table: the library takes one dtype for the table and the weights).
        tb = table.detach().clone().requires_grad_()
        ids = nbrs.clamp(0, limit - 1).long()
        bag = torch.nn.functional.embedding_bag(ids, tb, per_sample_weights=w.to(table.dtype),
                                                mode="sum")
        gb = g.to(table.dtype)
        t["library"] = timed(lambda: torch.autograd.grad(bag, tb, gb, retain_graph=True))
        timings[name] = t
    # Diagnostic: layer 0's shape with uniform ids, all valid (no hub rows):
    # how much of each route's time is the ids' skew.
    table, nbrs, w, g = inputs["layer0_b3980"]
    uniform = torch.randint(0, limit, nbrs.shape, generator=gen, device=dev, dtype=torch.int32)
    timings["layer0_uniform_ids"] = bwd_times(table, uniform, w, g, "uniform ids")
    emit("train", gather=gather_fit, dense=dense_fit, step_kernel_vs_xla=xcheck,
         step_determinism=determinism, steps=steps_out, bwd_checks=checks,
         bwd_segment_bitwise=True, bwd_timings=timings,
         tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
               "cudnn": torch.backends.cudnn.allow_tf32})
    a, bl = timings["layer0_b3980"], timings["batch_b1524"]
    err_plain = max(c["segment"]["d_table_max_abs_err"] for c in checks.values())
    return {"name": "gather_pool_bwd", "route": "cuda", "plan_route": "segment",
            "source": "movie_recommendation_engine_tpu_torch/ops/csrc/gather_pool_bwd_segment.cu",
            "replaces": "movie_recommendation_engine_tpu/ops/pallas/pool.py:229",
            "launches": launches["gather_pool_bwd"],
            "launches_segment": launches["gather_pool_bwd_segment"],
            "launches_plan": launches["segment_plan"],
            "max_abs_err": seg_err, "max_abs_err_vs_index_add": err_plain,
            "ms": a["segment"]["ms"], "profiler_ms": a["segment"]["profiler_ms"],
            "host_us": a["segment"]["host_us"], "layout_ms": a["layout"]["ms"],
            "atomic_ms": a["atomic"]["ms"],
            "ms_batch_b1524": bl["segment_with_layout_per_call"]["ms"],
            "atomic_ms_batch_b1524": bl["atomic"]["ms"],
            "plain_ms": a["plain_segment"]["ms"], "bound_ms": a["bound"]["ms"],
            "bound_by": a["bound"]["by"], "library_ms": a["library"]["ms"]}, launches


# ---------------------------------------------------------------------------
# 7. the at-scale rung: pool_impl=auto above 32,768 rows (hub, hubbed final)
# ---------------------------------------------------------------------------

# The synthetic loader keeps the movies that some user rated: 61,480 movies
# and 3M ratings leave 59,393 (the ML-25M-sized corpus of the JAX package's
# at-scale figure is 59,392 rows).
HUB_CORPUS = {"data.synthetic_num_movies": 61480, "data.synthetic_num_users": 60000,
              "data.synthetic_num_ratings": 3_000_000}


def popularity_tables(seed: int, num_movies: int, k: int = 50,
                      feature_dim: int = 128) -> list:
    """The two walk tables of ``bench.py:_setup_numpy(seed, num_movies,
    popularity=True)`` (a copy: numpy only): 60% of the slots drawn from a
    Pareto(1.2) popularity, the rest uniform, weights ~ popularity^0.45 x
    lognormal(2.0), rows normalized. The features it draws first are drawn
    and dropped, so the stream is the same."""
    rng = np.random.default_rng(seed)
    rng.standard_normal((num_movies, feature_dim))
    pop = rng.pareto(1.2, size=num_movies) + 1.0
    pop /= pop.sum()
    tables = []
    for _ in range(2):
        mix = rng.random((num_movies, k)) < 0.60
        nb = np.where(mix, rng.choice(num_movies, size=(num_movies, k), p=pop),
                      rng.integers(0, num_movies, (num_movies, k))).astype(np.int32)
        w = ((pop[nb] * num_movies) ** 0.45
             * rng.lognormal(0.0, 2.0, size=(num_movies, k))).astype(np.float32)
        w /= w.sum(axis=1, keepdims=True)
        tables.append((nb, w))
    return tables


def hub_kernel_times(dev, hp, n: int, d: int, rows, what: str) -> dict:
    """Both kernels at a hub residual's shape (K = 8, valid limit N): the
    forward against its plain version (1e-4), the segment backward bitwise
    against its plain version, both timed beside their bounds, their plain
    versions and ``embedding_bag`` (forward, and its backward in the
    table); the segment layout's row 0, where the padding slots go."""
    from movie_recommendation_engine_tpu_torch.core import roofline
    from movie_recommendation_engine_tpu_torch.ops import pool

    gen = torch.Generator(device=dev).manual_seed(3)
    nbrs, w = hp.res_nbrs[rows].contiguous(), hp.res_w[rows].contiguous()
    b, k = nbrs.shape
    table = torch.randn((n, d), generator=gen, device=dev).bfloat16()
    g = torch.randn((b, d), generator=gen, device=dev)
    fwd_err = check_pool_routes(pool, table, nbrs, w, n, what)
    bwd_err = check_segment(pool, table, nbrs, w, n, g, what)
    vs_index_add = check_bwd(pool, table, nbrs, w, n, g, what, "segment")
    lay = pool.segment_layout(nbrs, n)
    chunks, splits, parts = lay.totals.tolist()
    fwd = timed(lambda: pool.gather_pool(table, nbrs, w, n))
    seg = timed(lambda: pool.gather_pool_bwd(table, nbrs, w, n, g, need_weights=False,
                                             layout=lay))
    whole = timed(lambda: pool.gather_pool_bwd(table, nbrs, w, n, g, need_weights=False),
                  iters=20, kernels=20)
    ids = nbrs.long()
    lib = timed(lambda: torch.nn.functional.embedding_bag(ids, table, per_sample_weights=w.bfloat16(),
                                                          mode="sum"))
    tb = table.detach().clone().requires_grad_()
    bag = torch.nn.functional.embedding_bag(ids, tb, per_sample_weights=w.bfloat16(), mode="sum")
    gb = g.bfloat16()
    lib_bwd = timed(lambda: torch.autograd.grad(bag, tb, gb, retain_graph=True))
    # The forward reads only the rows its ids reach; the backward writes
    # all N rows of d_table.
    reached = int(torch.unique(nbrs).numel())
    fb = roofline.gather_pool_bound(reached, d, b, k, table_bytes=2)
    bb = roofline.gather_pool_bwd_bound(n, d, b, k, 2, valid_slots=b * k)
    return {"shape": f"table[{n},{d}] bf16, res_nbrs/res_w[{b},{k}], limit {n}",
            "rows_reached": reached,
            "forward": {**fwd, "bound": fb, "bound_share": fb["ms"] / fwd["ms"],
                        "plain": cuda_ms(lambda: pool.gather_pool_plain(table, nbrs, w, n),
                                         iters=10),
                        "library": lib, "max_abs_err": fwd_err},
            "backward": {"segment": {**seg, "bound_share": bb["ms"] / seg["ms"]},
                         "segment_with_layout_per_call": whole, "bound": bb,
                         "plain_segment": cuda_ms(lambda: pool.gather_pool_bwd_segment_plain(
                             table, nbrs, w, n, g, lay), iters=3),
                         "plain_index_add": cuda_ms(lambda: pool.gather_pool_bwd_plain(
                             table, nbrs, w, n, g, need_weights=False), iters=5),
                         "library": lib_bwd, "max_abs_err_vs_plain_segment": bwd_err,
                         "vs_index_add": vs_index_add,
                         "chunks": chunks, "split_rows": splits, "parts": parts,
                         "row0_slots": int(lay.row_ptr[1] - lay.row_ptr[0]),
                         "row0_chunks": int((lay.chunks[:chunks, 0] == 0).sum())}}


def train_hub_phase(dev) -> tuple[dict, dict]:
    """The at-scale rung at full width (features 128, hidden 256, embed 128,
    2 layers, K = 50, batch 512, 500 shared negatives, NCE, bf16): an
    ``api.Engine`` on the 59,393-movie synthetic corpus with the default
    ``pool_impl=auto`` and ``gather_impl=pallas``, its walk tables replaced
    (``set_neighborhood_tables``) by the popularity tables of the JAX
    package's at-scale figure. The trainer must pick the hub rung with the
    final layer hubbed (``hubf``) itself. Reports the build, one embedding
    pass (the serving path), train steps at 0 and 6 hard negatives (wall,
    device time, kernels, busy share) with the launch counts zeroed just
    before and read just after, two identical steps compared bit for bit, a
    kernel step against an ``xla`` step in f32, one step each of the gather
    and hybrid rungs on the same tables and draws (not gated), and both
    kernels at the hub residual's shapes. Returns the kernels line's extra
    fields for ``gather_pool`` and ``gather_pool_bwd``."""
    import gc

    from movie_recommendation_engine_tpu_torch import api, default_config
    from movie_recommendation_engine_tpu_torch.models import pinsage
    from movie_recommendation_engine_tpu_torch.ops.hub_pool import HubPool
    from movie_recommendation_engine_tpu_torch.train.trainer import StepDraws

    cfg = default_config().override({"data.source": "synthetic", "model.gather_impl": "pallas",
                                     **HUB_CORPUS})
    t0 = time.perf_counter()
    eng = api.Engine(cfg, device=dev)
    init_s = time.perf_counter() - t0
    tr = eng.trainer
    n, hidden = tr.table_rows, cfg.model.hidden_dim
    check(n > cfg.model.dense_pool_hybrid_max_rows,
          f"{n} table rows: not above the hybrid rung's {cfg.model.dense_pool_hybrid_max_rows}")
    tables = popularity_tables(2, n)
    t0 = time.perf_counter()
    tr.set_neighborhood_tables(tables)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    check(len(tr.pool_mats) == 2 and all(isinstance(pm, HubPool) for pm in tr.pool_mats),
          f"pool_impl=auto at {n} rows built {[type(pm).__name__ for pm in tr.pool_mats]}, "
          "expected two HubPools (hubf)")
    builds = [{k: v for k, v in e.items() if k != "time"} for e in tr.log.history
              if e["event"].startswith(("hub_pool", "block_"))]
    slab = {"dtype": str(tr.pool_mats[0].a_head.dtype),
            "shape": list(tr.pool_mats[0].a_head.shape),
            "bytes_both": sum(pm.a_head.numel() * pm.a_head.element_size()
                              for pm in tr.pool_mats)}

    # The serving path: one embedding pass through both hub layers.
    zero_launches()
    t0 = time.perf_counter()
    emb = eng.embeddings()
    first_embed_ms = (time.perf_counter() - t0) * 1e3
    embed_launches = read_launches()
    check(embed_launches["gather_pool"] == 2,
          f"one embedding pass launched gather_pool {embed_launches['gather_pool']} times, "
          "expected 2 (the two hub residuals)")
    check_embeddings(emb, (n, cfg.model.embed_dim), "train_hub embeddings")
    recs = eng.recommend(movie_id=int(eng.data.movie_ids[3]), k=5)
    check(len(recs) == 5, "recommend at the hub rung")

    def embed():
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.movie_embeddings()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3
    embed_ms = statistics.median(embed() for _ in range(5))
    embed_prof = device_profile(tr.movie_embeddings, 5)

    pairs = tr._epoch_pairs(np.random.default_rng(0))
    q = torch.as_tensor(pairs[0, :, 0], dtype=torch.int32, device=dev)
    p = torch.as_tensor(pairs[0, :, 1], dtype=torch.int32, device=dev)

    def step_ms(num_hard, draws=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.train_steps(q[None], p[None], tr.plateau.lr, 1.0, num_hard, draws=draws)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def step_reading(num_hard, draws=None, walls_n=11, calls=3):
        walls = [step_ms(num_hard, draws) for _ in range(walls_n)]
        prof = device_profile(lambda: tr.train_steps(q[None], p[None], tr.plateau.lr, 1.0,
                                                     num_hard, draws=draws), calls=calls)
        med = statistics.median(walls[1:])
        # device_profile runs one step, then a warm-up cycle, then its window.
        return {"step_wall_ms_median": med, "step_wall_ms": walls, "profile": prof,
                "examples_per_sec": q.shape[0] / med * 1e3,
                "busy_share_of_median_wall": (prof["device_ms"] or 0.0) / med}, \
            walls_n + 2 * calls + 1

    zero_launches()
    steps, n_steps = {}, 0
    for num_hard in (0, 6):
        steps[f"hard{num_hard}"], m = step_reading(num_hard)
        n_steps += m
    launches = read_launches()
    check(launches["gather_pool"] == launches["gather_pool_bwd_segment"]
          == launches["gather_pool_bwd"] == 2 * n_steps,
          f"hub steps: launches {launches} in {n_steps} steps, expected 2 forward and 2 "
          "segment backward a step (layer 0 and the batch layer)")
    check(launches["segment_plan"] == n_steps,
          f"hub steps: {launches['segment_plan']} segment plans in {n_steps} steps, expected "
          "one a step (the batch layer's; layer 0's is built at refresh)")

    determinism = step_determinism(tr, q, p)
    xcheck = step_kernel_vs_xla(tr, q, p)

    # The rungs side by side on the same tables and draws, without gates.
    d = tr.draw_step(q, 6)
    keep = [torch.rand((n, hidden), generator=tr.generator, device=dev) < 1 - cfg.model.dropout]
    draws = [StepDraws(d.random, d.hard, keep)]
    rungs = {"hubf": step_reading(6, draws, walls_n=6, calls=2)[0]}
    hub_mats = tr.pool_mats
    tr.pool_mats = ()
    tr.bwd_layouts = tr.full_graph_layouts()
    rungs["gather"] = step_reading(6, draws, walls_n=6, calls=2)[0]
    lay = tr.bwd_layouts[0]
    rungs["gather"]["layer0_layout"] = {
        "max_slots_per_id": int((lay.row_ptr[1:] - lay.row_ptr[:-1]).max()),
        "chunks": int(lay.totals[0]), "split_rows": int(lay.totals[1]),
        "parts": int(lay.totals[2])}
    nb0, w0 = tr.nbr_tables[0]
    t0 = time.perf_counter()
    dense = pinsage.build_pool_matrix(nb0, w0, num_cols=n, valid_limit=tr.valid_limit,
                                      dtype=torch.bfloat16)
    torch.cuda.synchronize()
    dense_build_s = time.perf_counter() - t0
    tr.pool_mats = (dense,)
    tr.bwd_layouts = tr.full_graph_layouts()
    rungs["hybrid"] = step_reading(6, draws, walls_n=6, calls=2)[0]
    rungs["hybrid"].update(build_s=dense_build_s,
                           matrix_bytes=dense.numel() * dense.element_size())
    # The hybrid's two GEMMs with the [N, N] matrix as it is (rows of N
    # bf16: 16-byte aligned only when N is a multiple of 8) and as a view
    # into rows padded to a multiple of 8 (the same values).
    h = torch.randn((n, hidden), generator=tr.generator, device=dev).bfloat16()
    padded = torch.zeros((n, -(-n // 8) * 8), dtype=torch.bfloat16, device=dev)
    padded[:, :n] = dense
    aligned = padded[:, :n]
    rungs["hybrid"]["gemm_alignment"] = {
        "row_bytes": n * 2, "padded_row_bytes": padded.shape[1] * 2,
        "forward": cuda_ms(lambda: dense @ h, iters=5),
        "forward_aligned": cuda_ms(lambda: aligned @ h, iters=5),
        "backward": cuda_ms(lambda: dense.t() @ h, iters=5),
        "backward_aligned": cuda_ms(lambda: aligned.t() @ h, iters=5),
        "gflop_each": 2 * n * n * hidden / 1e9}
    del padded, aligned, h
    tr.pool_mats = ()
    del dense
    torch.cuda.empty_cache()
    tr.pool_mats = hub_mats
    tr.bwd_layouts = tr.full_graph_layouts()
    rungs["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9

    gen = torch.Generator(device=dev).manual_seed(4)
    kernels = {"full_graph_b59393": hub_kernel_times(
                   dev, hub_mats[0], n, hidden, torch.arange(n, device=dev), "hub layer 0"),
               "batch_b1524": hub_kernel_times(
                   dev, hub_mats[1], n, hidden,
                   torch.randint(0, n, (1524,), generator=gen, device=dev), "hub batch layer")}
    emit("train_hub", corpus={"num_movies": n, "num_edges": tr.csr.num_edges, **HUB_CORPUS},
         init_s=init_s, refresh_s=refresh_s, builds=builds, slab=slab,
         rung=[type(pm).__name__ for pm in hub_mats],
         embed={"first_ms": first_embed_ms, "ms": embed_ms, "profile": embed_prof,
                "launches": embed_launches},
         steps=steps, launches=launches, step_determinism=determinism,
         step_kernel_vs_xla=xcheck, rungs_same_draws=rungs, kernels=kernels)
    full, bat = kernels["full_graph_b59393"], kernels["batch_b1524"]
    fwd_extra = {"launches_hub": launches["gather_pool"],
                 "ms_hub_k8_full": full["forward"]["ms"],
                 "bound_ms_hub_k8_full": full["forward"]["bound"]["ms"],
                 "plain_ms_hub_k8_full": full["forward"]["plain"]["ms"],
                 "library_ms_hub_k8_full": full["forward"]["library"]["ms"],
                 "ms_hub_k8_batch": bat["forward"]["ms"],
                 "bound_ms_hub_k8_batch": bat["forward"]["bound"]["ms"],
                 "library_ms_hub_k8_batch": bat["forward"]["library"]["ms"]}
    bwd_extra = {"launches_hub": launches["gather_pool_bwd"],
                 "launches_hub_segment": launches["gather_pool_bwd_segment"],
                 "ms_hub_k8_full": full["backward"]["segment"]["ms"],
                 "bound_ms_hub_k8_full": full["backward"]["bound"]["ms"],
                 "plain_ms_hub_k8_full": full["backward"]["plain_segment"]["ms"],
                 "library_ms_hub_k8_full": full["backward"]["library"]["ms"],
                 "ms_hub_k8_batch_with_layout": bat["backward"]["segment_with_layout_per_call"]["ms"],
                 "bound_ms_hub_k8_batch": bat["backward"]["bound"]["ms"],
                 "library_ms_hub_k8_batch": bat["backward"]["library"]["ms"]}
    del eng, tr, hub_mats
    gc.collect()
    torch.cuda.empty_cache()
    return fwd_extra, bwd_extra


def check_phase(dev) -> None:
    """The CUDA engine against the CPU engine (plain versions) on a small
    input with the same params and tables, float32 compute: the gather
    config, and a ``pool_impl=hub`` config (head 32, residual 4, final layer
    hubbed) whose embedding pass takes the gather-pool kernel for both
    layers' residuals; the CPU engine is given the card's hub operators."""
    from movie_recommendation_engine_tpu_torch import api, small_test_config
    from movie_recommendation_engine_tpu_torch.ops import pool
    from movie_recommendation_engine_tpu_torch.ops.hub_pool import HubPool

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu()

    base = {"model.gather_impl": "pallas", "search.search_method": "lsh",
            "train.compute_dtype": "float32"}
    hub = {"model.pool_impl": "hub", "model.hub_pool_head": 32, "model.hub_pool_residual": 4,
           "model.hub_pool_final_layer": True, "model.hub_pool_max_dropped_mass": 1.0}
    out = {}
    for name, over in (("gather", {"model.pool_impl": "gather"}), ("hub", hub)):
        cfg = small_test_config().override({**base, **over})
        gpu = api.Engine(cfg, device=dev)
        cpu = api.Engine(cfg, device="cpu")
        gpu.trainer.refresh_neighborhoods()
        cpu.trainer.params = to_cpu(gpu.trainer.params)
        cpu.trainer.set_neighborhood_tables([(nb.cpu(), w.cpu())
                                             for nb, w in gpu.trainer.nbr_tables])
        if name == "hub":
            check(len(gpu.trainer.pool_mats) == 2
                  and all(isinstance(pm, HubPool) for pm in gpu.trainer.pool_mats),
                  "check: pool_impl=hub with hub_pool_final_layer built no two HubPools")
            cpu_built = cpu.trainer.pool_mats
            cpu.trainer.pool_mats = tuple(HubPool(*(x.cpu() for x in pm))
                                          for pm in gpu.trainer.pool_mats)
        pool.LAUNCHES = 0
        eg = gpu.embeddings()
        launches = pool.LAUNCHES
        ec = cpu.embeddings()
        check(launches == 2, f"check {name}: gather_pool launched {launches} times in one "
                             "embedding pass, expected 2")
        check_embeddings(eg, ec.shape, f"check {name}")
        err = float(np.abs(eg - ec).max())
        check(err <= 1e-4, f"check {name}: CUDA vs CPU embeddings differ by {err}")
        out[name] = {"embed_max_abs_err": err, "launches": launches, "rows": int(eg.shape[0])}
        if name == "hub":
            # Whether the CPU's build of the same tables equals the card's
            # (reported: a near-tie of column masses summed in another
            # order may pick another head column).
            out[name]["cpu_build_equal"] = all(
                torch.equal(a.cpu().float(), b.float()) for pm_g, pm_c in
                zip(cpu.trainer.pool_mats, cpu_built) for a, b in zip(pm_g, pm_c))
    emit("check", tolerance=1e-4, **out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA card",
              file=sys.stderr)
        return 1
    import movie_recommendation_engine_tpu_torch  # noqa: F401  (fails outside the repo)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True,
                           timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, sm_clock_max_mhz=float(clock), torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    gather_err, ham = kernel_phase(dev, float(clock))
    launches, serving = serve_phase(dev)
    pool_entry = gather_pool_phase(dev, *serving, gather_err)
    serve_default_phase(dev)
    bwd, train_launches = train_phase(dev)
    pool_entry.update(launches=launches["gather_pool"],
                      launches_train=train_launches["gather_pool"])
    fwd_hub, bwd_hub = train_hub_phase(dev)
    pool_entry.update(fwd_hub)
    bwd.update(bwd_hub)
    ham["launches"] = launches["hamming_distance"]
    kernels = [pool_entry, bwd, ham]
    check_phase(dev)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
