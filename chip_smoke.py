"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  — the card (``nvidia-smi`` name and power limit; the raw line too)
   and its maximum SM clock (``clocks.max.sm``), which the bounds use.
2. kernels — builds both hand-written CUDA kernels from ``ops/csrc`` with
   ``nvcc`` (in parallel) and holds each against its plain PyTorch version
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
6. check   — the outputs are finite, unit-norm and of the expected shape, and
   the CUDA engine agrees with the CPU engine (plain versions) on a small
   input given the same params and tables.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure ends the run with a non-zero
exit code and no result line. It exits non-zero at once without a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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


def timed(fn, iters: int = 50, profile_calls: int = 20) -> dict:
    """``cuda_ms`` and, as its cross-check, the profiler's device time per
    call (``device_profile``: the device events' own time, so no gap between
    launches) and its kernels per call."""
    t = cuda_ms(fn, iters)
    prof = device_profile(fn, profile_calls)
    t["profiler_ms"] = prof["device_ms"]
    t["kernels_per_call"] = prof["kernels_per_call"]
    return t


def device_profile(fn, calls: int = 20) -> dict:
    """Host wall time per call against device time per call (sum of the
    device events' self time in a ``torch.profiler`` window; nothing here
    runs two kernels at once, so the sum is busy time), and the top kernels.
    Device fields are None when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    # Device events only: a CPU op's device time repeats its kernels' time.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
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


def check_phase(dev) -> None:
    """The CUDA engine against the CPU engine (plain versions) on a small
    input with the same params and tables, float32 compute."""
    from movie_recommendation_engine_tpu_torch import api, small_test_config

    cfg = small_test_config().override({
        "model.pool_impl": "gather", "model.gather_impl": "pallas",
        "search.search_method": "lsh", "train.compute_dtype": "float32"})
    gpu = api.Engine(cfg, device=dev)
    cpu = api.Engine(cfg, device="cpu")

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu()

    gpu.trainer.refresh_neighborhoods()
    cpu.trainer.params = to_cpu(gpu.trainer.params)
    cpu.trainer.set_neighborhood_tables([(nb.cpu(), w.cpu()) for nb, w in gpu.trainer.nbr_tables])
    eg, ec = gpu.embeddings(), cpu.embeddings()
    check_embeddings(eg, ec.shape, "check")
    err = float(np.abs(eg - ec).max())
    check(err <= 1e-4, f"CUDA vs CPU embeddings differ by {err}")
    emit("check", embed_max_abs_err=err, tolerance=1e-4, rows=int(eg.shape[0]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA card",
              file=sys.stderr)
        return 1
    import movie_recommendation_engine_tpu_torch  # noqa: F401  (fails outside the repo)

    dev = torch.device("cuda")
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
    kernels = [gather_pool_phase(dev, *serving, gather_err), ham]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    serve_default_phase(dev)
    check_phase(dev)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
