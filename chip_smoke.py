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
7b. train_graph — the train step and the embedding pass as CUDA graphs
   (``train/loop.py``) on the gather rung with the kernels (4k,
   ``gather_impl=pallas``), the default config's dense rung (4k) and
   ``train_hub``'s ``hubf`` trainer: a graphed trainer and an eager twin
   (``graphed = False``) from one state run the blocks of epochs 0 and 1
   (12 batches of 512 an epoch; 0 and 1 hard negative, so two step graphs;
   the checkpoint's reseed before each epoch; at 4k new tables before epoch
   1, copied into the captured storages), every block under
   ``set_sync_debug_mode("error")``. Params, Adam state, losses and the
   generator's state and next words must be bitwise equal (else the first
   leaf that differs is named), the launch counts equal (replays counted),
   and the graphed embedding pass bitwise equal to the eager one. Reports
   each capture (kernel nodes, seconds, pool bytes) and, for the step and
   the embedding pass, wall per call (12 in turns), device time, kernels
   and busy share, graphed and eager. Every other phase's ``fit`` and
   ``train_steps`` without draws replays the graphs too; steps given draws
   run eager.
8. ppr     — ``walk.strategy=ppr`` on the serve phase's corpus with
   ``pool_impl=gather``, ``gather_impl=pallas``: ``Engine.fit`` for 2 epochs
   (launch counts zeroed just before and read just after) builds the tables
   once and launches both gather-pool kernels as the train phase does; a
   second build is bitwise equal; ``ppr_scores`` on the card within 1e-5 of
   the CPU's; one embedding pass; HR@10 beside the train phase's walk
   tables. Then ``ppr_at_scale``: the same build twice on ``train_hub``'s
   59,393-movie corpus (seconds, peak device memory, bitwise equal) and the
   rung ``pool_impl=auto`` picks on those tables.
9. retrieval — ``benchmark_search_methods`` (exact, LSH, LSH + rerank, IVF)
   on ``train_hub``'s embeddings, 256 queries, k = 10, the Hamming
   launches counted; each index's search timed as in 2, the ±1 LSH form
   beside the popcount kernel; IVF's longest list within its cap, IVF with
   every list probed equal to exact search (up to near-ties), both LSH forms
   equal with and without rerank, a card-built IVF index copied to the CPU
   answering alike, and a ``BatchingRecommender`` with ``method="ivf"``
   answering threads and HTTP.
9b. serve_graph — the serving searches as CUDA graphs
   (``core/graphs.SearchGraphs``) on ``train_hub``'s embeddings: exact, LSH
   (popcount and ±1, each with and without rerank) and IVF, each built
   twice (the twin ``graphed = False``, the same planes and k-means rows;
   the builds bitwise equal). At every server bucket (Q = 1..64, k = the
   server's search_k 116) and at Q = 256, k = 10: the graphed index's first
   call (eager), second (capture) and a replay on other queries under
   ``set_sync_debug_mode("error")`` bitwise equal to the twin's, with equal
   launch counts; wall per call (host queries, ids copied back), the
   profiler's device time, kernels and busy share, both ways. The Hamming kernel in a graph at 59k, Q = 1 and 64: its [Q, N]
   output against the plain version (max abs error 0), the search graph's
   top-k against the plain distances', its time alone and replayed, its
   bound, plain version and the ±1 GEMM yardstick. Then a graphed LSH
   server on the serve corpus (4k) and an IVF server at 59k: every bucket
   captured at warm-up (one ``search_graph`` event each), requests one at a
   time bitwise equal to the index's eager answers, a large-exclusion
   request twice (a pow2 search_k, captured by the worker at its second
   use), 8 threads x 16 requests and HTTP graphed (answers equal to eager
   search up to near-ties), then the same load eager; p50 / p99, capture seconds, pool
   bytes, free device memory beside the hub trainer.
9c. epoch_graph — the per-epoch programs as CUDA graphs
   (``core/graphs.GraphCache``): on the serve corpus (4k), with
   ``gather_impl=pallas`` on the gather rung and with the default (dense)
   config, a graphed trainer and an eager one (``graphed = False``) from one
   seed ``fit`` 3 epochs (12 batches of 512 an epoch): per epoch the tables,
   params and validation metrics bitwise equal, the generators' states
   equal after, the gather-pool launches equal (counts zeroed just before
   each fit), a refresh and a ranks graph captured, one more refresh replay
   under ``set_sync_debug_mode("error")`` equal to the eager trainer's
   next; per epoch the refresh, validation and step ms both ways, then a
   validation pass and the refresh program (the walks, and on the dense
   rung its pool matrices, built in the same graph) timed both ways (wall,
   the profiler's device time, kernels, busy share). On
   ``train_hub``'s bipartite graph (118,419 nodes, 1,352,396 edges) real
   walk tables at the default width: the trainer's refresh (59,393 rows)
   and all nodes' (118,419 rows), each graphed against eager from one
   generator state (bitwise equal tables and generator states, a replay
   under sync debug mode "error", the capture's seconds and pool bytes,
   under 1 GiB), beside the seconds ``set_neighborhood_tables`` takes on
   the new tables (the operators' and layouts' build, eager). Then on
   ``train_hub``'s 59,393 x 128 embeddings ``_ranks`` over its val pairs,
   ``recommend`` at Q = 1 and 64 (k = 10) and k-means (100 lists, 15
   iterations), each graphed against eager the same way.
10. check  — the outputs are finite, unit-norm and of the expected shape, and
   the CUDA engine agrees with the CPU engine (plain versions) on a small
   input given the same params and tables, on the gather config, on a
   ``pool_impl=hub`` config and on a ``pool_impl=block``,
   ``block_pool_order="feature"`` config (k-means on the card, the CPU given
   its node order).
11. movielens — the default config as a MovieLens user runs it: train_hub's
   synthetic corpus (61,480 movies / 60,000 users / 3M ratings drawn, 59,393
   movies after the 30% subset; MovieLens-25M's 25M ratings do not fit the
   run) written as MovieLens CSVs (quoted titles with commas and quotes, NA
   tags, empty ``tmdbId``), loaded through ``dataset.load`` at num_workers 1
   and 4 (equal to ``_from_columns`` of the written columns; the native
   parser's route), the stdlib reader timed; then ``api.Engine`` on ``cuda``
   with ``gather_impl=pallas``, ``search_method=lsh``: ``fit`` 1 epoch of 4
   steps (counts zeroed just before, read just after; ``pool_impl=auto``'s
   rung must launch both gather-pool kernels, else the steps run again with
   ``pool_impl=hub``), a step's device time, ``evaluate``, ``recommend``, an
   LSH server (the Hamming kernel) and exact search at Q = 256 with the
   tie-ordered top-k beside a stable sort and ``torch.topk``; both
   gather-pool kernels held against their plain versions on the residuals
   (or walk table) of the rung that ran.
12. cooc   — ``use_bipartite_graph=False`` on the same CSVs: the native
   co-occurrence counter's pairs and counts equal to the numpy counter's
   (both timed), ``fit`` 2 steps on the gather rung with the kernels, which
   are then held against their plain versions on its walk table.
13. aggregators — each ``model.aggregator_type`` (and importance with batch
   norm) on the serve corpus at full width in f32: a step on the card
   against the same step on the CPU (tolerances in ``agg_step_vs_cpu``) and
   its device time; ``edge_forward`` on the card bitwise repeatable, within
   1e-4 of the CPU's, its message sum against ``index_add_``.
14. tools  — ``tune`` (2 x 1 grid), ``demo`` on piped commands, ``train
   --profile`` (the trace names the gather-pool kernel) and a reference
   ``.pt`` checkpoint, on the card.

15. mesh   — multi-device execution on the one card (``mesh_phase``):
   NCCL in a world of one (a 2-epoch ``fit`` at ``mesh_shape=(1, 1)``
   with ``shard_tables`` on the gather config, f32, within 1e-6 of the fit
   without a mesh, bitwise equality reported); then two gloo ranks spawned
   on cuda:0 (collectives staged through the host): the gather config at
   (1, 2) with tables and CSR row-sharded and at (2, 1), 2 steps with 6
   hard negatives, walk tables bitwise equal to the single-device trainer's
   and the losses and first gradients within 1e-5 (a gradient counted on
   both ranks fails; params reported), both gather-pool kernels launched
   on each rank and held to their plain versions on the rank's rows; ``train_hub``'s 59,393-row
   popularity tables at (1, 2), which must take ``hubf`` with half of each
   ``a_head`` a rank, one step within 1e-5 of the single-device step, peak
   memory per rank; sharded exact and IVF (every list probed) search over
   that step's embeddings at Q = 256, k = 10, equal to exact search except
   at near-ties (1e-6). Per rank: step wall and CUDA-event ms, the
   collectives' calls, bytes and host ms a step, the rung.
16. hstu_lookup — HSTU's item lookups (``models/hstu.lookup``: gather-pool at
   K = 1, weight 1) at the ``hstu-ml20m`` train step's shape, over a
   random f32 [28,300, 256] table: the history [128 * 200, 1] (popularity-
   skewed ids, padded with -1, lengths from a power-law activity) and the
   loss's [128 * 200 * 129, 1] (each position's next item, then 128 uniform
   negatives). Each forward equal to ``gather_pool_plain``; each
   table gradient, through autograd as the step takes it, bitwise equal to
   ``gather_pool_bwd_segment_plain`` on the layout the call builds, and the
   plan kernel to ``segment_plan_plain`` (``check_segment``); the gradient
   against ``index_add_`` reported. Launch counts of one forward and
   backward of both lookups; the longest row (slots, chunks, and whether
   pass 2 sums it); the kernels' times beside their bounds.
17. dlrm    — DLRM-DCNv2's table gradient (``ops/pool.compact_rows`` /
   ``compact_grad``) at the ``criteo-dlrm-train`` cell's 100-id feature: a
   5,000,000-row slice, B = 8,192, K = 100 (Zipf(1.05) first ids, the rest
   uniform). The card's chunk plan equal to ``segment_plan_plain`` there
   (limit B * K = 819,200) and at a PinSage layer's limit (59,393); the
   compact layout, rows and count equal to the CPU's; the compact gradient
   bitwise equal to ``gather_pool_bwd_segment_plain`` on its layout and to
   the dense segment route's touched rows; the plan's, the compact rows' and
   the gradient's device times. Then one eager epoch of a ``ClickTrainer``
   at the cell's widths over five small tables, the launch counts zeroed
   just before and read just after: per step and bag one forward, one
   segment backward and one plan of ``pool.PLAN_KERNELS`` launches, and no
   call of ``gather_pool_bwd``.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure ends the run with a non-zero
exit code and no result line. It exits non-zero at once without a card.
TF32 is off for matrix products and cuDNN (``main``), so float32 checks
compare float32 arithmetic.
"""

from __future__ import annotations

import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

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
            # kernels alone, without the copies and memsets
            "kernel_launches_per_call": sum(e.count for e in events if not e.key.startswith(
                ("Memcpy", "Memset"))) / calls,
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
    from movie_recommendation_engine_tpu_torch.retrieval.lsh import _unpack_pm

    q_pm, s_pm = (_unpack_pm(x.reshape(x.shape[0], t, wd)) for x in (qs, ss))
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

def drive_server(srv, num_movies: int, threads: int = 8, per_thread: int = 6,
                 answers: list | None = None) -> list[float]:
    """Requests by item and by history from several threads; checks that
    every answer excludes its query items. Returns client latencies (ms);
    ``answers`` gets each ((kind, item or history, k), answer)."""
    lat, errors = [], []
    lock = threading.Lock()

    def client(c):
        rng = np.random.default_rng(c)
        try:
            for r in range(per_thread):
                t0 = time.perf_counter()
                if r % 2:
                    i = int(rng.integers(num_movies))
                    out, query, ask = srv.recommend_by_item(i, k=10), {i}, ("item", i, 10)
                else:
                    hist = [int(x) for x in rng.choice(num_movies, 3, replace=False)]
                    out, query = srv.recommend_by_history(hist, k=10), set(hist)
                    ask = ("history", hist, 10)
                dt = (time.perf_counter() - t0) * 1e3
                ok = len(out["indices"]) == 10 and not query & set(out["indices"])
                with lock:
                    lat.append(dt)
                    if answers is not None:
                        answers.append((ask, out))
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


def serve_phase(dev) -> tuple[dict, tuple, tuple]:
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
    # gather-pool timing; the embeddings and data, for serve_graph.
    return launches, (eng.trainer.nbr_tables[0], eng.trainer.table_rows,
                      eng.trainer.valid_limit, cfg.model.hidden_dim), (emb, eng.data)


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
    check(again.epoch == 2 and int(again.opt_state.step) == int(tr.opt_state.step),
          "reloaded state")
    summary = {"fit_s": fit_s, "adam_steps": int(tr.opt_state.step), "launches": launches,
               "history": [{k: h[k] for k in ("loss", "num_hard", "examples_per_sec",
                                               "step_wall_seconds", "refresh_seconds",
                                               "val_hit_rate@10")} for h in hist],
               "reloaded_hit_rates": hr}
    return eng, summary


def copy_state(params, opt):
    from movie_recommendation_engine_tpu_torch.core import tree
    from movie_recommendation_engine_tpu_torch.train import optim

    clone = lambda t: tree.map_tree(lambda x: x.detach().clone(), t)  # noqa: E731
    return clone(params), optim.AdamState(opt.step.clone(), clone(opt.mu), clone(opt.nu))


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
    d_table, from a layout built ahead (with the weights, as the call and
    the trainer build it) and from one built by the call, bitwise equal to
    ``gather_pool_bwd_segment_plain`` and the calls bitwise equal to each
    other. Returns the largest |kernel - plain| (0 when bitwise equal)."""
    lay = pool.segment_layout(nbrs, limit, weights=w)
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


def hstu_lookup_ids(seed: int, n: int, b: int = 128, length: int = 200,
                    negatives: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """Ids of one ``hstu-ml20m`` step's lookups: (history [b * length, 1],
    loss [b * length * (1 + negatives), 1]) int32. Items are drawn by a
    Pareto(1.2) popularity and window lengths (3..length + 1 slots, real
    items first, -1 after) by a Pareto(1.2) activity scaled to a mean of 145
    ratings, as the benchmark's corpus draws them; slot i + 1 is position
    i's target, the negatives uniform over the table."""
    rng = np.random.default_rng(seed)
    pop = rng.pareto(1.2, size=n) + 1.0
    pop /= pop.sum()
    act = rng.pareto(1.2, size=b) + 1.0
    lengths = np.clip(np.rint(145 * act / 6.0), 3, length + 1).astype(np.int64)
    window = rng.choice(n, size=(b, length + 1), p=pop).astype(np.int32)
    window[np.arange(length + 1)[None, :] >= lengths[:, None]] = -1
    negs = rng.integers(0, n, (b, length, negatives), dtype=np.int32)
    cand = np.concatenate([window[:, 1:, None], negs], axis=-1)
    return window[:, :length].reshape(-1, 1), cand.reshape(-1, 1)


def dlrm_bag_ids(n: int, b: int, k: int, seed: int, dev) -> torch.Tensor:
    """[b, k] int32: a Zipf(1.05) first id over a permutation of ``n`` rows
    and k - 1 uniform ones, as the benchmark's click traffic draws them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(b, generator=g, device=dev, dtype=torch.float64)
    s = 1.05
    rank = ((1 - u * (1 - (n + 1.0) ** (1 - s))) ** (1 / (1 - s))).long().clamp(1, n) - 1
    perm = torch.randperm(n, generator=g, device=dev)
    rest = torch.randint(0, n, (b, k - 1), generator=g, device=dev)
    return torch.cat([perm[rank][:, None], rest], 1).to(torch.int32).contiguous()


def card_plan_vs_plain(pool, limit: int, slots: torch.Tensor, what: str) -> dict:
    """The card's chunk plan of ``slots``' ids (sorted, grouped over
    ``limit``) against ``segment_plan_plain``, bitwise, and its device time."""
    key = torch.sort(slots).values.to(torch.int32)
    row_ptr = torch.searchsorted(key, torch.arange(limit + 1, dtype=torch.int32,
                                                   device=key.device), out_int32=True)
    m = slots.numel()
    bounds = (pool.SEGMENT_CHUNK, limit + m // pool.SEGMENT_CHUNK,
              min(limit, m // (pool.SEGMENT_CHUNK + 1)))
    card = pool._segment_plan(row_ptr, *bounds)
    plain = pool.segment_plan_plain(row_ptr.cpu(), *bounds)
    c, sp = int(plain[2][0]), int(plain[2][1])
    check(torch.equal(card[2].cpu(), plain[2]) and torch.equal(card[0][:c].cpu(), plain[0][:c])
          and torch.equal(card[1][:sp].cpu(), plain[1][:sp]),
          f"{what}: the card's chunk plan differs from segment_plan_plain")
    return {"limit": limit, "slots": m, "chunks": c, "split_rows": sp,
            "plan": timed(lambda: pool._segment_plan(row_ptr, *bounds),
                          kernels=pool.PLAN_KERNELS)}


def dlrm_phase(dev) -> dict:
    """Phase 17: DLRM-DCNv2's compact table gradient at the cell's 100-id
    feature, and the launches of an eager epoch (see the module docstring)."""
    from movie_recommendation_engine_tpu_torch import small_test_config
    from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
    from movie_recommendation_engine_tpu_torch.graph import criteo, dataset
    from movie_recommendation_engine_tpu_torch.ops import pool
    from movie_recommendation_engine_tpu_torch.train.click_trainer import ClickTrainer

    n, b, k, d = 5_000_000, 8192, 100, 128
    ids = dlrm_bag_ids(n, b, k, 24, dev)
    ones = torch.ones((b, k), device=dev)
    g = torch.randn((b, d), generator=torch.Generator(device=dev).manual_seed(25), device=dev)
    out = {"shape": f"table slice [{n},{d}] f32, ids [{b},{k}]"}
    c = pool.compact_rows(ids, spare=n)
    got = pool.compact_grad(g, ids, ones, c)
    torch.cuda.synchronize()
    uniq = torch.unique(ids.long())
    u = int(c.count)
    check(u == uniq.numel() and torch.equal(c.rows[:u], uniq) and bool((c.rows[u:] == n).all()),
          f"dlrm: compact rows {u} against {uniq.numel()} distinct ids")
    cpu = pool.compact_rows(ids.cpu(), spare=n)
    cc, ss = int(cpu.layout.totals[0]), int(cpu.layout.totals[1])
    check(torch.equal(cpu.layout.totals, c.layout.totals.cpu())
          and torch.equal(cpu.layout.slots, c.layout.slots.cpu())
          and torch.equal(cpu.layout.chunks[:cc], c.layout.chunks[:cc].cpu())
          and torch.equal(cpu.layout.splits[:ss], c.layout.splits[:ss].cpu())
          and torch.equal(cpu.rows, c.rows.cpu()),
          "dlrm: the card's compact layout differs from the CPU's")
    like = torch.zeros((), device=dev).expand(b * k, d)
    plain = pool.gather_pool_bwd_segment_plain(like, ids, ones, b * k, g, c.layout)
    check(same_bits(got, plain), "dlrm: compact_grad differs from its plain version")
    del plain, like
    table = torch.zeros((n + 1, d), device=dev)
    dense, _ = pool.gather_pool_bwd(table, ids, ones, n, g, need_weights=False)
    check(torch.equal(got[:u], dense[uniq]) and not bool(got[u:].any()),
          "dlrm: compact_grad differs from the dense segment route's touched rows")
    del dense, table
    out.update(lookups=b * k, unique_rows=u, chunks=cc, split_rows=ss,
               compact_rows=timed(lambda: pool.compact_rows(ids, spare=n),
                                  kernels=pool.PLAN_KERNELS),
               compact_grad=timed(lambda: pool.compact_grad(g, ids, ones, c)))
    run = torch.repeat_interleave(torch.arange(b * k, device=dev),
                                  (c.layout.row_ptr[1:] - c.layout.row_ptr[:-1]).long())
    out["plan_compact"] = card_plan_vs_plain(pool, b * k, run, "dlrm compact ids")
    slots = (torch.rand(600_000, generator=torch.Generator(device=dev).manual_seed(26),
                        device=dev) ** 3 * 59_393).long().clamp(max=59_392)
    out["plan_59k"] = card_plan_vs_plain(pool, 59_393, slots, "59,393-row layer")

    bags, held = (3, 1, 100, 2, 1), (4000, 3, 50_000, 20, 1)
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "criteo")
        for split, size in (("train", 3 * 512), ("val", 700)):
            dense_x = np.log1p(rng.lognormal(0.0, 1.0, (size, 13))).astype(np.float32)
            sparse = [rng.integers(0, r, (size, kf)).astype(np.int32)
                      for kf, r in zip(bags, held)]
            criteo.write_split(data_dir, split, dense_x, sparse,
                               (rng.random(size) < 0.1).astype(np.float32))
        cfg = small_test_config().override({
            "model.arch": "dlrm_dcnv2", "data.source": "criteo", "data.data_dir": data_dir,
            "model.embed_dim": 128, "model.dlrm_bag_sizes": list(bags),
            "model.dlrm_table_rows": list(held), "model.dlrm_bottom": [512, 256, 128],
            "model.dlrm_top": [1024, 1024, 512, 256, 1], "model.dlrm_cross_layers": 3,
            "model.dlrm_cross_rank": 512, "train.batch_size": 512,
            "paths.checkpoint_dir": os.path.join(data_dir, "ckpt")})
        tr = ClickTrainer(cfg, dataset.load(cfg), MetricsLogger(io.StringIO()), device=dev)
        tr.graphed = False
        zero_launches()
        epoch = tr.train_epoch(0)
        torch.cuda.synchronize()
        launches = read_launches()
    steps, f = epoch["steps"], len(bags)
    want = {"gather_pool": f * steps, "gather_pool_bwd": 0, "gather_pool_bwd_segment": f * steps,
            "segment_plan": f * steps * pool.PLAN_KERNELS}
    check(launches == want, f"dlrm: an eager epoch of {steps} steps over {f} bags launched "
          f"{launches}, expected {want}")
    check(math.isfinite(epoch["loss"]) and epoch["lookups"] == steps * 512 * sum(bags),
          f"dlrm: epoch {epoch}")
    out.update(epoch_steps=steps, launches=launches, epoch_unique_rows=epoch["unique_rows"])
    emit("dlrm", **out)
    return out


def hstu_lookup_phase(dev, n: int = 28_300, b: int = 128) -> dict:
    """Phase 16: HSTU's two item lookups at the train step's shape, ``n``
    table rows and ``b`` users (see the module docstring)."""
    from movie_recommendation_engine_tpu_torch.core import roofline
    from movie_recommendation_engine_tpu_torch.models import hstu
    from movie_recommendation_engine_tpu_torch.ops import pool

    d = 256
    gen = torch.Generator(device=dev).manual_seed(19)
    table = torch.randn((n, d), generator=gen, device=dev)
    hist, loss = (torch.as_tensor(a, device=dev) for a in hstu_lookup_ids(19, n, b))
    out = {"shape": f"table[{n},{d}] f32, history {tuple(hist.shape)}, "
                    f"loss {tuple(loss.shape)}, K = 1, weight 1"}
    grads = {}
    for what, ids in (("history", hist), ("loss", loss)):
        w = torch.ones(ids.shape, dtype=torch.float32, device=dev)
        g = torch.randn((ids.shape[0], d), generator=gen, device=dev)
        got = pool.gather_pool(table, ids, w, n)
        ref = pool.gather_pool_plain(table, ids, w, n)
        torch.cuda.synchronize()
        # Equal values (a padding row's plain 0 * x may be -0.0).
        check(torch.equal(got, ref), f"hstu_lookup {what}: forward differs from its plain "
                                     f"version (max abs err {float((got - ref).abs().max())})")
        del got, ref
        err = check_segment(pool, table, ids, w, n, g, f"hstu_lookup {what}")
        tg = table.clone().requires_grad_()
        (auto,) = torch.autograd.grad(hstu.lookup(tg, ids), tg, g[:, None])
        lay = pool.segment_layout(ids, n, weights=w)
        plain = pool.gather_pool_bwd_segment_plain(table, ids, w, n, g, lay)
        idx_add, _ = pool.gather_pool_bwd_plain(table, ids, w, n, g, need_weights=False)
        torch.cuda.synchronize()
        check(same_bits(auto, plain),
              f"hstu_lookup {what}: the autograd gradient is not the segment route's")
        rows = (lay.row_ptr[1:] - lay.row_ptr[:-1]).long()
        top = int(rows.argmax())
        chunks, splits, parts = lay.totals.tolist()
        valid = int(rows.sum())
        fwd_t = timed(lambda: pool.gather_pool(table, ids, w, n))
        seg_t = timed(lambda: pool.gather_pool_bwd(table, ids, w, n, g, need_weights=False,
                                                   layout=lay))
        whole_t = cuda_ms(lambda: pool.gather_pool_bwd(table, ids, w, n, g, need_weights=False),
                          iters=10)
        reached = int(torch.unique(ids[ids >= 0]).numel())
        fb = roofline.gather_pool_bound(reached, d, ids.shape[0], 1, table_bytes=4)
        bb = roofline.gather_pool_bwd_bound(n, d, ids.shape[0], 1, 4, valid_slots=valid)
        out[what] = {
            "rows": int(ids.shape[0]), "valid_slots": valid, "rows_reached": reached,
            "max_abs_err_vs_plain_segment": err,
            "vs_index_add_max_abs": float((auto - idx_add).abs().max()),
            "chunks": chunks, "split_rows": splits, "parts": parts,
            "longest_row": {"row": top, "slots": int(rows[top]),
                            "chunks": int((lay.chunks[:chunks, 0] == top).sum()),
                            "pass_2": int(rows[top]) > lay.chunk},
            "forward": {**fwd_t, "bound": fb, "bound_share": fb["ms"] / fwd_t["ms"]},
            "segment": {**seg_t, "bound": bb, "bound_share": bb["ms"] / seg_t["ms"]},
            "segment_with_layout_per_call": whole_t}
        grads[what] = (ids, g)
        del auto, plain, idx_add, lay
    zero_launches()
    tg = table.clone().requires_grad_()
    total = sum((hstu.lookup(tg, ids) * g[:, None]).sum()
                for ids, g in grads.values())
    total.backward()
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    check(out["launches"] == {"gather_pool": 2, "gather_pool_bwd": 2,
                              "gather_pool_bwd_segment": 2,
                              "segment_plan": 2 * pool.PLAN_KERNELS},
          f"hstu_lookup: one forward and backward of both lookups launched {out['launches']}")
    emit("hstu_lookup", **out)
    return out


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


def train_phase(dev) -> tuple[dict, dict, dict]:
    """Returns the ``gather_pool_bwd`` entry of the kernels line, the train
    path's launch counts and the gather config's fit summary."""
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
        check(launches["segment_plan"] >= steps * pool.PLAN_KERNELS,
              f"the segment plan kernels launched {launches['segment_plan']} times in {steps} "
              "steps: expected one plan a step (the batch layer) and one a table refresh")
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
            "bound_by": a["bound"]["by"], "library_ms": a["library"]["ms"]}, launches, gather_fit


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
    """Both kernels at a hub residual's shape (K its width, valid limit N): the
    forward against its plain version (1e-4), the segment backward bitwise
    against its plain version, both timed beside their bounds, their plain
    versions and ``embedding_bag`` (forward, and its backward in the
    table); the segment layout's row 0, built with the weights as the
    trainer builds it, so that the padding slots (weight 0) are left out."""
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
    lay = pool.segment_layout(nbrs, n, weights=w)
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
                         "zero_weight_slots": int((w == 0).sum()),
                         "row0_slots": int(lay.row_ptr[1] - lay.row_ptr[0]),
                         "row0_chunks": int((lay.chunks[:chunks, 0] == 0).sum())}}


def train_hub_phase(dev) -> tuple[dict, dict, object, np.ndarray]:
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
    fields for ``gather_pool`` and ``gather_pool_bwd``, the engine (for the
    at-scale PPR build) and its embeddings (for the retrieval phase)."""
    from movie_recommendation_engine_tpu_torch import api, default_config
    from movie_recommendation_engine_tpu_torch.ops import pool
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
    check(launches["segment_plan"] == n_steps * pool.PLAN_KERNELS,
          f"hub steps: {launches['segment_plan']} plan launches in {n_steps} steps, expected "
          "one plan a step (the batch layer's; layer 0's is built at refresh)")

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
    t0 = time.perf_counter()
    dense, = tr._dense_matrices(tr.nbr_tables, 1)
    torch.cuda.synchronize()
    dense_build_s = time.perf_counter() - t0
    tr.pool_mats = (dense,)
    tr.bwd_layouts = tr.full_graph_layouts()
    rungs["hybrid"] = step_reading(6, draws, walls_n=6, calls=2)[0]
    rungs["hybrid"].update(build_s=dense_build_s,
                           matrix_bytes=dense.numel() * dense.element_size())
    # The hybrid's two GEMMs through the trainer's matrix (rows at
    # padded_pool_matrix's aligned stride, zero past N) and through an
    # [N, N] copy of it (rows of N bf16: 16-byte aligned only when N is a
    # multiple of 8).
    h = torch.randn((n, hidden), generator=tr.generator, device=dev).bfloat16()
    h_pad = torch.nn.functional.pad(h, (0, 0, 0, dense.shape[1] - n))
    plain = dense[:, :n].contiguous()
    rungs["hybrid"]["gemm_alignment"] = {
        "row_bytes": n * 2, "padded_row_bytes": dense.shape[1] * 2,
        "forward": cuda_ms(lambda: plain @ h, iters=5),
        "forward_padded": cuda_ms(lambda: dense @ h_pad, iters=5),
        "backward": cuda_ms(lambda: plain.t() @ h, iters=5),
        "backward_padded": cuda_ms(lambda: dense.t() @ h, iters=5),
        "gflop_each": 2 * n * n * hidden / 1e9}
    del plain, h_pad, h
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
    return fwd_extra, bwd_extra, eng, emb


# ---------------------------------------------------------------------------
# 7b. the train step and the embedding pass as CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_PAIRS = 6144       # 12 batches of 512 an epoch: two blocks of 8 steps


def state_leaves(tr) -> dict:
    """The trainer's params and Adam state, by checkpoint key."""
    from movie_recommendation_engine_tpu_torch.core import tree

    out = {f"params/{k}": v for k, v in tree.flatten(tr.params).items()}
    for name in ("mu", "nu"):
        out.update({f"opt/{name}/{k}": v
                    for k, v in tree.flatten(getattr(tr.opt_state, name)).items()})
    out["opt/step"] = tr.opt_state.step
    return out


def first_difference(a: dict, b: dict) -> dict | None:
    """The first leaf (in ``a``'s order) that differs bitwise between the two
    trees, with its largest absolute difference, or None."""
    for k in a:
        if not same_bits(a[k], b[k]):
            err = (float((a[k].double() - b[k].double()).abs().max())
                   if a[k].shape == b[k].shape else None)
            return {"leaf": k, "max_abs_err": err}
    return None


def graph_epochs(tr, epochs: tuple, refresh: bool) -> dict:
    """The blocks of ``epochs`` as ``train_epoch`` runs them, each block under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises), the
    launch counts zeroed before the first and read after the last. Before
    each epoch the checkpoint's rng words are drawn (which reseeds the
    generator, as ``save_checkpoint`` does); with ``refresh`` the tables are
    resampled before each epoch after the first."""
    losses, words = [], []
    zero_launches()
    for e in epochs:
        if refresh and e != epochs[0]:
            tr.refresh_neighborhoods()
        words.append(tr._rng_words().tolist())
        q_all, p_all, block, _, num_hard = tr.epoch_batches(e)
        for s0 in range(0, q_all.shape[0], block):
            torch.cuda.set_sync_debug_mode("error")
            try:
                losses.append(tr.train_steps(q_all[s0:s0 + block], p_all[s0:s0 + block],
                                             tr.plateau.lr, float(e), num_hard))
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"losses": torch.cat(losses), "launches": read_launches(), "rng_words": words}


def graph_twins(dev, tr, refresh: bool) -> dict:
    """``tr`` (graphed) and an eager twin (``graphed = False``) started from
    one state: the same params and Adam state, tables, operators and
    layouts, and generator seed. Both run the blocks of epochs 0 and 1
    (``graph_epochs``: 0 and 1 hard negatives, so two step keys; with
    ``refresh`` new tables before epoch 1, which the graphed trainer copies
    into its captured storages). Gates: params, Adam state, losses and the
    generator's state and next words bitwise equal (else the first leaf that
    differs and its largest error), the launch counts equal (the graphed
    trainer's counted by its replays), two step graphs and one embedding
    graph captured, the graphed embedding pass bitwise equal to the eager
    one. Then each path's step (epoch 1's first batch) and embedding pass
    timed: wall per call (host clock, synchronized, 12 calls in turns),
    device time, kernels and busy share over a profiled window."""
    from movie_recommendation_engine_tpu_torch.core.graphs import copy_into, tensors
    from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
    from movie_recommendation_engine_tpu_torch.train.trainer import Trainer, rung

    cfg = tr.cfg
    pairs0, cfg.train.max_pairs_per_epoch = cfg.train.max_pairs_per_epoch, GRAPH_PAIRS
    eager = Trainer(cfg, tr.data, logger=MetricsLogger(io.StringIO()), device=dev)
    eager.graphed = False
    eager.set_neighborhood_tables(tr.nbr_tables)
    ops_g, ops_e = (tr.pool_mats, tr.bwd_layouts), (eager.pool_mats, eager.bwd_layouts)
    rebuilt_equal = all(same_bits(a, b) for a, b in zip(tensors(ops_g), tensors(ops_e)))
    check(copy_into(ops_e, ops_g), "eager twin: operators of another structure")
    eager.params, eager.opt_state = copy_state(tr.params, tr.opt_state)
    for t in (tr, eager):
        t._reseed(np.array([2024, 12], np.uint32))
    n_events = len(tr.log.history)

    runs = {"graphed": graph_epochs(tr, (0, 1), refresh),
            "eager": graph_epochs(eager, (0, 1), refresh)}
    (g, e) = runs["graphed"], runs["eager"]
    diff = first_difference(state_leaves(tr), state_leaves(eager))
    gen_equal = torch.equal(tr.generator.get_state(), eager.generator.get_state())
    next_words = [t._rng_words().tolist() for t in (tr, eager)]
    loss_diff = float((g["losses"] - e["losses"]).abs().max())
    for _ in range(2):          # the embedding graph: warm-up or capture, then a replay
        tr.movie_embeddings()
    emb_g, emb_e = tr.movie_embeddings(), eager.movie_embeddings()
    captures = [{k: v for k, v in ev.items() if k != "time"}
                for ev in tr.log.history[n_events:] if ev["event"] == "step_graph"]
    step_keys = {tuple(c["key"]) for c in captures if c["key"][0] == "step"}
    out = {"rung": rung(tr.pool_mats), "steps": int(g["losses"].numel()),
           "state_first_difference": diff, "losses_bitwise_equal": same_bits(g["losses"],
                                                                            e["losses"]),
           "loss_max_abs_diff": loss_diff, "generator_state_equal": gen_equal,
           "rng_words": g["rng_words"], "rng_words_equal": g["rng_words"] == e["rng_words"],
           "next_words": next_words, "launches": {"graphed": g["launches"],
                                                  "eager": e["launches"]},
           "embed_bitwise_equal": same_bits(emb_g, emb_e),
           # Reported only: a segment layout's rows past its totals are
           # unset memory, so a rebuilt gather layout differs there.
           "operators_rebuilt_bitwise_equal": rebuilt_equal,
           "graphs_alive": len(tr.graphs.graphs), "captures": captures}
    what = f"train_graph {out['rung']}"
    check(diff is None and out["losses_bitwise_equal"] and gen_equal
          and out["rng_words_equal"] and next_words[0] == next_words[1],
          f"{what}: graphed and eager differ: {json.dumps(out, default=str)}")
    check(g["launches"] == e["launches"], f"{what}: launches differ: {out['launches']}")
    check(len(step_keys) >= 2 and any(c["key"][0] == "embed" for c in captures),
          f"{what}: expected two step graphs and an embedding graph, captured {captures}")
    check(out["embed_bitwise_equal"], f"{what}: graphed embedding pass differs from eager "
          f"(max abs err {float((emb_g - emb_e).abs().max())})")

    q_all, p_all, _, _, num_hard = tr.epoch_batches(1)
    q, p = q_all[:1], p_all[:1]

    def step(t):
        return t.train_steps(q, p, t.plateau.lr, 1.0, num_hard)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    timing = {}
    for name, fns in (("step", (lambda: step(tr), lambda: step(eager))),
                      ("embed", (tr.movie_embeddings, eager.movie_embeddings))):
        walls = {"graphed": [], "eager": []}
        for _ in range(12):
            walls["eager"].append(wall(fns[1]))
            walls["graphed"].append(wall(fns[0]))
        for path, fn in zip(("graphed", "eager"), fns):
            med = statistics.median(walls[path])
            prof = device_profile(fn, calls=10)
            timing[f"{name}_{path}"] = {
                "wall_ms_median": med, "wall_ms_min": min(walls[path]),
                "wall_ms_max": max(walls[path]), "profile": prof,
                "busy_share_of_median_wall": (prof["device_ms"] or 0.0) / med}
    out["timing"] = timing
    out["pool_bytes"] = tr.graphs.pool_bytes
    cfg.train.max_pairs_per_epoch = pairs0
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_graph_phase(dev, hub_tr) -> dict:
    """``graph_twins`` on the gather rung with the CUDA kernels (4k,
    ``gather_impl=pallas``), the default config's dense rung (4k) and
    ``train_hub``'s ``hubf`` trainer (59k popularity tables, no refresh).
    Returns the gather rung's launch counts (replays counted)."""
    from movie_recommendation_engine_tpu_torch import api, default_config

    rungs = {}
    for name, overrides in (("gather", {"model.pool_impl": "gather",
                                        "model.gather_impl": "pallas"}),
                            ("dense", {})):
        cfg = default_config().override({"data.source": "synthetic", **overrides})
        eng = api.Engine(cfg, device=dev)
        eng.trainer.refresh_neighborhoods()
        rungs[name] = graph_twins(dev, eng.trainer, refresh=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    rungs["hubf"] = graph_twins(dev, hub_tr, refresh=False)
    check(rungs["gather"]["launches"]["graphed"]["gather_pool_bwd_segment"] > 0,
          "train_graph: the gather rung's graphed steps launched no segment backward")
    emit("train_graph", torch=torch.__version__, rungs=rungs)
    return rungs["gather"]["launches"]["graphed"]


# ---------------------------------------------------------------------------
# 8. PPR neighborhoods (walk.strategy=ppr)
# ---------------------------------------------------------------------------

def ppr_tables(tr):
    """The trainer's PPR build, called directly: (tables, seconds)."""
    from movie_recommendation_engine_tpu_torch.sampling import ppr

    cfg = tr.cfg
    restrict = (tr.data.num_movies
                if cfg.walk.count_nodes == "movies" and cfg.graph.use_bipartite_graph else None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables = ppr.all_node_neighborhood_tables_ppr(
        tr.graph, cfg.model.num_layers, cfg.walk.num_neighbors, num_nodes=tr.table_rows,
        restrict_below=restrict, alpha=cfg.walk.ppr_alpha,
        num_iterations=cfg.walk.ppr_iterations, batch=cfg.walk.ppr_batch)
    torch.cuda.synchronize()
    return tables, time.perf_counter() - t0


def ppr_builds(tr) -> list:
    return [e for e in tr.log.history if e["event"] == "ppr_tables"]


def ppr_phase(dev, walk_fit: dict) -> dict:
    """``walk.strategy=ppr`` at the default width on the serve phase's 4k
    corpus with ``pool_impl=gather``, ``gather_impl=pallas``: ``Engine.fit``
    for 2 epochs (launch counts zeroed just before and read just after)
    builds the tables once and launches the gather-pool forward and
    ``segment`` backward as the train phase does; a second build is
    bitwise equal; ``ppr_scores`` of 64 sources on the card within 1e-5 of
    the CPU's; one embedding pass timed; HR@10 beside the random-walk fit of
    the train phase (reported). Returns the fit's launch counts."""
    from movie_recommendation_engine_tpu_torch.sampling import ppr
    from movie_recommendation_engine_tpu_torch.sampling import random_walk as rw

    with tempfile.TemporaryDirectory() as d:
        eng, fit = fit_config(dev, {"walk.strategy": "ppr", "model.pool_impl": "gather",
                                    "model.gather_impl": "pallas",
                                    "search.search_method": "lsh"}, d)
    tr = eng.trainer
    cfg = tr.cfg
    launches, steps = fit["launches"], fit["adam_steps"]
    builds = ppr_builds(tr)
    check(len(builds) == 1, f"ppr: {len(builds)} table builds in a 2-epoch fit, expected 1")
    # A build pushes each chunk of sources once an iteration through the
    # gather-pool kernel.
    build_launches = -(-tr.table_rows // cfg.walk.ppr_batch) * cfg.walk.ppr_iterations
    check(launches["gather_pool_bwd"] == launches["gather_pool_bwd_segment"] == 2 * steps,
          f"ppr fit: gather_pool_bwd launched {launches} in {steps} steps: expected 2 a "
          "step, all on the segment route")
    check(launches["gather_pool"] == build_launches + 2 * steps + 2 * 2,
          f"ppr fit: gather_pool launched {launches['gather_pool']} times for one table "
          f"build ({build_launches} pushes), {steps} steps and 2 validation passes")
    nb, w = tr.nbr_tables[0]
    check(all(t[0] is nb for t in tr.nbr_tables), "ppr: layers do not share one table")
    zero_launches()
    again, build_s = ppr_tables(tr)
    check(read_launches()["gather_pool"] == build_launches,
          f"ppr: a build launched gather_pool {read_launches()['gather_pool']} times, "
          f"expected {build_launches}")
    check(torch.equal(again[0][0], nb) and same_bits(again[0][1], w),
          "ppr: a second build of the tables is not bitwise equal to the first")
    sentinel = tr.graph.num_nodes
    check(bool((w[nb == sentinel] == 0).all()), "ppr: a sentinel slot has weight")

    # The card's scores against the CPU's, 64 sources spread over the movies.
    n = tr.graph.num_nodes
    src = torch.linspace(0, tr.data.num_movies - 1, 64).long()
    card = ppr.ppr_scores(tr.graph, src.to(dev), n).cpu()
    cpu = ppr.ppr_scores(rw.device_graph(tr.csr, "cpu"), src, n)
    score_err = float((card - cpu).abs().max())
    check(score_err <= 1e-5, f"ppr_scores: card vs CPU max abs err {score_err}")
    mass = float(card.sum(1).max())
    check(mass <= 1.0 + 1e-5, f"ppr_scores: a source holds mass {mass}")

    pool_launches = read_launches()["gather_pool"]
    emb = eng.embeddings(refresh=True)
    check(read_launches()["gather_pool"] - pool_launches == 2,
          "ppr: one embedding pass did not launch gather_pool twice")
    check_embeddings(emb, (eng.data.num_movies, eng.cfg.model.embed_dim), "ppr")

    def embed():
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.movie_embeddings()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3
    embed_ms = statistics.median(embed() for _ in range(7))
    valid = nb < tr.valid_limit
    emit("ppr", corpus={"num_movies": eng.data.num_movies, "num_nodes": n,
                        "num_edges": tr.csr.num_edges, "table_rows": tr.table_rows},
         builds_in_fit=len(builds), build_s=build_s, build_launches=build_launches,
         tables_bitwise_equal=True,
         slots_valid_share=float(valid.float().mean()),
         self_first_share=float((nb[:, 0].long() == torch.arange(tr.table_rows, device=dev))
                                .float().mean()),
         scores_card_vs_cpu={"sources": 64, "max_abs_err": score_err, "max_mass": mass},
         fit=fit, embed={"ms": embed_ms, "profile": device_profile(tr.movie_embeddings, 10)},
         val_hit_rate_at_10={"ppr": [h["val_hit_rate@10"] for h in fit["history"]],
                             "random_walk": [h["val_hit_rate@10"] for h in walk_fit["history"]]})
    return launches


def push_timing(tr) -> dict:
    """One PPR push on the graph (512 frontier columns after two pushes),
    timed as in 2 at slices of 16, 32 and 64 edges: the gather-pool call
    over the slices beside its bound, the ``segment_reduce`` of a target's
    slices, and cuSPARSE's CSR x dense product of the same P^T (a library
    call; whether three calls repeat its bits); the share of masked slots;
    the ranking of a chunk's scores by the tie-ordered top-k and by ``topk``."""
    from movie_recommendation_engine_tpu_torch.core import roofline
    from movie_recommendation_engine_tpu_torch.core.ranking import top_k
    from movie_recommendation_engine_tpu_torch.ops import pool
    from movie_recommendation_engine_tpu_torch.sampling import ppr

    width0, out = ppr.SLICE, {}
    n = tr.graph.num_nodes
    edges = int(tr.graph.indices.shape[0])
    src = torch.arange(min(512, n), device=tr.graph.indptr.device)
    try:
        for width in (16, 32, 64):
            ppr.SLICE = width
            push = ppr.push_operator(tr.graph)
            r = ppr._ppr_columns(push, src, 0.15, 2).contiguous()
            s, b = push.nbrs.shape[0], r.shape[1]
            kern = cuda_ms(lambda: pool.gather_pool(r, push.nbrs, push.weights, n), iters=10)
            part = pool.gather_pool(r, push.nbrs, push.weights, n)
            seg = cuda_ms(lambda: torch.segment_reduce(part, "sum", lengths=push.slices),
                          iters=10)
            nbytes = n * b * 4 + s * width * 8 + s * b * 4
            ms, by = roofline.bound_ms(nbytes, (2 * edges * b, roofline.FP32_OPS_PER_S))
            out[f"slice{width}"] = {"slices": s, "masked_share": 1 - edges / (s * width),
                                    "gather_pool": kern, "segment_reduce": seg,
                                    "bound_ms": ms, "bound_by": by,
                                    "bound_share": ms / kern["ms"]}
        csr = ppr.push_operator(tr.graph)          # the library's operand: P^T in CSR
        rows = torch.repeat_interleave(torch.arange(n, device=src.device), csr.slices)
        keep = csr.nbrs < n
        ids = rows[:, None].expand_as(csr.nbrs)[keep]
        crow = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
        crow[1:] = torch.cumsum(torch.bincount(ids, minlength=n), 0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            lib = torch.sparse_csr_tensor(crow, csr.nbrs[keep].long(), csr.weights[keep],
                                          size=(n, n))
        out["library_cusparse"] = cuda_ms(lambda: lib @ r, iters=10)
        first = lib @ r
        out["library_cusparse"]["bitwise_repeats"] = all(
            same_bits(first, lib @ r) for _ in range(3))
        # Ranking a chunk's [512, N] scores: the tie-ordered top-k the build
        # takes, beside topk (whose order among equal scores is not JAX's).
        scores = r.t().contiguous()
        out["rank"] = {"tie_ordered_key": cuda_ms(lambda: top_k(scores, 50), iters=10),
                       "topk": cuda_ms(lambda: torch.topk(scores, 50, dim=1), iters=10)}
    finally:
        ppr.SLICE = width0
    return out


def ppr_at_scale_phase(hub_eng) -> dict:
    """The same build on ``train_hub``'s 59,393-movie corpus, twice: build
    seconds, gather-pool launches and peak device memory above what was held
    before; the only gate is that the two builds are bitwise equal. Then the
    rung ``pool_impl=auto`` picks on the PPR tables, with its build events
    (``dropped_mass``), and whether its embeddings are finite and unit-norm;
    one push timed (``push_timing``)."""
    tr = hub_eng.trainer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_launches()
    first, s1 = ppr_tables(tr)
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    build_launches = read_launches()["gather_pool"]
    second, s2 = ppr_tables(tr)
    nb, w = first[0]
    check(torch.equal(second[0][0], nb) and same_bits(second[0][1], w),
          "ppr at scale: two builds of the tables are not bitwise equal")
    del second
    push = push_timing(tr)
    start = len(tr.log.history)
    t0 = time.perf_counter()
    tr.set_neighborhood_tables(first)
    torch.cuda.synchronize()
    operators_s = time.perf_counter() - t0
    events = [{k: v for k, v in e.items() if k != "time"} for e in tr.log.history[start:]
              if e["event"].startswith(("hub_pool", "block_"))]
    rung = [type(pm).__name__ for pm in tr.pool_mats]
    emb = hub_eng.embeddings(refresh=True)
    norms = np.linalg.norm(emb, axis=1)
    out = {"embeddings_finite_unit_norm": bool(np.isfinite(emb).all()
                                               and np.allclose(norms, 1.0, atol=1e-2)),"num_nodes": tr.graph.num_nodes, "num_edges": tr.csr.num_edges,
           "table_rows": tr.table_rows, "build_s": [s1, s2], "bitwise_equal": True,
           "build_launches": build_launches,
           "peak_transient_gb": peak_gb, "slots_valid_share": float((nb < tr.valid_limit)
                                                                   .float().mean()),
           "auto_rung": rung, "operator_events": events, "operators_s": operators_s,
           "push": push}
    emit("ppr_at_scale", **out)
    return out


# ---------------------------------------------------------------------------
# 9. retrieval at scale: the search benchmark, IVF and both LSH forms
# ---------------------------------------------------------------------------

def same_ids(a_d, a_i, b_d, b_i, tol: float) -> int:
    """Fails unless two [Q, k] results list the same ids, except at
    positions whose two distances lie within ``tol`` (a near-tie that
    rounding may order either way); returns the count of such positions."""
    a_d, a_i, b_d, b_i = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                          for x in (a_d, a_i, b_d, b_i))
    diff = a_i != b_i
    check(bool((np.abs(a_d - b_d)[diff] <= tol).all()),
          f"ids differ beyond near-ties: {int(diff.sum())} positions")
    return int(diff.sum())


def retrieval_phase(dev, emb: np.ndarray, data) -> dict:
    """``benchmark_search_methods`` on ``train_hub``'s 59,393 x 128
    embeddings (256 queries, k = 10, the default search config), Hamming
    launches counted; then each index built again and its search timed on
    the device (``cuda_ms``, ``device_profile``), the ±1 LSH form beside the
    popcount kernel; gates: IVF's longest list within ceil(4 N / 100), IVF
    with every list probed returns exact search's ids, both LSH forms equal
    with and without rerank, a card-built IVF index copied to the CPU gives
    the same ids, and a ``BatchingRecommender`` with ``method="ivf"``
    answers threads and HTTP. Returns the Hamming kernel's launch count in
    the benchmark."""
    from movie_recommendation_engine_tpu_torch import default_config
    from movie_recommendation_engine_tpu_torch.ops import hamming
    from movie_recommendation_engine_tpu_torch.retrieval import bench, ivf, lsh
    from movie_recommendation_engine_tpu_torch.retrieval.server import BatchingRecommender

    cfg = default_config()
    n, k = emb.shape[0], 10
    qi = np.random.default_rng(0).choice(n, 256, replace=False)
    queries = emb[qi]
    methods = ["exact", "lsh", "lsh_rerank", "ivf"]
    hamming.LAUNCHES = 0
    t0 = time.perf_counter()
    res = bench.benchmark_search_methods(emb, queries, k=k, methods=methods, cfg=cfg,
                                         device=dev)
    bench_s = time.perf_counter() - t0
    ham_launches = hamming.LAUNCHES
    check(ham_launches > 0, "the Hamming kernel never launched in the search benchmark")
    harness = {m: {key: v for key, v in r.items() if key not in ("distances", "indices")}
               for m, r in res.items()}

    q = torch.as_tensor(queries, device=dev)
    x = torch.as_tensor(emb, device=dev)
    indexes = {m: bench.make_index(m, emb.shape[1], cfg, device=dev) for m in methods}
    indexes["lsh_pm"] = lsh.LSHIndex(emb.shape[1], cfg.search.lsh_bits, cfg.search.lsh_tables,
                                     device=dev, hamming_impl="matmul")
    indexes["lsh_rerank_pm"] = lsh.LSHIndex(emb.shape[1], cfg.search.lsh_bits,
                                            cfg.search.lsh_tables, rerank=100, device=dev,
                                            hamming_impl="matmul")
    parts = cfg.search.ivf_partitions
    indexes["ivf_full_probe"] = ivf.WeakANDIndex(emb.shape[1], num_partitions=parts,
                                                 nprobe=parts, device=dev)
    builds, out, timing = {}, {}, {}
    for name, index in indexes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.build(x)
        torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t0
        out[name] = index.search(q, k)
        t = cuda_ms(lambda index=index: index.search(q, k), iters=10)
        for _ in range(3):      # a window that recorded no kernel is taken again
            prof = device_profile(lambda index=index: index.search(q, k), calls=5)
            if prof["kernels_per_call"] > 0:
                break
        timing[name] = {**t, "per_query_ms": t["ms"] / q.shape[0],
                        "kernels_per_call": prof["kernels_per_call"],
                        "profile_wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                        "busy_share": prof["busy_share"], "top": prof["top"]}
    for plain, pm in (("lsh", "lsh_pm"), ("lsh_rerank", "lsh_rerank_pm")):
        check(torch.equal(indexes[plain].planes, indexes[pm].planes), f"{pm}: other planes")
        check(torch.equal(out[plain][1], out[pm][1]) and torch.equal(out[plain][0], out[pm][0]),
              f"{pm}: the ±1 form's ids or distances differ from the popcount form's")
    iv = indexes["ivf"]
    cap = -(-4 * n // parts)
    check(iv._max_list <= cap, f"IVF's longest list {iv._max_list} above the cap {cap}")
    full_ties = same_ids(*out["ivf_full_probe"], *out["exact"], tol=1e-5)
    cpu = ivf.WeakANDIndex(emb.shape[1], num_partitions=iv.num_partitions, nprobe=iv.nprobe,
                           candidates_factor=iv.candidates_factor, device="cpu")
    for name in ("_emb", "_norm2", "_perm", "_offsets", "_centroids"):
        setattr(cpu, name, getattr(iv, name).cpu())
    cpu._max_list = iv._max_list
    cpu_ties = same_ids(*out["ivf"], *cpu.search(queries, k), tol=1e-5)
    recall = {m: float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                                for a, b in zip(out[m][1].cpu().numpy(),
                                                out["exact"][1].cpu().numpy())]))
              for m in indexes}

    srv = BatchingRecommender(emb, method="ivf", cfg=cfg, max_batch=cfg.serve.max_batch,
                              max_wait_ms=cfg.serve.max_wait_ms, max_k=cfg.serve.max_k,
                              device=dev)
    try:
        srv.reset_stats()
        lat = drive_server(srv, n)
        http = http_roundtrip(srv, data)
        stats = srv.stats()
    finally:
        srv.close()
    check(stats["num_requests"] >= 32, f"IVF server: only {stats['num_requests']} requests")
    emit("retrieval", corpus={"rows": n, "dim": emb.shape[1], "queries": q.shape[0], "k": k},
         harness=harness, harness_s=bench_s, hamming_launches=ham_launches,
         builds_s=builds, search=timing, recall_at_10=recall,
         ivf={"max_list": iv._max_list, "cap": cap, "nprobe": iv.nprobe,
              "lists": iv.num_partitions, "full_probe_near_tie_positions": full_ties,
              "cpu_copy_near_tie_positions": cpu_ties},
         lsh_forms_equal=True,
         ivf_server={"requests": stats["num_requests"], "batches": stats["num_batches"],
                     "mean_batch": stats["mean_batch_size"],
                     "latency_ms_p50": stats["latency_ms_p50"],
                     "latency_ms_p99": stats["latency_ms_p99"],
                     "client_ms_p50": float(np.percentile(lat, 50)),
                     "client_ms_p99": float(np.percentile(lat, 99)), "http": http})
    return {"launches_retrieval": ham_launches,
            "ms_59k_q256": timing["lsh"]["ms"], "matmul_form_ms_59k_q256": timing["lsh_pm"]["ms"]}


# ---------------------------------------------------------------------------
# 9b. the serving searches as CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_FORMS = ("exact", "lsh", "lsh_rerank", "lsh_pm", "lsh_rerank_pm", "ivf")


def index_twins(form: str, emb: np.ndarray, cfg, dev) -> tuple:
    """A graphed index of ``form`` and its eager twin (``graphed = False``),
    each built on ``emb``; the twin gets the graphed index's hyperplanes
    and the same k-means initial rows. Fails unless the two builds are
    bitwise equal."""
    from movie_recommendation_engine_tpu_torch.retrieval import bench, exact, ivf, lsh

    d = emb.shape[1]
    init = ivf.init_indices(emb.shape[0], min(cfg.search.ivf_partitions, emb.shape[0]))

    def make(planes=None):
        if form == "exact":
            return exact.ExactIndex(d, device=dev)
        if form == "ivf":
            return bench.make_index("ivf", d, cfg, device=dev, init_idx=init)
        return lsh.LSHIndex(d, cfg.search.lsh_bits, cfg.search.lsh_tables,
                            rerank=100 if "rerank" in form else 0, planes=planes, device=dev,
                            hamming_impl="matmul" if form.endswith("_pm") else "popcount")
    graphed = make()
    eager = make(getattr(graphed, "planes", None))
    eager.graphed = False
    x = torch.as_tensor(emb, device=dev)
    for index in (graphed, eager):
        index.build(x)
    for name in ("_emb", "_sqnorm", "_sigs", "_sigs_pm", "_norm2", "_perm", "_offsets",
                 "_centroids"):
        a, b = getattr(graphed, name, None), getattr(eager, name, None)
        check((a is None) == (b is None) and (a is None or same_bits(a, b)),
              f"serve_graph {form}: two builds differ in {name}")
    check(graphed.graphed, f"serve_graph {form}: not graphed on the card")
    return graphed, eager


def first_difference_at(got, ref) -> dict | None:
    """The first output and position where two (distances, ids) differ in
    their bits, else None."""
    for j, name in ((1, "ids"), (0, "distances")):
        a, b = got[j], ref[j]
        if not same_bits(a, b):
            bits = [x.view(torch.int32) if x.dtype == torch.float32 else x for x in (a, b)]
            pos = tuple(torch.nonzero(bits[0] != bits[1])[0].tolist())
            return {"output": name, "position": list(pos), "graphed": float(a[pos]),
                    "eager": float(b[pos])}
    return None


def wall_ms(fn, calls: int = 10) -> float:
    """Median host wall (ms) of one call that ends on the host."""
    walls = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def graph_counts(before: dict | None = None) -> dict:
    """The wrappers' launch counts, less ``before``'s (the nonzero ones)."""
    from movie_recommendation_engine_tpu_torch.core import graphs

    now = dict(zip(graphs.COUNTER_NAMES, graphs.read_counts()))
    return now if before is None else {n: c - before[n] for n, c in now.items() if c - before[n]}


def graph_buckets(form: str, graphed, eager, emb: np.ndarray, buckets: list, sk: int) -> dict:
    """At every server bucket (k = the server's search_k) and at Q = 256
    (k = 10): the graphed index's first call (eager), second (capture,
    replay) and a replay on other queries, given on the host as the server
    gives them, under ``set_sync_debug_mode("error")``, each bitwise equal
    to the eager twin's, with the same launch counts; then both timed on
    host queries with the ids copied to the host, as the server calls a
    search (``wall_ms``, ``device_profile``). A profiler window must record
    at least the graph's kernel nodes (both ways run those kernels); one
    that falls short three times gives no device time, busy share or
    kernel count, and says so under ``unresolved``."""
    rng = np.random.default_rng(7)
    dev = graphed.device
    out = {}
    for q_rows, k in [(b, sk) for b in buckets] + [(256, 10)]:
        rows = rng.choice(emb.shape[0], 2 * q_rows, replace=False)
        q_np, q2_np = emb[rows[:q_rows]], emb[rows[q_rows:]]
        q, q2 = (torch.as_tensor(x, device=dev) for x in (q_np, q2_np))
        before = graph_counts()
        ref = [eager.search(x, k) for x in (q, q, q2)]
        torch.cuda.synchronize()
        eager_counts = graph_counts(before)
        before = graph_counts()
        got = [graphed.search(q, k), graphed.search(q, k)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got.append(graphed.search(q2_np, k))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        graphed_counts = graph_counts(before)
        for call, (a, b) in enumerate(zip(got, ref)):
            diff = first_difference_at(a, b)
            check(diff is None, f"serve_graph {form} Q={q_rows} k={k} call {call}: graphed "
                                f"differs from eager: {diff}")
        check(graphed_counts == eager_counts,
              f"serve_graph {form} Q={q_rows}: launches {graphed_counts} graphed, "
              f"{eager_counts} eager")
        nodes = [e["kernels"] for e in graphed.graphs.events if e["key"][1:3] == [q_rows, k]][-1]
        row = {"k": k, "launches_3_calls": graphed_counts, "graph_kernel_nodes": nodes}
        for mode, index in (("eager", eager), ("graphed", graphed)):
            def call(index=index):
                return index.search(q_np, k)[1].cpu()
            for _ in range(3):          # a window that lost device events is taken again
                prof = device_profile(call, calls=10)
                if prof["device_ms"] is not None and prof["kernel_launches_per_call"] >= nodes:
                    break
            row[mode] = {"wall_ms": wall_ms(call), "profile_wall_ms": prof["wall_ms"]}
            if prof["device_ms"] is not None and prof["kernel_launches_per_call"] >= nodes:
                row[mode].update({x: prof[x] for x in ("device_ms", "kernels_per_call",
                                                       "kernel_launches_per_call",
                                                       "busy_share")}, top=prof["top"][:3])
            else:
                row[mode].update(device_ms=None, kernels_per_call=None, busy_share=None,
                                 unresolved=f"{prof['kernel_launches_per_call']} kernels a "
                                            f"call recorded, {nodes} launched")
        out[f"q{q_rows}"] = row
    return out


def hamming_in_graph(dev, lsh_index, pm_index, sk: int, sm_clock_mhz: float) -> dict:
    """The Hamming kernel of the popcount search at 59k inside a CUDA graph:
    the graph's [Q, N] distances of the queries' signatures against
    ``hamming_distance_plain`` (max abs error 0), and the popcount search's
    replayed top-k against the plain distances' ``smallest_k``; the
    kernel's device time alone and replayed in its graph, its bound, its
    plain version and the ±1 ``torch.bmm`` + ``amax`` yardstick, at the
    server buckets Q = 1 and 64."""
    from movie_recommendation_engine_tpu_torch.core import graphs, roofline
    from movie_recommendation_engine_tpu_torch.ops import hamming

    t, w = lsh_index.num_tables, lsh_index.num_bits // 32
    sigs = lsh_index._sigs.reshape(-1, t * w)
    n = sigs.shape[0]
    rows = torch.as_tensor(np.random.default_rng(8).choice(n, 64, replace=False), device=dev)
    cache = graphs.GraphCache(dev, None, "hamming_graph")
    out = {}
    for q_rows in (1, 64):
        q = lsh_index._emb[rows[:q_rows]]
        qsig = lsh_index._signatures(q).reshape(q_rows, t * w)
        g = cache.capture(("hamming", q_rows),
                          lambda s: hamming.hamming_distance(s, sigs, t, w), (qsig,))
        cache.replay(g)
        plain = hamming.hamming_distance_plain(qsig, sigs, t, w)
        err = int((g.output - plain).abs().max().item())
        check(err == 0, f"hamming in a graph, 59k Q={q_rows}: max abs err {err}")
        for _ in range(2):              # the search graph of this key: replays
            d, i = lsh_index.search(q, sk)
        pd, pi = hamming.smallest_k(plain, sk)
        check(torch.equal(i, pi) and torch.equal(d, pd),
              f"popcount search graph, 59k Q={q_rows}: top-k differs from the plain distances'")
        kern = timed(lambda: hamming.hamming_distance(qsig, sigs, t, w))
        replay = cuda_ms(lambda: g.graph.replay())
        plain_t = cuda_ms(lambda: hamming.hamming_distance_plain(qsig, sigs, t, w),
                          iters=2, reps=3)
        q_pm = torch.where(pm_index._signs(q).permute(1, 0, 2), 1.0, -1.0).to(torch.bfloat16)
        s_pm = pm_index._sigs_pm
        lib_dist = (w * 32 - torch.bmm(q_pm, s_pm.transpose(1, 2)).float().amax(0)) / 2
        check(torch.equal(lib_dist.int(), plain), "±1 Hamming yardstick disagrees at 59k")
        lib = timed(lambda: torch.bmm(q_pm, s_pm.transpose(1, 2)).amax(0))
        bound = roofline.hamming_bound(q_rows, n, t, w, sm_clock_mhz)
        out[f"q{q_rows}"] = {"max_abs_err": err, "ms": kern["ms"],
                             "profiler_ms": kern["profiler_ms"], "host_us": kern["host_us"],
                             "graph_replay_ms": replay["ms"], "plain_ms": plain_t["ms"],
                             "library_ms": lib["ms"], "bound_ms": bound["ms"],
                             "bound_by": bound["by"], "bound_route": bound["route"],
                             "bound_share": bound["ms"] / kern["ms"],
                             "launches_a_replay": g.counts[-1]}
    return out


def server_check(srv, emb: np.ndarray, answers: list, exact: bool) -> int:
    """Every recorded answer against the server's own index run eager on
    the lone query, the exclusions applied as the server applies them:
    equal bit for bit (``exact``: requests sent one at a time, so each ran
    alone in bucket 1), else equal ids but at near-ties (1e-5: in a batch
    of other rows a GEMM may round a distance otherwise). Returns the
    near-tie positions."""
    from movie_recommendation_engine_tpu_torch.retrieval.server import _next_pow2

    index = srv.index
    was, index.graphed = index.graphed, False
    ties = 0
    try:
        for (kind, arg, k), got in answers:
            if kind == "item":
                q, excl = emb[arg], [arg]
            else:
                q = emb[arg].mean(axis=0)
                q /= max(float(np.linalg.norm(q)), 1e-12)
                excl = list(arg)
            need = k + len(excl)
            sk = (srv._search_k if need <= srv._search_k
                  else min(_next_pow2(need), srv.ntotal))
            d, i = (x.cpu().numpy()[0] for x in index.search(q[None], sk))
            keep = ~np.isin(i, excl) & (i >= 0)
            ref_i, ref_d = i[keep][:k], d[keep][:k]
            got_i = np.asarray(got["indices"])
            got_d = -np.asarray(got["scores"], np.float32)
            if exact:
                check(np.array_equal(got_i, ref_i) and np.array_equal(got_d, ref_d),
                      f"{srv.method} server: {kind} answered {got_i} / {got_d}, "
                      f"eager {ref_i} / {ref_d}")
            else:
                ties += same_ids(got_d[None], got_i[None], ref_d[None], ref_i[None], 1e-5)
    finally:
        index.graphed = was
    return ties


def graphed_server(emb: np.ndarray, data, method: str, cfg, dev) -> dict:
    """A ``BatchingRecommender`` on ``emb``: its warm-up must capture every
    bucket at the baseline ``search_k`` and log each capture; requests one
    at a time, two of them overflowing the exclusion headroom (a pow2
    ``search_k``: eager at its first use, captured by the worker at its
    second), each bitwise equal to the index's eager answer;
    ``drive_server`` and ``http_roundtrip`` on the graphed index, answers
    checked against eager search; then the same load on the index eager."""
    from movie_recommendation_engine_tpu_torch.ops import hamming
    from movie_recommendation_engine_tpu_torch.retrieval.server import BatchingRecommender

    t0 = time.perf_counter()
    srv = BatchingRecommender(emb, method=method, cfg=cfg, max_batch=cfg.serve.max_batch,
                              max_wait_ms=cfg.serve.max_wait_ms, max_k=cfg.serve.max_k,
                              device=dev)
    start_s = time.perf_counter() - t0
    index = srv.index
    try:
        warm = list(index.graphs.events)
        want = {(b, srv._search_k) for b in srv._bucket_sizes}
        check({tuple(e["key"][1:3]) for e in warm} == want and len(warm) == len(want),
              f"{method} server: warm-up captured {[e['key'] for e in warm]}")
        n = emb.shape[0]
        big = [int(x) for x in np.random.default_rng(9).choice(n, srv._search_k + 4,
                                                              replace=False)]
        asks = [("item", 0, 10), ("item", 5, 10), ("item", n - 1, 10), ("history", big, 10),
                ("history", big, 10), ("history", [3, 4, 5], 10)]
        answers = [((kind, arg, k), srv.recommend_by_item(arg, k=k) if kind == "item"
                    else srv.recommend_by_history(arg, k=k)) for kind, arg, k in asks]
        lazy = index.graphs.events[len(warm):]
        check(len(lazy) == 1 and lazy[0]["key"][2] > srv._search_k,
              f"{method} server: the large-exclusion key was not captured once: "
              f"{[e['key'] for e in lazy]}")
        server_check(srv, emb, answers, exact=True)
        load = {}
        for mode in ("graphed", "eager"):
            index.graphed = mode == "graphed"
            srv.reset_stats()
            ham0 = hamming.LAUNCHES
            got = []
            lat = drive_server(srv, n, per_thread=16, answers=got)
            http = http_roundtrip(srv, data) if mode == "graphed" else None
            stats = srv.stats()
            load[mode] = {"requests": stats["num_requests"], "batches": stats["num_batches"],
                          "mean_batch": stats["mean_batch_size"],
                          "latency_ms_p50": stats["latency_ms_p50"],
                          "latency_ms_p99": stats["latency_ms_p99"],
                          "client_ms_p50": float(np.percentile(lat, 50)),
                          "client_ms_p99": float(np.percentile(lat, 99)),
                          "hamming_launches": hamming.LAUNCHES - ham0}
            if mode == "graphed":
                load[mode]["http"] = http
                load[mode]["near_tie_positions"] = server_check(srv, emb, got, exact=False)
        index.graphed = True
        free, total = torch.cuda.mem_get_info()
        return {"method": method, "rows": n, "start_s": start_s,
                "captures": [{k: e[k] for k in ("key", "kernels", "capture_seconds",
                                                "pool_bytes_added")} for e in warm + lazy],
                "pool_bytes": index.graphs.pool_bytes, "load": load,
                "device_memory": {"reserved": torch.cuda.memory_reserved(),
                                  "free": free, "total": total}}
    finally:
        srv.close()


def serve_graph_phase(dev, emb: np.ndarray, data, serve_corpus: tuple,
                      sm_clock_mhz: float) -> dict:
    """The serving searches as CUDA graphs (``core/graphs.SearchGraphs``) on
    ``train_hub``'s 59,393 x 128 embeddings and the serve phase's 4k
    corpus: every index form and its eager twin (``index_twins``) at every
    server bucket and at Q = 256 (``graph_buckets``), the Hamming kernel
    inside the search graph (``hamming_in_graph``), and graphed servers for
    LSH at 4k and IVF at 59k (``graphed_server``). Returns the entries of
    the ``kernels`` line's Hamming row."""
    from movie_recommendation_engine_tpu_torch import default_config
    from movie_recommendation_engine_tpu_torch.retrieval.server import _buckets

    cfg = default_config()
    buckets = _buckets(cfg.serve.max_batch)
    sk = min(cfg.serve.max_k + 16, emb.shape[0])     # the server's baseline search_k
    summary, twins, ham_launches = {}, {}, 0
    for form in GRAPH_FORMS:
        t0 = time.perf_counter()
        graphed, eager = index_twins(form, emb, cfg, dev)
        build_s = time.perf_counter() - t0
        by_q = graph_buckets(form, graphed, eager, emb, buckets, sk)
        ham_launches += sum(r["launches_3_calls"].get("hamming_distance", 0)
                            for r in by_q.values())
        emit("serve_graph_form", form=form, build_s_both=build_s, buckets=by_q,
             captures=[{k: e[k] for k in ("key", "kernels", "capture_seconds",
                                          "pool_bytes_added")} for e in graphed.graphs.events],
             pool_bytes=graphed.graphs.pool_bytes)
        summary[form] = {q: {m: {x: row[m][x] for x in ("wall_ms", "device_ms", "busy_share")}
                             for m in ("eager", "graphed")} for q, row in by_q.items()}
        summary[form]["pool_bytes"] = graphed.graphs.pool_bytes
        twins[form] = graphed
    ham = hamming_in_graph(dev, twins["lsh"], twins["lsh_pm"], sk, sm_clock_mhz)
    del twins
    gc.collect()
    torch.cuda.empty_cache()
    servers = {"lsh_4k": graphed_server(*serve_corpus, "lsh", cfg, dev)}
    emit("serve_graph_server", **servers["lsh_4k"])
    servers["ivf_59k"] = graphed_server(emb, data, "ivf", cfg, dev)
    emit("serve_graph_server", **servers["ivf_59k"])
    emit("serve_graph", corpus={"rows": emb.shape[0], "dim": emb.shape[1]},
         buckets=buckets, search_k=sk,
         hamming_59k=ham, summary=summary,
         servers={name: {m: {x: v["load"][m][x] for x in ("latency_ms_p50", "latency_ms_p99")}
                         for m in ("graphed", "eager")} for name, v in servers.items()})
    entry = {"launches_serve_graph": ham_launches
             + servers["lsh_4k"]["load"]["graphed"]["hamming_launches"]}
    for q in ("q1", "q64"):
        for field in ("ms", "graph_replay_ms", "bound_ms", "plain_ms", "library_ms"):
            entry[f"{field}_59k_{q}"] = ham[q][field]
    return entry


# ---------------------------------------------------------------------------
# 9c. epoch_graph: the per-epoch programs as CUDA graphs
# ---------------------------------------------------------------------------

EPOCH_FIT_EPOCHS = 3


def no_sync(fn):
    """``fn()`` under ``set_sync_debug_mode("error")``: a host sync raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def same_tree(a, b) -> bool:
    from movie_recommendation_engine_tpu_torch.core.graphs import tensors

    ta, tb = tensors(a), tensors(b)
    return len(ta) == len(tb) and all(same_bits(x, y) for x, y in zip(ta, tb))


def both_ways(eager_fn, graphed_fn, nodes: int, calls: int = 5,
              profile_calls: int = 2) -> dict:
    """Wall per call (host clock to a synchronized end, median of ``calls``
    taken in turns) and the profiler's device time, kernels and busy share
    (windows of ``profile_calls`` calls), eager and graphed. A profiler window must record at least the graph's
    ``nodes`` kernels (both ways run them); one that falls short three
    times gives no device time and says so under ``unresolved``."""
    walls = {"eager": [], "graphed": []}
    for _ in range(calls):
        for mode, fn in (("eager", eager_fn), ("graphed", graphed_fn)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for mode, fn in (("eager", eager_fn), ("graphed", graphed_fn)):
        for _ in range(3):
            prof = device_profile(fn, calls=profile_calls)
            if prof["device_ms"] is not None and prof["kernel_launches_per_call"] >= nodes:
                break
        row = {"wall_ms": statistics.median(walls[mode]), "wall_ms_min": min(walls[mode]),
               "wall_ms_max": max(walls[mode])}
        if prof["device_ms"] is not None and prof["kernel_launches_per_call"] >= nodes:
            row.update({x: prof[x] for x in ("device_ms", "kernels_per_call",
                                             "kernel_launches_per_call")},
                       busy_share=prof["device_ms"] / row["wall_ms"], top=prof["top"][:3])
        else:
            row.update(device_ms=None, busy_share=None,
                       unresolved=f"{prof['kernel_launches_per_call']} kernels a call "
                                  f"recorded, {nodes} launched")
        out[mode] = row
    return out


class EpochSnapshots:
    """A quiet logger (``MetricsLogger`` on a string) that copies, at each
    epoch's record, the trainer's tables and params and the epoch's stats."""

    def __init__(self):
        from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger

        self.log = MetricsLogger(io.StringIO())
        self.log.log_epoch = self.log_epoch
        self.trainer = None
        self.epochs = []

    def log_epoch(self, epoch: int, **fields) -> None:
        from movie_recommendation_engine_tpu_torch.core import tree

        self.log.log("epoch", epoch=epoch, **fields)
        t = self.trainer
        self.epochs.append({
            "tables": [(nb.clone(), w.clone()) for nb, w in t.nbr_tables],
            "params": {k: v.detach().clone() for k, v in tree.flatten(t.params).items()},
            "val": {k: v for k, v in fields.items() if k.startswith("val_")
                    and k != "val_seconds"}, "stats": fields})


def fit_twins(dev, data, name: str, overrides: dict, ckpt_dir: str) -> dict:
    """A graphed trainer and an eager one (``graphed = False``) from one
    seed ``fit`` ``EPOCH_FIT_EPOCHS`` epochs (12 batches of 512 an epoch):
    per epoch the refresh (eager, then captured, then replayed), the step
    graphs, the embedding graph and the ranks graph. Gates: per epoch the
    tables, params and validation metrics bitwise equal, the generators'
    states equal at the end, the gather-pool launches equal, the refresh and
    ranks graphs captured, and one more refresh replay under sync debug mode
    "error" equal to the eager trainer's next refresh. Reports per epoch the
    refresh ms (the ``neighborhoods`` event), the validation ms and the
    step ms (mean after the first block), both ways."""
    from movie_recommendation_engine_tpu_torch import default_config
    from movie_recommendation_engine_tpu_torch.train.trainer import Trainer

    cfg = default_config().override({
        "data.source": "synthetic", "train.epochs": EPOCH_FIT_EPOCHS,
        "train.max_pairs_per_epoch": GRAPH_PAIRS, "paths.checkpoint_dir": ckpt_dir,
        **overrides})
    runs = {}
    for mode in ("graphed", "eager"):
        snaps = EpochSnapshots()
        tr = Trainer(cfg, data, logger=snaps.log, device=dev)
        snaps.trainer = tr
        tr.graphed = mode == "graphed"
        zero_launches()
        t0 = time.perf_counter()
        tr.fit()
        torch.cuda.synchronize()
        runs[mode] = {"trainer": tr, "snaps": snaps, "launches": read_launches(),
                      "fit_s": time.perf_counter() - t0}
    g, e = runs["graphed"], runs["eager"]
    what = f"epoch_graph {name}"
    per_epoch = []
    for i, (sg, se) in enumerate(zip(g["snaps"].epochs, e["snaps"].epochs)):
        row = {"tables_equal": same_tree(sg["tables"], se["tables"]),
               "params_first_difference": first_difference(sg["params"], se["params"]),
               "val_equal": sg["val"] == se["val"], "val": sg["val"]}
        for mode, s in (("graphed", sg), ("eager", se)):
            refresh = [ev["seconds"] for ev in runs[mode]["snaps"].log.history
                       if ev["event"] == "neighborhoods" and ev["epoch"] == i]
            row[mode] = {"refresh_ms": refresh[0] * 1e3 if refresh else None,
                         "val_ms": (s["stats"]["val_seconds"] * 1e3
                                    if "val_seconds" in s["stats"] else None),
                         "step_ms": s["stats"]["step_ms_avg"],
                         "epoch_ms": s["stats"]["epoch_seconds"] * 1e3}
        per_epoch.append(row)
        check(row["tables_equal"] and row["params_first_difference"] is None
              and row["val_equal"], f"{what} epoch {i}: graphed and eager differ: "
                                    f"{json.dumps(row, default=str)}")
    check(len(per_epoch) == EPOCH_FIT_EPOCHS, f"{what}: {len(per_epoch)} epochs recorded")
    gt, et = g["trainer"], e["trainer"]
    check(torch.equal(gt.generator.get_state(), et.generator.get_state()),
          f"{what}: the generators' states differ after the fit")
    check(g["launches"] == e["launches"],
          f"{what}: launches {g['launches']} graphed, {e['launches']} eager")
    captures = [{k: ev[k] for k in ("key", "kernels", "nodes", "capture_seconds",
                                     "pool_bytes_added")}
                for ev in g["snaps"].log.history if ev["event"] == "program_graph"]
    check({c["key"][0] for c in captures} == {"refresh", "ranks"},
          f"{what}: expected a refresh and a ranks graph, captured {captures}")
    # One more refresh: a replay with no host sync, equal to the eager one.
    tables = no_sync(gt.walk_tables)
    check(same_tree(tables, et.walk_tables()), f"{what}: a refresh replay differs from eager")
    out = {"rung": rung_of(gt.pool_mats), "epochs": per_epoch, "launches": g["launches"],
           "launches_eager": e["launches"], "fit_s": {m: runs[m]["fit_s"] for m in runs},
           "captures": captures, "step_graphs": len(gt.graphs.graphs),
           "program_pool_bytes": gt.graphs.programs.pool_bytes,
           "refresh_replay_no_sync": True}
    # A validation pass (the embedding graph, then the ranks graph) and the
    # refresh program (the walks, and on the dense rung its matrices) timed
    # both ways, each call in turns.
    nodes = {c["key"][0]: c["kernels"] for c in captures}
    vp = gt.val_pairs
    out["validation"] = both_ways(lambda: et.evaluate(vp), lambda: gt.evaluate(vp),
                                  nodes["ranks"], calls=7, profile_calls=5)
    out["refresh"] = both_ways(et.walk_tables, gt.walk_tables, nodes["refresh"], calls=7,
                               profile_calls=3)
    del runs, g, e, gt, et
    gc.collect()
    torch.cuda.empty_cache()
    return out


def refresh_at_scale(tr, rows: int, seed: int) -> dict:
    """The refresh of ``rows`` table rows on ``tr``'s graph at the config's
    width, graphed (its own ``GraphCache``) against eager from one
    generator state: the first graphed call (eager), the second (capture,
    replay) and a replay under sync debug mode "error" bitwise equal to the
    eager tables and leaving the generator as eager does; then wall, device
    time, kernels and busy share both ways, the capture and its pool bytes."""
    from movie_recommendation_engine_tpu_torch.core.graphs import GraphCache
    from movie_recommendation_engine_tpu_torch.sampling import random_walk as rw

    cfg = tr.cfg
    cache = GraphCache(tr.device)

    def walk(graphed: bool):
        return rw.all_node_neighborhood_tables(
            tr.graph, cfg.model.num_layers, cfg.walk.num_walks, cfg.walk.walk_length,
            cfg.walk.num_neighbors, tr.n_iters, generator=tr.generator, num_nodes=rows,
            restrict_below=tr._count_below(), graphs=cache, graphed=graphed)

    def from_seed(fn):
        tr.generator.manual_seed(seed)
        out = fn()
        torch.cuda.synchronize()
        return out, tr.generator.get_state()

    ref, state = from_seed(lambda: walk(False))
    got = [from_seed(lambda: walk(True)), from_seed(lambda: walk(True)),
           from_seed(lambda: no_sync(lambda: walk(True)))]
    for call, (tables, st) in enumerate(got):
        check(same_tree(tables, ref) and torch.equal(st, state),
              f"epoch_graph refresh {rows} rows, call {call}: graphed differs from eager")
    (ev,) = cache.events
    out = {"rows": rows, "graph_nodes": tr.graph.num_nodes,
           "graph_edges": int(tr.graph.indices.shape[0]), "n_iters": tr.n_iters,
           "chunks": -(-rows // 16384), "capture": {k: ev[k] for k in (
               "key", "kernels", "nodes", "capture_seconds", "pool_bytes_added")},
           "pool_bytes": cache.pool_bytes, "bitwise_equal": True, "no_sync_replay": True}
    out.update(both_ways(lambda: walk(False), lambda: walk(True), ev["kernels"]))
    check(cache.pool_bytes < 1 << 30,
          f"epoch_graph refresh {rows} rows: pool {cache.pool_bytes} bytes, not under 1 GiB")
    del cache
    return out, ref


def program_at_scale(dev, name: str, run) -> dict:
    """``run(graphed, cache)`` (a ranks, recommend or k-means call) graphed
    against eager: the first graphed call (eager), the second (capture,
    replay) and a replay under sync debug mode "error" bitwise equal to the
    eager output; then both timed (``both_ways``)."""
    from movie_recommendation_engine_tpu_torch.core.graphs import GraphCache

    cache = GraphCache(dev)
    ref = run(False, cache)
    got = [run(True, cache), run(True, cache), no_sync(lambda: run(True, cache))]
    for call, out in enumerate(got):
        check(same_tree(out, ref), f"epoch_graph {name}, call {call}: graphed differs "
                                   "from eager")
    (ev,) = cache.events
    out = {"capture": {k: ev[k] for k in ("key", "kernels", "nodes", "capture_seconds",
                                          "pool_bytes_added")},
           "bitwise_equal": True, "no_sync_replay": True}
    out.update(both_ways(lambda: run(False, cache), lambda: run(True, cache), ev["kernels"],
                         profile_calls=5))
    return out


def epoch_graph_phase(dev, serve_data, hub_tr, hub_emb: np.ndarray) -> dict:
    """The per-epoch programs as CUDA graphs (``core/graphs.GraphCache``):
    ``fit_twins`` on the serve corpus (4k) with ``gather_impl=pallas`` on the
    gather rung and with the default (dense) config; then on ``train_hub``'s
    bipartite graph (118,419 nodes) real walk tables at the default width,
    the trainer's refresh (59,393 rows) and all nodes' (118,419 rows), each
    graphed against eager (``refresh_at_scale``), beside the seconds of
    ``set_neighborhood_tables`` on the new tables (the pool operators' and
    layouts' build, the eager remainder of a refresh); ``_ranks`` over
    ``train_hub``'s val pairs, ``recommend`` at Q = 1 and 64 (k = 10) and
    k-means (100 lists, 15 iterations) on its 59,393 x 128 embeddings
    (``program_at_scale``). Returns the gather fit's launch counts."""
    from movie_recommendation_engine_tpu_torch.evaluation import metrics
    from movie_recommendation_engine_tpu_torch.retrieval import ivf

    t_phase = time.perf_counter()
    fits = {}
    with tempfile.TemporaryDirectory() as d:
        for name, overrides in (("gather", {"model.pool_impl": "gather",
                                            "model.gather_impl": "pallas"}), ("dense", {})):
            fits[name] = fit_twins(dev, serve_data, name, overrides, d)
    check(fits["gather"]["launches"]["gather_pool_bwd_segment"] > 0,
          "epoch_graph: the gather fit launched no segment backward")

    refresh, tables = {}, None
    for name, rows in (("trainer_rows", hub_tr.table_rows),
                       ("all_nodes", hub_tr.graph.num_nodes)):
        refresh[name], walked = refresh_at_scale(hub_tr, rows, seed=11)
        tables = walked if tables is None else tables
    del walked
    n0 = len(hub_tr.log.history)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hub_tr.set_neighborhood_tables(tables)
    torch.cuda.synchronize()
    refresh["set_tables_s"] = time.perf_counter() - t0
    refresh["rung"] = rung_of(hub_tr.pool_mats)
    refresh["builds"] = [{k: v for k, v in e.items() if k != "time"}
                         for e in hub_tr.log.history[n0:]
                         if e["event"].startswith(("hub_pool", "block_"))]
    del tables

    emb = torch.as_tensor(hub_emb, device=dev)
    n = emb.shape[0]
    pairs = hub_tr.val_pairs
    pairs = pairs[(pairs >= 0).all(axis=1) & (pairs < n).all(axis=1)]
    q, g = (torch.as_tensor(pairs[:, i], dtype=torch.int64, device=dev) for i in (0, 1))
    programs = {"ranks": program_at_scale(dev, "ranks", lambda graphed, c: metrics._ranks(
        emb, q, g, chunk=1024, graphs=c, graphed=graphed))}
    programs["ranks"]["queries"] = int(q.shape[0])
    for q_rows in (1, 64):
        qi = torch.arange(q_rows, device=dev) * (n // q_rows)
        programs[f"recommend_q{q_rows}"] = program_at_scale(
            dev, f"recommend Q={q_rows}", lambda graphed, c, qi=qi: metrics.recommend(
                emb, qi, k=10, graphs=c, graphed=graphed))
    programs["kmeans"] = program_at_scale(dev, "kmeans", lambda graphed, c: ivf.kmeans(
        emb, 100, 15, seed=0, graphs=c, graphed=graphed))
    out = {"fits": fits, "refresh_59k": refresh, "programs_59k": programs,
           "seconds": time.perf_counter() - t_phase}
    emit("epoch_graph", **out)
    return fits["gather"]["launches"]


def check_phase(dev) -> None:
    """The CUDA engine against the CPU engine (plain versions) on a small
    input with the same params and tables, float32 compute: the gather
    config; a ``pool_impl=hub`` config (head 32, residual 4, final layer
    hubbed) whose embedding pass takes the gather-pool kernel for both
    layers' residuals, the CPU engine given the card's hub operators; and a
    ``pool_impl=block``, ``block_pool_order="feature"`` config (k-means on
    the card), the CPU engine given the card's node order, whose last layer
    takes the kernel."""
    from movie_recommendation_engine_tpu_torch import api, small_test_config
    from movie_recommendation_engine_tpu_torch.ops import block_sparse as bsp
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
    block = {"model.pool_impl": "block", "model.block_pool_order": "feature",
             "model.block_pool_block_size": 32, "model.block_pool_max_dropped_mass": 1.0}
    out = {}
    for name, over, expect in (("gather", {"model.pool_impl": "gather"}, 2), ("hub", hub, 2),
                               ("block_feature", block, 1)):
        cfg = small_test_config().override({**base, **over})
        gpu = api.Engine(cfg, device=dev)
        cpu = api.Engine(cfg, device="cpu")
        gpu.trainer.refresh_neighborhoods()
        cpu.trainer.params = to_cpu(gpu.trainer.params)
        if name == "block_feature":
            check(isinstance(gpu.trainer.pool_mats[0], bsp.BlockPool),
                  "check: pool_impl=block built no BlockPool")
            cpu.trainer._block_perm = gpu.trainer._block_perm
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
        check(launches == expect, f"check {name}: gather_pool launched {launches} times in "
                                  f"one embedding pass, expected {expect}")
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
        if name == "block_feature":
            # Whether the CPU's k-means gives the card's order (reported:
            # the two sum a cluster's rows in another order).
            m = cfg.model
            out[name]["cpu_order_equal"] = bool(np.array_equal(
                bsp.cluster_permutation(cpu.trainer.x_table, num_clusters=m.block_pool_clusters,
                                        seed=cfg.train.seed), gpu.trainer._block_perm))
    emit("check", tolerance=1e-4, **out)


# ---------------------------------------------------------------------------
# 11. MovieLens CSVs: the default config as a MovieLens user runs it
# ---------------------------------------------------------------------------

# MovieLens-25M as published (its README): the CSVs written here hold
# train_hub's synthetic corpus instead, because generating 25M ratings does
# not fit the run.
ML_25M = {"movies": 62423, "users": 162541, "ratings": 25_000_095}
NA_TAGS = ("NA", "null", "None", "n/a", "")


def write_movielens(d: str, seed: int) -> dict:
    """train_hub's synthetic corpus as MovieLens CSVs in ``d``, quoted as
    MovieLens quotes them (a tenth of the titles carry a comma, another tenth
    quotes), every 50th tag one of pandas' NA strings, ``imdbId`` with
    leading zeros and every 7th ``tmdbId`` empty. Returns the columns the
    reader must give (``dataset._from_columns``'s input)."""
    import csv

    from movie_recommendation_engine_tpu_torch.graph import synthetic

    raw = synthetic.generate(num_movies=HUB_CORPUS["data.synthetic_num_movies"],
                             num_users=HUB_CORPUS["data.synthetic_num_users"],
                             num_ratings=HUB_CORPUS["data.synthetic_num_ratings"], seed=seed)
    titles = list(raw["titles"])
    for start, fmt in ((0, "{}, The ({}"), (5, '{} "Redux" ({}')):
        for i in range(start, len(titles), 10):
            titles[i] = fmt.format(*titles[i].rsplit(" (", 1))
    raw["titles"] = titles
    with open(os.path.join(d, "movies.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["movieId", "title", "genres"])
        w.writerows(zip(raw["movie_ids"].tolist(), titles, raw["genres"]))
    cols = [raw[k].tolist() for k in ("rating_user_ids", "rating_movie_ids", "rating_values",
                                      "rating_timestamps")]
    with open(os.path.join(d, "ratings.csv"), "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        f.writelines(f"{u},{m},{r:.1f},{t}\n" for u, m, r, t in zip(*cols))
    tags = raw["tag_values"].tolist()
    for j, i in enumerate(range(0, len(tags), 50)):
        tags[i] = NA_TAGS[j % len(NA_TAGS)]
    with open(os.path.join(d, "tags.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["userId", "movieId", "tag", "timestamp"])
        w.writerows(zip(raw["tag_user_ids"].tolist(), raw["tag_movie_ids"].tolist(), tags,
                        range(len(tags))))
    raw["tag_values"] = np.array(["nan" if t in NA_TAGS else t for t in tags], dtype=object)
    n = raw["movie_ids"].shape[0]
    imdb = np.arange(n, dtype=np.int64) * 7 + 1
    tmdb = np.where(np.arange(n) % 7 == 0, -1, np.arange(n, dtype=np.int64) + 10)
    with open(os.path.join(d, "links.csv"), "w") as f:
        f.write("movieId,imdbId,tmdbId\n")
        f.writelines(f"{m},{i:07d},{'' if t < 0 else t}\n"
                     for m, i, t in zip(raw["movie_ids"].tolist(), imdb.tolist(), tmdb.tolist()))
    raw.update(link_movie_ids=raw["movie_ids"], link_imdb=imdb, link_tmdb=tmdb)
    return raw


def check_same_data(got, ref, what: str) -> None:
    for name in ("user_idx", "movie_idx", "ratings", "timestamps", "movie_ids", "user_ids",
                 "imdb_ids", "tmdb_ids"):
        check(np.array_equal(getattr(got, name), getattr(ref, name)), f"{what}: {name} differs")
    for name in ("titles", "genres", "movie_tags"):
        check(getattr(got, name) == getattr(ref, name), f"{what}: {name} differ")


def rung_of(pool_mats) -> str:
    from movie_recommendation_engine_tpu_torch.ops.block_sparse import BlockPool
    from movie_recommendation_engine_tpu_torch.ops.hub_pool import HubPool

    kinds = [type(pm) for pm in pool_mats]
    if not kinds:
        return "gather"
    if kinds[0] is HubPool:
        return "hubf" if len(kinds) == 2 else "hub"
    if kinds[0] is BlockPool:
        return "block"
    return "dense" if len(kinds) == 2 else "hybrid"


def movielens_fit(dev, cfg):
    """``api.Engine`` on the CSVs and ``fit`` (launch counts zeroed just
    before, read just after): (engine, its log, fit summary)."""
    from movie_recommendation_engine_tpu_torch import api
    from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger

    log = MetricsLogger(stream=io.StringIO())
    t0 = time.perf_counter()
    eng = api.Engine(cfg, logger=log, device=dev)
    init_s = time.perf_counter() - t0
    zero_launches()
    t0 = time.perf_counter()
    out = eng.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    hist = out["history"]
    check(bool(hist) and all(np.isfinite(h["loss"]) for h in hist), f"movielens fit loss {hist}")
    tr = eng.trainer
    builds = [{k: v for k, v in e.items() if k != "time"} for e in log.history
              if e["event"].startswith(("hub_pool", "block_", "ingest", "cooc"))]
    return eng, log, {"init_s": init_s, "fit_s": fit_s, "adam_steps": int(tr.opt_state.step),
                      "rung": rung_of(tr.pool_mats), "builds": builds, "launches": launches,
                      "loss": [h["loss"] for h in hist],
                      "val_hit_rate@10": [h.get("val_hit_rate@10") for h in hist]}


def walk_table_checks(dev, tr, what: str) -> dict:
    """Both gather-pool kernels on a trainer's own layer-0 walk table, every
    row (sentinel-only rows included), and on 1524 of its rows as a batch
    layer reads them, in f32 and bf16: every forward route against
    ``gather_pool_plain`` (1e-4), the segment backward bitwise against
    ``gather_pool_bwd_segment_plain``."""
    from movie_recommendation_engine_tpu_torch.ops import pool

    gen = torch.Generator(device=dev).manual_seed(5)
    n, limit = tr.table_rows, tr.valid_limit
    out = {"sentinel_only_rows": int((tr.nbr_tables[0][0] >= limit).all(dim=1).sum())}
    for name, rows in {f"layer0_b{n}": torch.arange(n, device=dev),
                       "batch_b1524": torch.randint(0, n, (1524,), generator=gen,
                                                    device=dev)}.items():
        for dtype in (torch.float32, torch.bfloat16):
            table, nbrs, w, g = bwd_inputs(gen, tr, rows, limit, dtype)
            key = f"{name}_{str(dtype)[6:]}"
            out[key] = {
                "forward_max_abs_err": check_pool_routes(pool, table, nbrs, w, limit,
                                                         f"{what} {key}"),
                "segment_max_abs_err": check_segment(pool, table, nbrs, w, limit, g,
                                                     f"{what} {key}")}
    return out


def path_kernel_checks(dev, tr, what: str) -> dict:
    """Both gather-pool kernels held against their plain versions on the
    inputs a fitted trainer's rung gives them: each hub layer's residual
    (``hub_kernel_times``: layer 0 over every row, the batch layer over 1524),
    else the walk table (``walk_table_checks``)."""
    from movie_recommendation_engine_tpu_torch.ops.hub_pool import HubPool

    hubs = [pm for pm in tr.pool_mats if isinstance(pm, HubPool)]
    if not hubs:
        check(not tr.pool_mats, f"{what}: the rung {rung_of(tr.pool_mats)} runs no gather layer")
        return {"walk_table": walk_table_checks(dev, tr, what)}
    n, hidden = tr.table_rows, tr.cfg.model.hidden_dim
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {f"hub_layer0_b{n}_k{hubs[0].res_nbrs.shape[1]}": hub_kernel_times(
        dev, hubs[0], n, hidden, torch.arange(n, device=dev), f"{what} hub layer 0")}
    if len(hubs) > 1:
        out[f"hub_batch_b1524_k{hubs[1].res_nbrs.shape[1]}"] = hub_kernel_times(
            dev, hubs[1], n, hidden, torch.randint(0, n, (1524,), generator=gen, device=dev),
            f"{what} hub batch layer")
    return out


def movielens_phase(dev, d: str) -> dict:
    """Writes the CSVs, loads them through ``dataset.load`` at num_workers 1
    and 4 (equal to ``_from_columns`` of the written columns, native route),
    times the stdlib reader, then runs the default config on ``cuda`` with
    ``gather_impl=pallas`` and ``search_method=lsh``: ``fit`` 1 epoch of 4
    steps, whose ``pool_impl=auto`` rung must launch both gather-pool kernels
    (else the same with ``pool_impl=hub``); a train step's device time;
    ``evaluate``, ``recommend`` and an LSH server (the Hamming kernel); exact
    search at Q = 256 with the tie-ordered top-k beside ``torch.topk``.
    Returns the kernels line's extra fields."""
    from movie_recommendation_engine_tpu_torch import default_config
    from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
    from movie_recommendation_engine_tpu_torch.graph import dataset
    from movie_recommendation_engine_tpu_torch.ops import hamming
    from movie_recommendation_engine_tpu_torch.retrieval.exact import ExactIndex
    from movie_recommendation_engine_tpu_torch.utils import ingest_native

    base = default_config()
    seed = base.data.synthetic_seed if base.data.synthetic_seed >= 0 else base.train.seed
    t0 = time.perf_counter()
    raw = write_movielens(d, seed)
    write_s = time.perf_counter() - t0
    cfg = base.override({"data.data_dir": d, "model.gather_impl": "pallas",
                         "search.search_method": "lsh", "train.epochs": 1,
                         "train.max_pairs_per_epoch": 2048,
                         "paths.checkpoint_dir": os.path.join(d, "ck"),
                         "paths.output_dir": os.path.join(d, "out")})
    check(cfg.data.source == "movielens", "the default config's source is not movielens")
    ref = dataset._from_columns(raw, cfg)
    t0 = time.perf_counter()
    ingest_native._lib()                  # g++ at first use, outside the timed loads
    build_s = time.perf_counter() - t0
    loads = {}
    for workers in (1, 4):
        log = MetricsLogger(stream=io.StringIO())
        t0 = time.perf_counter()
        data = dataset.load(cfg.override({"train.num_workers": workers}), log)
        load_s = time.perf_counter() - t0
        (ev,) = [e for e in log.history if e["event"] == "ingest"]
        check(ev["route"] == "native", f"ratings.csv took the {ev['route']} route: {ev['reason']}")
        check_same_data(data, ref, f"movielens load at num_workers {workers}")
        loads[f"num_workers_{workers}"] = {"load_s": load_s, "parse_s": ev["seconds"],
                                           "rows": ev["rows"],
                                           "parse_rows_per_s": ev["rows"] / ev["seconds"]}
    t0 = time.perf_counter()
    plain = dataset.read_ratings_python(os.path.join(d, "ratings.csv"))
    plain_s = time.perf_counter() - t0
    check(plain[0].shape[0] == loads["num_workers_1"]["rows"], "stdlib reader: row count")
    del plain

    eng, log, fit = movielens_fit(dev, cfg)
    hub_rerun = None
    if fit["launches"]["gather_pool"] == 0:
        # auto's rung ran no gather layer: the same steps on the hub rung,
        # whose residual does.
        del eng
        eng, log, hub_rerun = movielens_fit(dev, cfg.override({"model.pool_impl": "hub"}))
    kernel_fit = hub_rerun or fit
    launches = kernel_fit["launches"]
    check(launches["gather_pool"] > 0 and launches["gather_pool_bwd_segment"] > 0,
          f"movielens fit launched {launches}: expected both gather-pool kernels")
    tr = eng.trainer
    n = eng.data.num_movies
    kernel_checks = path_kernel_checks(dev, tr, "movielens")

    pairs = tr._epoch_pairs(np.random.default_rng(0))
    q = torch.as_tensor(pairs[0, :, 0], dtype=torch.int32, device=dev)
    p = torch.as_tensor(pairs[0, :, 1], dtype=torch.int32, device=dev)

    def step_ms():
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.train_steps(q[None], p[None], tr.plateau.lr, 1.0, 0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3
    walls = [step_ms() for _ in range(6)]
    prof = device_profile(lambda: tr.train_steps(q[None], p[None], tr.plateau.lr, 1.0, 0),
                          calls=3)
    step = {"step_wall_ms_median": statistics.median(walls[1:]), "step_wall_ms": walls,
            "profile": prof,
            "busy_share_of_median_wall": (prof["device_ms"] or 0.0) / statistics.median(walls[1:])}

    metrics = eng.evaluate()
    check(all(np.isfinite(v) for k, v in metrics.items() if k.startswith(("hit", "mrr"))),
          f"movielens evaluate: {metrics}")
    mid = int(eng.data.movie_ids[3])
    recs = eng.recommend(movie_id=mid, k=10)
    check(len(recs) == 10 and all(r["movieId"] != mid for r in recs), "movielens recommend")
    emb = eng.embeddings(refresh=True)
    check_embeddings(emb, (n, cfg.model.embed_dim), "movielens embeddings")
    hamming.LAUNCHES = 0
    srv = eng.serve()
    try:
        lat = drive_server(srv, n, threads=4, per_thread=4)
        stats = srv.stats()
    finally:
        srv.close()
    ham = hamming.LAUNCHES
    check(ham > 0, "the Hamming kernel never launched behind the movielens LSH server")

    # Exact search, 256 queries: the tie-ordered top-k (``torch.topk`` of a
    # unique int64 key) beside a stable sort of all N cut to k (the same
    # order) and plain torch.topk on the same distances.
    x = torch.as_tensor(emb, device=dev)
    qx = x[torch.as_tensor(np.random.default_rng(1).choice(n, 256, replace=False), device=dev)]
    index = ExactIndex(x.shape[1], device=dev)
    index.build(x)
    sq = (x * x).sum(dim=1)

    def dists():
        return (qx * qx).sum(dim=1, keepdim=True) + sq[None, :] - 2.0 * (qx @ x.T)

    def sort_search():
        d_s, i_s = torch.sort(dists(), dim=1, stable=True)
        return d_s[:, :10], i_s[:, :10]
    exact = {"tie_ordered_key": cuda_ms(lambda: index.search(qx, 10), iters=10),
             "stable_sort": cuda_ms(sort_search, iters=10),
             "topk": cuda_ms(lambda: torch.topk(dists(), 10, dim=1, largest=False), iters=10)}
    got, ref = index.search(qx, 10), sort_search()
    check(torch.equal(got[1], ref[1]) and same_bits(got[0], ref[0]),
          "exact search: the keyed top-k differs from the stable sort's order")
    exact["tie_positions"] = same_ids(*got, *torch.topk(dists(), 10, dim=1, largest=False),
                                      tol=0.0)
    emit("movielens", corpus={"num_movies": n, "num_users": eng.data.num_users,
                              "interactions": eng.data.num_interactions,
                              "ratings_rows": loads["num_workers_1"]["rows"],
                              "tags": int(raw["tag_values"].shape[0]), **HUB_CORPUS,
                              "ml_25m_published": ML_25M},
         write_s=write_s, parser_build_s=build_s, loads=loads, plain_reader_s=plain_s,
         fit=fit, hub_rerun=hub_rerun, kernel_checks=kernel_checks, step=step,
         evaluate=metrics,
         server={"requests": stats["num_requests"], "latency_ms_p50": stats["latency_ms_p50"],
                 "latency_ms_p99": stats["latency_ms_p99"],
                 "client_ms_p50": float(np.median(lat)), "hamming_launches": ham},
         exact_search_q256=exact)
    return {"gather_pool": {"launches_movielens": launches["gather_pool"]},
            "gather_pool_bwd": {"launches_movielens": launches["gather_pool_bwd"],
                                "launches_movielens_segment":
                                    launches["gather_pool_bwd_segment"]},
            "hamming_distance": {"launches_movielens": ham}}


# ---------------------------------------------------------------------------
# 12. the co-occurrence graph on the same CSVs
# ---------------------------------------------------------------------------

def cooc_phase(dev, d: str) -> dict:
    """``graph.use_bipartite_graph=False`` on the MovieLens CSVs: the native
    counter's pairs and counts must equal the numpy counter's (both timed
    alone), then ``fit`` 2 steps with ``pool_impl=gather``,
    ``gather_impl=pallas``, whose graph build must take the native route
    (finite loss, both gather-pool kernels launched), and both kernels held
    against their plain versions on the fitted trainer's walk table."""
    from movie_recommendation_engine_tpu_torch import default_config
    from movie_recommendation_engine_tpu_torch.graph import builders, dataset
    from movie_recommendation_engine_tpu_torch.utils import cooc_native

    cfg = default_config().override({
        "data.data_dir": d, "graph.use_bipartite_graph": False, "model.pool_impl": "gather",
        "model.gather_impl": "pallas", "train.epochs": 1, "train.max_pairs_per_epoch": 1024,
        "paths.checkpoint_dir": os.path.join(d, "ck_cooc")})
    data = dataset.load(cfg)
    cooc_native._lib()                    # g++ at first use, outside the timed count
    # The two counters alone, on the grouped columns the builder counts.
    order = np.argsort(data.user_idx, kind="stable")
    u_s = data.user_idx[order].astype(np.int64)
    m_s = data.movie_idx[order].astype(np.int64)
    counts, seconds = {}, {}
    for route, count in (("native", cooc_native.count_cooccurrence),
                         ("numpy", builders.cooccurrence_counts)):
        t0 = time.perf_counter()
        counts[route] = count(u_s, m_s, data.num_movies, cfg.graph.similarity_threshold)
        seconds[route] = time.perf_counter() - t0
    keys = {route: np.asarray(i, np.int64) * data.num_movies + np.asarray(j, np.int64)
            for route, (i, j, _) in counts.items()}
    by = {route: np.argsort(k) for route, k in keys.items()}
    check(np.array_equal(keys["native"][by["native"]], keys["numpy"][by["numpy"]])
          and np.array_equal(counts["native"][2][by["native"]],
                             counts["numpy"][2][by["numpy"]].astype(np.float32)),
          "cooc: the native counter's pairs or counts differ from the numpy counter's")
    pairs = int(keys["native"].shape[0])
    del counts, keys, by
    eng, log, fit = movielens_fit(dev, cfg)
    (ev,) = [e for e in log.history if e["event"] == "cooc"]
    check(ev["route"] == "native", f"cooc took the {ev['route']} route: {ev['reason']}")
    graph = eng.trainer.csr
    check(ev["pairs"] == pairs and graph.num_edges == 2 * pairs,
          f"cooc: the engine's graph has {graph.num_edges} edges for {pairs} counted pairs")
    seconds["build_in_engine"] = ev["seconds"]
    launches = fit["launches"]
    check(launches["gather_pool"] > 0 and launches["gather_pool_bwd_segment"] > 0,
          f"cooc fit launched {launches}: expected both gather-pool kernels")
    kernel_checks = path_kernel_checks(dev, eng.trainer, "cooc")
    emit("cooc", num_movies=data.num_movies, interactions=data.num_interactions,
         threshold=cfg.graph.similarity_threshold, edges=graph.num_edges, pairs=pairs,
         count_s=seconds, isolated_movies=int((graph.degrees == 0).sum()), fit=fit,
         kernel_checks=kernel_checks)
    return {"gather_pool": {"launches_cooc": launches["gather_pool"]},
            "gather_pool_bwd": {"launches_cooc": launches["gather_pool_bwd"],
                                "launches_cooc_segment": launches["gather_pool_bwd_segment"]}}


# ---------------------------------------------------------------------------
# 13. the aggregator zoo and the edge forward
# ---------------------------------------------------------------------------

AGG_KINDS = (("mean", {}), ("weighted", {}), ("attention", {}), ("max", {}),
             ("importance_transform", {}),
             ("importance_bn", {"model.aggregator_type": "importance",
                                "model.use_batch_norm": True}))


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.detach().to(dev, copy=True)


def agg_step_vs_cpu(gpu, cpu, q, p) -> dict:
    """One step on the card and on the CPU (the plain versions) from the
    same params, tables and draws, f32: the loss within 1e-4 relative, each
    gradient leaf within 1e-3 of the larger of its norm and 1e-3 of the
    largest leaf norm, and the updated params within 2 lr. Adam's first
    step moves each param by about lr times the sign of its gradient, so a
    param whose gradient lies within rounding of zero may step either way:
    every param that differs by more than 1e-5 must have a gradient below
    1e-4 of its leaf's largest (or 1e-6 absolute) on the CPU."""
    from movie_recommendation_engine_tpu_torch.core import tree
    from movie_recommendation_engine_tpu_torch.train import optim
    from movie_recommendation_engine_tpu_torch.train.trainer import StepDraws

    d = gpu.draw_step(q, num_hard=1)
    keep = [torch.rand((gpu.table_rows, gpu.cfg.model.hidden_dim), generator=gpu.generator,
                       device=q.device) < 1 - gpu.cfg.model.dropout]
    draws = {"gpu": [StepDraws(d.random, d.hard, keep)],
             "cpu": [StepDraws(d.random.cpu(), d.hard.cpu(), [k.cpu() for k in keep])]}
    cpu.params = to_device(gpu.params, "cpu")
    cpu.opt_state = optim.AdamState(gpu.opt_state.step.cpu(), to_device(gpu.opt_state.mu, "cpu"),
                                    to_device(gpu.opt_state.nu, "cpu"))
    res = {}
    for name, tr in (("gpu", gpu), ("cpu", cpu)):
        qq, pp = q.to(tr.device), p.to(tr.device)
        t0 = time.perf_counter()
        loss, grads = tr.loss_and_grads(qq, pp, draws[name][0], 1.0)
        tr.train_steps(qq[None], pp[None], tr.plateau.lr, 1.0, 1, draws=draws[name])
        if name == "gpu":
            torch.cuda.synchronize()
        res[name] = (loss.item(), {k: v.cpu() for k, v in tree.flatten(grads).items()},
                     {k: v.cpu() for k, v in tree.flatten(tr.params).items()},
                     time.perf_counter() - t0)
    (lg, gg, pg, _), (lc, gc, pc, cpu_s) = res["gpu"], res["cpu"]
    lr = gpu.plateau.lr
    top = max(float(v.norm()) for v in gc.values())
    grad_rel = max(float((gg[k] - gc[k]).norm()) / max(float(gc[k].norm()), 1e-3 * top)
                   for k in gc)
    diffs = torch.cat([(pg[k] - pc[k]).abs().reshape(-1) for k in pc])
    over = int((diffs > 1e-5).sum())
    unexplained = sum(int(((pg[k] - pc[k]).abs() > 1e-5).logical_and(
        gc[k].abs() > max(1e-4 * float(gc[k].abs().max()), 1e-6)).sum()) for k in pc)
    out = {"loss_gpu": lg, "loss_cpu": lc, "loss_rel_diff": abs(lg - lc) / abs(lc),
           "grad_max_rel_norm_diff": grad_rel, "param_max_abs_diff": float(diffs.max()),
           "params_over_1e-5": over, "params_over_1e-5_with_gradient": unexplained,
           "params": int(diffs.numel()), "cpu_step_s": cpu_s}
    check(out["loss_rel_diff"] <= 1e-4, f"aggregator step, card vs CPU loss: {out}")
    check(grad_rel <= 1e-3, f"aggregator step, card vs CPU gradients: {out}")
    check(float(diffs.max()) <= 2 * lr and unexplained == 0,
          f"aggregator step, card vs CPU updated params: {out}")
    return out


def edge_forward_check(dev, tr) -> dict:
    """``edge_forward`` over the bipartite graph (every node, random f32
    features at the model's input width, the ratings as edge weights): two
    bf16 calls on the card bitwise equal and launching the gather-pool
    kernel once a conv; the card's f32 call within 1e-4 of the CPU's (plain
    versions); the message sum against ``index_add_`` (its plain version)
    and both timed."""
    from movie_recommendation_engine_tpu_torch.models import pinsage
    from movie_recommendation_engine_tpu_torch.ops import pool

    csr = tr.csr
    n = csr.num_nodes
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((n, tr.cfg.features.feature_dim), generator=gen, device=dev)
    src = torch.repeat_interleave(torch.arange(n, device=dev),
                                  torch.as_tensor(np.diff(csr.indptr), device=dev))
    dst = torch.as_tensor(csr.indices, device=dev)
    w = torch.as_tensor(csr.weights, device=dev)
    pool.LAUNCHES = 0
    a = pinsage.edge_forward(tr.params, x, src, dst, w, dtype=torch.bfloat16)
    launches = pool.LAUNCHES
    b = pinsage.edge_forward(tr.params, x, src, dst, w, dtype=torch.bfloat16)
    check(same_bits(a, b), "edge_forward: two calls on the card differ")
    check(launches == tr.cfg.model.num_layers,
          f"edge_forward launched gather_pool {launches} times, expected one a conv")
    f32 = pinsage.edge_forward(tr.params, x, src, dst, w, dtype=torch.float32)
    ref = pinsage.edge_forward(to_device(tr.params, "cpu"), x.cpu(), src.cpu(), dst.cpu(),
                               w.cpu(), dtype=torch.float32)
    err = float((f32.cpu() - ref).abs().max())
    check(err <= 1e-4, f"edge_forward: card vs CPU {err}")
    h = torch.randn((n, tr.cfg.model.hidden_dim), generator=gen, device=dev).bfloat16()
    es = pool.edge_slices(src, dst, w, n)
    got = pool.slice_sum(h, es)
    plain = pool.slice_sum_plain(h, src, dst, w, n)
    sum_err = float((got - plain).abs().max() / plain.abs().max())
    check(sum_err <= 1e-5, f"edge message sum vs index_add_: {sum_err} relative")
    return {"nodes": n, "edges": int(src.shape[0]), "slices": int(es.nbrs.shape[0]),
            "launches": launches, "bitwise_repeat": True, "f32_vs_cpu_max_abs_err": err,
            "message_sum_rel_err_vs_index_add": sum_err,
            "message_sum": timed(lambda: pool.slice_sum(h, es), iters=20, kernels=2),
            "message_sum_kernel": cuda_ms(lambda: pool.gather_pool(h, es.nbrs, es.weights, n)),
            "index_add": cuda_ms(lambda: pool.slice_sum_plain(h, src, dst, w, n), iters=20),
            "edge_forward_bf16_ms": cuda_ms(lambda: pinsage.edge_forward(
                tr.params, x, src, dst, w, dtype=torch.bfloat16), iters=5)}


def aggregators_phase(dev) -> dict:
    """Each aggregator kind (and importance with batch norm) on the serve
    phase's 4k corpus at full width, f32: one step on the card against the
    same step on the CPU (``agg_step_vs_cpu``), and the card's step time;
    then ``edge_forward_check``."""
    from movie_recommendation_engine_tpu_torch import default_config
    from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
    from movie_recommendation_engine_tpu_torch.graph import dataset
    from movie_recommendation_engine_tpu_torch.train.trainer import Trainer

    base = default_config().override({"data.source": "synthetic",
                                      "train.compute_dtype": "float32"})
    data = dataset.load(base)
    quiet = MetricsLogger(stream=io.StringIO())
    out = {}
    gpu = None
    for name, over in AGG_KINDS:
        cfg = base.override({"model.aggregator_type": name, **over})
        gpu = Trainer(cfg, data, quiet, device=dev)
        cpu = Trainer(cfg, data, quiet, device="cpu")
        gpu.refresh_neighborhoods()
        cpu.x_table = gpu.x_table.cpu()
        cpu.set_neighborhood_tables([(nb.cpu(), w.cpu()) for nb, w in gpu.nbr_tables])
        pairs = gpu._epoch_pairs(np.random.default_rng(0))
        q = torch.as_tensor(pairs[0, :, 0], dtype=torch.int32, device=dev)
        p = torch.as_tensor(pairs[0, :, 1], dtype=torch.int32, device=dev)
        vs_cpu = agg_step_vs_cpu(gpu, cpu, q, p)

        def step_ms():
            torch.cuda.synchronize()
            t = time.perf_counter()
            gpu.train_steps(q[None], p[None], gpu.plateau.lr, 1.0, 1)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3
        walls = [step_ms() for _ in range(6)]
        prof = device_profile(lambda: gpu.train_steps(q[None], p[None], gpu.plateau.lr, 1.0, 1),
                              calls=3)
        out[name] = {"rung": rung_of(gpu.pool_mats), "vs_cpu": vs_cpu,
                     "step_wall_ms_median": statistics.median(walls[1:]),
                     "device_ms": prof["device_ms"], "kernels_per_step": prof["kernels_per_call"],
                     "top": prof["top"]}
        del cpu
    edge = edge_forward_check(dev, gpu)
    emit("aggregators", corpus={"num_movies": data.num_movies}, compute_dtype="float32",
         tolerance={"loss_rel": 1e-4, "grad_rel_norm": 1e-3, "param_abs": "2 lr"},
         kinds=out, edge_forward=edge)
    return {"gather_pool": {"launches_edge_forward": edge["launches"],
                            "ms_edge_message_sum": edge["message_sum_kernel"]["ms"],
                            "library_ms_edge_message_sum": edge["index_add"]["ms"]}}


# ---------------------------------------------------------------------------
# 14. the tools: tune, demo, train --profile, reference .pt checkpoints
# ---------------------------------------------------------------------------

def tools_phase(dev, d: str) -> None:
    """On the card, at ``small_test_config`` widths with the gather rung
    and ``gather_impl=pallas``: ``tune`` on a 2 x 1 grid (1 epoch each; the
    CSV and ``best_tuned_model`` exist), ``demo`` on piped commands, ``train
    --profile`` (the trace names the gather-pool kernel), and a reference
    ``.pt`` written here from an engine's params, which loads and embeds as
    those params do."""
    import contextlib

    from movie_recommendation_engine_tpu_torch import api, small_test_config
    from movie_recommendation_engine_tpu_torch.cli.main import main as cli
    from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
    from movie_recommendation_engine_tpu_torch.train.tune import hyperparameter_tuning

    os.makedirs(d, exist_ok=True)
    cfg = small_test_config().override({
        "model.pool_impl": "gather", "model.gather_impl": "pallas", "train.epochs": 1,
        "paths.checkpoint_dir": os.path.join(d, "ck"), "paths.output_dir": os.path.join(d, "out")})
    cfg_path = os.path.join(d, "config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    out = {}
    log = MetricsLogger(stream=io.StringIO())
    res = hyperparameter_tuning(cfg, log, learning_rates=(1e-3, 5e-4), hidden_dims=(64,),
                                device=dev)
    errors = [e for e in log.history if e["event"] == "tune_error"]
    check(not errors and len(res["results"]) == 2, f"tune: {errors}")
    check(os.path.exists(res["csv"]) and os.path.exists(
        os.path.join(cfg.paths.checkpoint_dir, "best_tuned_model.npz")), "tune outputs")
    out["tune"] = {"results": res["results"], "best": res["best"]}

    eng = api.Engine(cfg, logger=log, device=dev)
    mid = int(eng.data.movie_ids[4])
    buf = io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO(f"search Midnight\nrecommend {mid}\npopular\nquit\n")
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli(["demo", "--device", dev.type, "--config", cfg_path])
    finally:
        sys.stdin = stdin
    text = buf.getvalue()
    recs = text.split("recommendations:")[1].split(">")[0].strip().splitlines()
    check(rc == 0 and len(recs) == 10, f"demo: {text[-500:]}")
    out["demo"] = {"rc": rc, "recommendations": len(recs), "output_lines": text.count("\n")}

    trace_dir = os.path.join(d, "trace")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli(["train", "--device", dev.type, "--profile", trace_dir, "--config", cfg_path])
    with open(os.path.join(trace_dir, "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kern = sorted(n for n in names if "gather_pool" in n and "kernel" in n)
    check(rc == 0 and kern, "train --profile: no gather-pool kernel in the trace")
    out["profile"] = {"rc": rc, "kernels": kern, "events": len(names),
                      "bytes": os.path.getsize(os.path.join(trace_dir, "trace.json"))}

    params = eng.trainer.params
    sd = {}
    for name in ("input_proj", "output_proj"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = params[name]["w"].t().cpu(), params[name]["b"].cpu()
    for i, conv in enumerate(params["convs"]):
        for ours, theirs in (("self", "lin_self"), ("neigh", "lin_neigh"), ("update", "lin_update")):
            sd[f"convs.{i}.{theirs}.weight"] = conv[ours]["w"].t().cpu()
            sd[f"convs.{i}.{theirs}.bias"] = conv[ours]["b"].cpu()
    pt = os.path.join(d, "reference.pt")
    torch.save({"epoch": 1, "model_state_dict": sd}, pt)
    emb = eng.embeddings(refresh=True)
    eng.trainer.params = None
    eng.load_checkpoint(pt)
    again = eng.embeddings()
    err = float(np.abs(again - emb).max())
    check(err <= 1e-6, f".pt checkpoint embeds {err} away from its params")
    out["torch_checkpoint"] = {"max_abs_err": err, "rows": int(emb.shape[0])}
    emit("tools", **out)


# ---------------------------------------------------------------------------
# 15. mesh: multi-device execution. One card, so NCCL gets a world of one;
# the sharded semantics run on two gloo ranks that share cuda:0 (spawned
# here), their collectives staged through the host.
# ---------------------------------------------------------------------------

MESH_GATHER = {"data.source": "synthetic", "model.pool_impl": "gather",
               "model.gather_impl": "pallas", "train.compute_dtype": "float32",
               "train.epochs": 2}
MESH_HARD = 6


def mesh_cfg(overrides: dict, shape=None):
    from movie_recommendation_engine_tpu_torch import default_config

    cfg = default_config().override({"mesh.shard_tables": True, **overrides})
    cfg.mesh.mesh_shape = shape
    return cfg


def flat_numpy(tree_) -> dict:
    from movie_recommendation_engine_tpu_torch.core import tree

    return {k: v.detach().cpu().numpy() for k, v in tree.flatten(tree_).items()}


def mesh_steps(tr, q, p, steps: int) -> dict:
    """The protocol both the single-device trainer and every rank run, from
    the same seed: refresh the tables (unless given), then the first step's
    draws (``MESH_HARD`` hard negatives), loss and gradients; the generator
    put back, then ``steps`` Adam steps (counts, collectives and times
    taken around them)."""
    from movie_recommendation_engine_tpu_torch.parallel import collectives as coll

    if tr.nbr_tables is None:
        tr.refresh_neighborhoods()
    state = tr.generator.get_state()
    d0 = tr.draw_step(q[0], MESH_HARD)
    loss0, grads = tr.loss_and_grads(q[0], p[0], d0, 1.0)
    tr.generator.set_state(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    coll.reset_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = tr.train_steps(q[:steps], p[:steps], 1e-3, 1.0, MESH_HARD)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"loss0": float(loss0), "grads": flat_numpy(grads),
            "losses": losses.cpu().numpy(), "params": flat_numpy(tr.params),
            "launches": read_launches(),
            "step_wall_ms": wall * 1e3 / steps,
            "step_cuda_event_ms": start.elapsed_time(end) / steps,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "collectives_a_step": {op: {"calls": s[0] / steps, "bytes": s[1] / steps,
                                        "host_ms": s[2] * 1e3 / steps}
                                   for op, s in coll.STATS.items()},
            "rung": rung_of(tr.pool_mats)}


def held_to(got: dict, ref: dict, tol: float, what: str) -> dict:
    """Losses within ``tol`` relative and the first step's gradients within
    ``tol`` of the largest; returns the largest differences, the params'
    too. The params are reported, not gated: Adam divides each gradient
    element by its own size, so an element within rounding of zero, summed
    across ranks in another order, steps by up to lr either way."""
    loss_err = abs(got["loss0"] - ref["loss0"]) / abs(ref["loss0"])
    check(loss_err <= tol, f"{what}: first loss {got['loss0']} vs {ref['loss0']}")
    out = {"loss_rel_err": loss_err}
    if "losses" in ref and "losses" in got:
        err = float(np.max(np.abs(got["losses"] - ref["losses"]) / np.abs(ref["losses"])))
        check(err <= tol, f"{what}: losses {got['losses']} vs {ref['losses']}")
        out["losses_rel_err"] = err
    for part in ("grads", "params"):
        if part not in ref or part not in got:
            continue
        scale = max(float(np.abs(v).max()) for v in ref[part].values())
        err = max(float(np.abs(got[part][k] - v).max()) for k, v in ref[part].items())
        check(part == "params" or err <= tol * scale,
              f"{what}: {part} differ by {err} (largest {scale})")
        out[f"{part}_max_abs_err"], out[f"{part}_largest"] = err, scale
    return out


def mesh_kernel_checks(tr, rank: int) -> dict:
    """Both gather-pool kernels on the rank's own inputs: its rows of the
    layer-0 walk table (global ids) against a random table of every row,
    held to their plain versions (``check_pool_routes``, ``check_segment``,
    ``check_bwd``)."""
    from movie_recommendation_engine_tpu_torch.ops import pool

    gen = torch.Generator(device=tr.device).manual_seed(100 + rank)
    limit = min(tr.valid_limit, tr.table_rows)
    table, nbrs, w, g = bwd_inputs(gen, tr, slice(None), limit, torch.float32)
    return {"rows": list(nbrs.shape), "table_rows": table.shape[0],
            "gather_pool_max_abs_err": check_pool_routes(pool, table, nbrs, w, limit,
                                                         f"rank {rank}"),
            "segment_max_abs_err": check_segment(pool, table, nbrs, w, limit, g,
                                                 f"rank {rank}"),
            "bwd_vs_plain": check_bwd(pool, table, nbrs, w, limit, g, f"rank {rank}",
                                      "segment")}


def mesh_rank(rank: int, world: int, d: str) -> None:
    """One of the two gloo ranks on cuda:0: the 4k gather config at (1, 2)
    (tables and CSR row-sharded) and (2, 1), then the 59k hub step at
    (1, 2) and sharded retrieval over its embeddings. Every result is held
    to the single-device one here; the rank writes what it read."""
    import pickle

    from movie_recommendation_engine_tpu_torch.ops.hub_pool import HubPool
    from movie_recommendation_engine_tpu_torch.parallel import collectives as coll
    from movie_recommendation_engine_tpu_torch.parallel import mesh as mesh_mod
    from movie_recommendation_engine_tpu_torch.parallel.sharding import sharded_embed_fn
    from movie_recommendation_engine_tpu_torch.retrieval.exact import ExactIndex
    from movie_recommendation_engine_tpu_torch.retrieval.sharded import (ShardedExactIndex,
                                                                         ShardedIVFIndex)
    from movie_recommendation_engine_tpu_torch.sampling.sharded_walk import ShardedDeviceGraph
    from movie_recommendation_engine_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_mod.distributed_init(backend="gloo", init_method=f"file://{d}/pg", world_size=world,
                              rank=rank, init_timeout_s=300)
    dev = mesh_mod.rank_device(torch.device("cuda"))
    with open(f"{d}/ref.pkl", "rb") as f:
        ref = pickle.load(f)
    out = {"device": str(dev)}
    q = torch.as_tensor(ref["q"], device=dev)
    p = torch.as_tensor(ref["p"], device=dev)
    for shape in ((1, 2), (2, 1)):
        name = f"{shape[0]}x{shape[1]}"
        tr = Trainer(mesh_cfg(MESH_GATHER, shape), ref["data"], device=dev)
        check(isinstance(tr.graph, ShardedDeviceGraph) == (shape[1] > 1),
              f"rank {rank} {name}: the CSR is not row-sharded")
        tr.refresh_neighborhoods()
        rows = slice(None) if tr.shard is None else slice(tr.shard.start, tr.shard.stop)
        same = all(np.array_equal(nb.cpu().numpy(), r_nb[rows])
                   and np.array_equal(w.cpu().numpy(), r_w[rows])
                   for (nb, w), (r_nb, r_w) in zip(tr.nbr_tables, ref["tables"]))
        check(same, f"rank {rank} {name}: walk tables differ from the single-device trainer's")
        got = mesh_steps(tr, q, p, 2)
        launches = got["launches"]
        check(launches["gather_pool"] > 0 and launches["gather_pool_bwd_segment"] > 0,
              f"rank {rank} {name}: the path did not launch both gather-pool kernels: "
              f"{launches}")
        out[name] = {"held_to_single_device": held_to(got, ref["steps"], 1e-5,
                                                      f"rank {rank} {name}"),
                     "walk_tables_bitwise_equal": same,
                     "rows_held": tr.x_table.shape[0], "table_rows": tr.table_rows,
                     "kernels": mesh_kernel_checks(tr, rank),
                     **{k: got[k] for k in ("launches", "step_wall_ms", "step_cuda_event_ms",
                                            "collectives_a_step", "rung", "peak_mib")}}
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    # The at-scale rung: 59k popularity tables, pool_impl=auto, (1, 2).
    with open(f"{d}/hub_data.pkl", "rb") as f:
        hub_data = pickle.load(f)
    cfg = mesh_cfg({"data.source": "synthetic", "model.gather_impl": "pallas",
                    "train.compute_dtype": "float32", **HUB_CORPUS}, (1, 2))
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, hub_data, device=dev)
    n = hub_data.num_movies
    pad = tr.table_rows - n
    tables = [(np.concatenate([nb, np.full((pad, nb.shape[1]), n, np.int32)]),
               np.concatenate([w, np.zeros((pad, w.shape[1]), np.float32)]))
              for nb, w in popularity_tables(2, n)]
    tr.set_neighborhood_tables(tables)
    check(len(tr.pool_mats) == 2 and all(isinstance(pm, HubPool) for pm in tr.pool_mats),
          f"rank {rank} 59k: pool_impl=auto built {rung_of(tr.pool_mats)}, expected hubf")
    half = [pm.a_head.shape[0] for pm in tr.pool_mats]
    check(all(h * 2 == tr.table_rows for h in half),
          f"rank {rank} 59k: a_head rows {half} are not half of {tr.table_rows}")
    hq = torch.as_tensor(ref["hub_q"], device=dev)
    hp = torch.as_tensor(ref["hub_p"], device=dev)
    got = mesh_steps(tr, hq, hp, 1)
    out["hub_1x2"] = {"held_to_single_device": held_to(got, ref["hub"], 1e-5,
                                                       f"rank {rank} 59k"),
                      "a_head_rows": half, "table_rows": tr.table_rows,
                      "a_head_bytes": sum(pm.a_head.numel() * pm.a_head.element_size()
                                          for pm in tr.pool_mats),
                      "peak_mib_build_and_step": torch.cuda.max_memory_allocated() / 2**20,
                      **{k: got[k] for k in ("launches", "step_wall_ms", "step_cuda_event_ms",
                                             "collectives_a_step", "rung", "peak_mib")}}

    # Sharded retrieval over the step's embeddings: the rank's rows of the
    # embedding pass go to the sharded exact index without a gather.
    rows = sharded_embed_fn(tr.mesh, tr.step_config(0.0), tr.shard)(
        tr.params, tr.x_table, [t[0] for t in tr.nbr_tables], [t[1] for t in tr.nbr_tables],
        tr.pool_mats)
    full = coll.all_gather_rows(rows, tr.shard.group)[:n].contiguous()
    queries = full[torch.as_tensor(np.random.default_rng(0).choice(n, 256, replace=False),
                                   device=dev)]
    exact = ExactIndex(full.shape[1], device=dev)
    exact.build(full)
    e_d, e_i = exact.search(queries, 10)
    sx = ShardedExactIndex(full.shape[1], mesh=tr.mesh, device=dev)
    sx.build_shard(rows, n)
    s_d, s_i = sx.search(queries, 10)
    iv = ShardedIVFIndex(full.shape[1], mesh=tr.mesh, num_partitions=100, nprobe=100,
                         device=dev)
    iv.build(full)
    i_d, i_i = iv.search(queries, 10)
    def wall_ms(index) -> float:
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index.search(queries, 10)[1].cpu()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)
    out["retrieval"] = {"queries": 256, "k": 10, "rows_held": rows.shape[0],
                        "sharded_exact_near_ties": same_ids(s_d, s_i, e_d, e_i, tol=1e-6),
                        "sharded_ivf_full_probe_near_ties": same_ids(i_d, i_i, e_d, e_i,
                                                                     tol=1e-6),
                        "ivf_rows_held": iv._emb.shape[0],
                        "search_wall_ms_median": {"sharded_exact": wall_ms(sx),
                                                  "sharded_ivf": wall_ms(iv),
                                                  "exact_one_rank": wall_ms(exact)}}
    with open(f"{d}/rank{rank}.json", "w") as f:
        json.dump(out, f, default=float)
    torch.distributed.destroy_process_group()


def mesh_nccl_world_of_one(dev, d: str) -> dict:
    """``Engine.fit`` (2 epochs, f32) on the gather config twice from the
    same seed: in an NCCL group of one rank at ``mesh_shape=(1, 1)`` with
    ``shard_tables``, and without a mesh. Losses and params within 1e-6."""
    from movie_recommendation_engine_tpu_torch import api
    from movie_recommendation_engine_tpu_torch.parallel import mesh as mesh_mod

    check(mesh_mod.distributed_init(backend="nccl", init_method=f"file://{d}/pg_nccl",
                                    world_size=1, rank=0, init_timeout_s=120),
          "NCCL world of one did not initialize")
    fits = {}
    for name, shape in (("mesh_1x1", (1, 1)), ("single", None)):
        eng = api.Engine(mesh_cfg({**MESH_GATHER, "paths.checkpoint_dir": f"{d}/{name}"},
                                  shape), device=dev)
        zero_launches()
        t0 = time.perf_counter()
        out = eng.fit()
        torch.cuda.synchronize()
        fits[name] = {"fit_s": time.perf_counter() - t0, "launches": read_launches(),
                      "losses": [h["loss"] for h in out["history"]],
                      "params": flat_numpy(eng.trainer.params),
                      "mesh": eng.trainer.mesh is not None,
                      "backend": torch.distributed.get_backend()}
        del eng
    torch.distributed.destroy_process_group()
    a, b = fits["mesh_1x1"], fits["single"]
    check(a["mesh"] and not b["mesh"], "the NCCL fit did not run on a mesh")
    loss_err = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    param_err = max(float(np.abs(a["params"][k] - v).max()) for k, v in b["params"].items())
    check(loss_err <= 1e-6 and param_err <= 1e-6,
          f"NCCL (1, 1) fit: losses {a['losses']} vs {b['losses']}, params differ by {param_err}")
    check(a["launches"]["gather_pool"] > 0 and a["launches"]["gather_pool_bwd_segment"] > 0,
          f"NCCL (1, 1) fit launched {a['launches']}")
    return {"backend": a["backend"], "losses": a["losses"], "single_losses": b["losses"],
            "loss_max_abs_err": loss_err, "param_max_abs_err": param_err,
            "bitwise_equal": loss_err == 0.0 and param_err == 0.0,
            "fit_s": {k: v["fit_s"] for k, v in fits.items()},
            "launches": a["launches"]}


def mesh_phase(dev, hub_data) -> dict:
    """Multi-device execution on one card:

    1. NCCL in a world of one (``mesh_nccl_world_of_one``);
    2. two gloo ranks sharing cuda:0, spawned here (``mesh_rank``): the 4k
       gather config at (1, 2) with ``shard_tables`` and ``shard_graph`` and
       at (2, 1), two steps with 6 hard negatives each, walk tables bitwise
       equal to the single-device trainer's, the first step's loss and
       gradients and both steps' losses within 1e-5 of it (f32; the params
       reported),
       both gather-pool kernels launched on each rank and held to their
       plain versions on the rank's inputs;
    3. the same two ranks at (1, 2) on ``train_hub``'s 59,393-row corpus and
       popularity tables with ``pool_impl=auto``: ``hubf`` with each rank
       holding half of every ``a_head``, one step within 1e-5 of the
       single-device hub step, peak device memory per rank beside it;
    4. sharded retrieval over that step's embeddings (Q = 256, k = 10):
       ``sharded_exact`` built from each rank's rows of the embedding pass
       and ``sharded_ivf`` with every list probed, both equal to exact
       search except where two distances lie within 1e-6.

    Gloo numbers are two ranks on one card, their collectives staged
    through the host: no multi-GPU rate is read from them."""
    import pickle

    from movie_recommendation_engine_tpu_torch.graph import dataset
    from movie_recommendation_engine_tpu_torch.parallel import mesh as mesh_mod
    from movie_recommendation_engine_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        nccl = mesh_nccl_world_of_one(dev, d)
        gc.collect()
        torch.cuda.empty_cache()

        cfg = mesh_cfg(MESH_GATHER)
        data = dataset.load(cfg)
        tr = Trainer(cfg, data, device=dev)
        pairs = tr._epoch_pairs(np.random.default_rng(0))[:2]
        q = torch.as_tensor(pairs[:, :, 0], dtype=torch.int32, device=dev)
        p = torch.as_tensor(pairs[:, :, 1], dtype=torch.int32, device=dev)
        steps = mesh_steps(tr, q, p, 2)
        ref = {"data": data, "q": q.cpu().numpy(), "p": p.cpu().numpy(), "steps": steps,
               "tables": [(nb.cpu().numpy(), w.cpu().numpy()) for nb, w in tr.nbr_tables]}
        del tr
        hcfg = mesh_cfg({"data.source": "synthetic", "model.gather_impl": "pallas",
                         "train.compute_dtype": "float32", **HUB_CORPUS})
        htr = Trainer(hcfg, hub_data, device=dev)
        htr.set_neighborhood_tables(popularity_tables(2, htr.table_rows))
        hpairs = htr._epoch_pairs(np.random.default_rng(0))[:1]
        hq = torch.as_tensor(hpairs[:, :, 0], dtype=torch.int32, device=dev)
        hp = torch.as_tensor(hpairs[:, :, 1], dtype=torch.int32, device=dev)
        hub = mesh_steps(htr, hq, hp, 1)
        check(hub["rung"] == "hubf", f"single-device 59k step took {hub['rung']}")
        ref.update(hub=hub, hub_q=hq.cpu().numpy(), hub_p=hp.cpu().numpy())
        del htr
        gc.collect()
        torch.cuda.empty_cache()
        with open(f"{d}/ref.pkl", "wb") as f:
            pickle.dump(ref, f)
        with open(f"{d}/hub_data.pkl", "wb") as f:
            pickle.dump(hub_data, f)
        t0 = time.perf_counter()
        mesh_mod.run_local(mesh_rank, 2, d, timeout=600)
        ranks_s = time.perf_counter() - t0
        ranks = [json.load(open(f"{d}/rank{r}.json")) for r in range(2)]

    def single(s):
        return {k: s[k] for k in ("step_wall_ms", "step_cuda_event_ms", "peak_mib", "rung",
                                  "launches")}
    emit("mesh", label="gloo: two ranks on one card, collectives staged through the host",
         nccl_world_of_one=nccl, single_device={"gather_4k": single(steps),
                                                "hub_59k": single(hub)},
         ranks=ranks, ranks_s=ranks_s, phase_s=time.perf_counter() - t_phase)
    per_rank = {"launches_mesh_nccl": nccl["launches"]["gather_pool"]}
    bwd = {"launches_mesh_nccl": nccl["launches"]["gather_pool_bwd_segment"]}
    for r, out in enumerate(ranks):
        for name in ("1x2", "2x1", "hub_1x2"):
            per_rank[f"launches_mesh_{name}_rank{r}"] = out[name]["launches"]["gather_pool"]
            bwd[f"launches_mesh_{name}_rank{r}"] = out[name]["launches"]["gather_pool_bwd"]
        per_rank[f"max_abs_err_mesh_rank{r}"] = out["1x2"]["kernels"]["gather_pool_max_abs_err"]
        bwd[f"max_abs_err_mesh_rank{r}"] = out["1x2"]["kernels"]["bwd_vs_plain"][
            "d_table_max_abs_err"]
    return {"gather_pool": per_rank, "gather_pool_bwd": bwd}


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
    launches, serving, serve_corpus = serve_phase(dev)
    pool_entry = gather_pool_phase(dev, *serving, gather_err)
    serve_default_phase(dev)
    bwd, train_launches, walk_fit = train_phase(dev)
    pool_entry.update(launches=launches["gather_pool"],
                      launches_train=train_launches["gather_pool"])
    fwd_hub, bwd_hub, hub_eng, hub_emb = train_hub_phase(dev)
    pool_entry.update(fwd_hub)
    bwd.update(bwd_hub)
    graphed = train_graph_phase(dev, hub_eng.trainer)
    pool_entry["launches_train_graph"] = graphed["gather_pool"]
    bwd.update(launches_train_graph=graphed["gather_pool_bwd"],
               launches_train_graph_segment=graphed["gather_pool_bwd_segment"])
    ppr_launches = ppr_phase(dev, walk_fit)
    pool_entry["launches_ppr"] = ppr_launches["gather_pool"]   # the build's pushes too
    bwd.update(launches_ppr=ppr_launches["gather_pool_bwd"],
               launches_ppr_segment=ppr_launches["gather_pool_bwd_segment"])
    at_scale = ppr_at_scale_phase(hub_eng)
    from movie_recommendation_engine_tpu_torch.sampling.ppr import SLICE
    push = at_scale["push"][f"slice{SLICE}"]
    pool_entry.update(launches_ppr_59k_build=at_scale["build_launches"],
                      ms_ppr_push_59k=push["gather_pool"]["ms"],
                      bound_ms_ppr_push_59k=push["bound_ms"],
                      library_ms_ppr_push_59k=at_scale["push"]["library_cusparse"]["ms"])
    ham["launches"] = launches["hamming_distance"]
    ham.update(retrieval_phase(dev, hub_emb, hub_eng.data))
    from movie_recommendation_engine_tpu_torch import default_config
    from movie_recommendation_engine_tpu_torch.core import roofline
    search = default_config().search
    q256 = roofline.hamming_bound(256, hub_emb.shape[0], search.lsh_tables,
                                  search.lsh_bits // 32, float(clock))
    ham.update(bound_ms_59k_q256=q256["ms"], bound_by_59k_q256=q256["by"])
    ham.update(serve_graph_phase(dev, hub_emb, hub_eng.data, serve_corpus, float(clock)))
    epoch_launches = epoch_graph_phase(dev, serve_corpus[1], hub_eng.trainer, hub_emb)
    pool_entry["launches_epoch_graph"] = epoch_launches["gather_pool"]
    bwd.update(launches_epoch_graph=epoch_launches["gather_pool_bwd"],
               launches_epoch_graph_segment=epoch_launches["gather_pool_bwd_segment"])
    hub_data = hub_eng.data
    del hub_eng
    gc.collect()
    torch.cuda.empty_cache()
    check_phase(dev)
    hstu_lookup = hstu_lookup_phase(dev)
    bwd["hstu_lookup"] = {k: hstu_lookup[k] for k in ("history", "loss", "launches")}
    bwd["dlrm"] = {k: v for k, v in dlrm_phase(dev).items()
                   if k in ("shape", "unique_rows", "launches", "compact_grad", "plan_compact")}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        extras = [movielens_phase(dev, d)]
        gc.collect()
        torch.cuda.empty_cache()
        extras.append(cooc_phase(dev, d))
        gc.collect()
        torch.cuda.empty_cache()
        extras.append(aggregators_phase(dev))
        extras.append(tools_phase(dev, os.path.join(d, "tools")) or {})
        gc.collect()
        torch.cuda.empty_cache()
        extras.append(mesh_phase(dev, hub_data))
    for extra in extras:
        pool_entry.update(extra.get("gather_pool", {}))
        bwd.update(extra.get("gather_pool_bwd", {}))
        ham.update(extra.get("hamming_distance", {}))
    kernels = [pool_entry, bwd, ham]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
