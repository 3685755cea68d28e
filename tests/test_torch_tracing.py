"""The port's program spans (``core/logging.SpanRecorder``) on the CPU.

- Off (the default, and no profiler running), a tiny ``fit`` and a tiny
  ``BatchingRecommender`` under load record nothing, and an untimed span is
  the shared ``_OFF``: no record, no clock, no device sync.
- On, spans nest by thread; the trainer's ``trainer.refresh.walks`` and
  ``trainer.refresh.pool_build`` lie inside ``trainer.refresh``, whose
  duration is the ``neighborhoods`` event's ``seconds`` (and ``fit``'s
  ``epoch_seconds`` and ``val_seconds`` are their spans'); every answered
  request id is in exactly one ``server.batch``, and its queue wait ends at
  that batch's start, as ``ServerStats`` counts it.
- The clock is ``time.time_ns()``, the harness's and the profiler's: a span
  opened inside a ``time.time_ns()`` interval lies within it. A running
  ``torch.profiler`` turns recording on; ``trace()`` adds
  ``record_function`` ranges by span name.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
from concurrent.futures import wait

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch import api, small_test_config
from movie_recommendation_engine_tpu_torch.core import logging as plog
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger, span
from movie_recommendation_engine_tpu_torch.retrieval.server import BatchingRecommender

# The smallest corpus here with validation pairs (6), so that ``fit``
# validates through the ranks.
TINY = {"data.synthetic_num_movies": 200, "data.synthetic_num_users": 400,
        "data.synthetic_num_ratings": 20000, "features.feature_dim": 16,
        "model.hidden_dim": 32, "model.embed_dim": 16, "walk.num_walks": 10,
        "train.epochs": 2, "train.batch_size": 32, "train.max_pairs_per_epoch": 64,
        "eval.eval_every": 1}


@pytest.fixture
def recorder():
    """The process's recorder, on for the test and drained on both sides."""
    plog.drain()
    plog.RECORDER.dropped = 0
    plog.enable()
    try:
        yield plog.RECORDER
    finally:
        plog.disable()
        plog.drain()


@pytest.fixture
def off():
    """The recorder off, with nothing left in it."""
    plog.disable()
    plog.drain()
    plog.RECORDER.dropped = 0
    yield plog.RECORDER
    plog.drain()


def _engine(tmp_path):
    cfg = small_test_config().override({**TINY, "paths.output_dir": str(tmp_path),
                                        "paths.checkpoint_dir": str(tmp_path)})
    return api.Engine(cfg, logger=MetricsLogger(stream=io.StringIO()), device="cpu")


def _load(rec: BatchingRecommender, emb: np.ndarray, n: int, threads: int = 4) -> list:
    """``n`` requests by item from ``threads`` threads; their futures."""
    futs, lock = [], threading.Lock()

    def send(rows):
        for r in rows:
            f = rec.submit(emb[r], 5, exclude=np.asarray([r]))
            with lock:
                futs.append(f)

    ts = [threading.Thread(target=send, args=(range(t, n, threads),)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    done, _ = wait(futs, timeout=30)
    assert len(done) == n
    return futs


def _server(emb: np.ndarray) -> BatchingRecommender:
    return BatchingRecommender(emb, method="exact", max_batch=8, max_wait_ms=2.0, max_k=20,
                               device="cpu")


def _emb(n=200, d=16, seed=0) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _by_name(records) -> dict[str, list]:
    out: dict[str, list] = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


# ---- off ---------------------------------------------------------------------

def test_off_a_fit_and_a_loaded_server_record_nothing(off, tmp_path):
    eng = _engine(tmp_path)
    out = eng.trainer.fit()
    assert len(out["history"]) == 2
    emb = _emb()
    rec = _server(emb)
    try:
        _load(rec, emb, 120)
    finally:
        rec.close()
    assert not off.on()
    assert off.drain() == [] and off.dropped == 0


def test_off_an_untimed_span_is_shared_and_syncs_nothing(off, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    s = span("test.off", sync=torch.device("cuda"))
    assert s is plog._OFF and not s.recorded
    with s:
        pass
    timed = span("test.timed", timed=True, sync=torch.device("cuda"))
    with timed:
        pass
    assert timed.seconds >= 0 and not timed.recorded
    assert calls == [] and off.drain() == []


def test_on_a_sync_span_synchronizes_its_device(recorder, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    with span("test.cuda", sync=torch.device("cuda")):
        pass
    with span("test.cpu", sync=torch.device("cpu")):
        pass
    assert calls == [(torch.device("cuda"),)]
    assert [r.name for r in recorder.drain()] == ["test.cuda", "test.cpu"]


# ---- nesting and the clock ---------------------------------------------------------

def test_spans_nest_by_thread(recorder):
    ready, go = threading.Barrier(2), threading.Event()

    def other():
        with span("b.outer"):
            ready.wait(timeout=10)
            with span("b.inner"):
                go.wait(timeout=10)

    t = threading.Thread(target=other, name="other")
    with span("a.outer"):
        t.start()
        ready.wait(timeout=10)
        with span("a.inner"):
            go.set()
        t.join(timeout=10)
    assert not t.is_alive()
    got = {r.name: r for r in recorder.drain()}
    assert got["a.inner"].parent == got["a.outer"].id and got["a.outer"].parent is None
    assert got["b.inner"].parent == got["b.outer"].id and got["b.outer"].parent is None
    assert got["b.outer"].thread == "other" != got["a.outer"].thread
    assert len({r.id for r in got.values()}) == 4


def test_a_span_lies_within_a_time_ns_interval_around_it(recorder):
    t0 = time.time_ns()
    with span("test.clock"):
        time.sleep(0.001)
    t1 = time.time_ns()
    (r,) = recorder.drain()
    assert t0 <= r.start_ns < r.end_ns <= t1
    assert r.end_ns - r.start_ns >= 1_000_000


def test_a_running_profiler_turns_recording_on(off):
    from torch.profiler import ProfilerActivity, profile

    with span("test.before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert off.on()
        with span("test.profiled"):
            pass
    with span("test.after"):
        pass
    assert [r.name for r in off.drain()] == ["test.profiled"]


def test_trace_adds_record_function_ranges_by_span_name(off, tmp_path):
    with plog.trace(str(tmp_path)):
        with span("test.outer"):
            with span("test.inner"):
                torch.ones(8).add_(1)
    assert off.annotate == 0
    with open(os.path.join(tmp_path, plog.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"test.outer", "test.inner"} <= names
    assert {r.name for r in off.drain()} == {"test.outer", "test.inner"}


def test_drain_empties_and_the_limit_counts_what_it_drops(recorder, monkeypatch):
    monkeypatch.setattr(recorder, "LIMIT", 3)
    for _ in range(5):
        with span("test.many"):
            pass
    assert len(recorder.drain()) == 3 and recorder.dropped == 2
    assert recorder.drain() == []


# ---- the trainer ------------------------------------------------------------------

def _inside(child, parent) -> bool:
    return (child.parent == parent.id and parent.start_ns <= child.start_ns
            and child.end_ns <= parent.end_ns)


def test_trainer_spans_nest_and_feed_its_logged_seconds(recorder, tmp_path):
    eng = _engine(tmp_path)
    recorder.drain()          # the engine's first refresh, outside an epoch
    out = eng.trainer.fit()
    spans = _by_name(recorder.drain())
    refreshes = spans["trainer.refresh"]
    assert len(refreshes) == 2
    by_id = {r.id: r for rs in spans.values() for r in rs}
    for part in ("trainer.refresh.walks", "trainer.refresh.pool_build"):
        assert len(spans[part]) == 2
        assert all(_inside(r, by_id[r.parent]) and by_id[r.parent].name == "trainer.refresh"
                   for r in spans[part])
    events = [e for e in eng.log.history if e["event"] == "neighborhoods"]
    assert [e["seconds"] for e in events] == [(r.end_ns - r.start_ns) / 1e9 for r in refreshes]
    epochs = spans["trainer.epoch"]
    assert [h["epoch_seconds"] for h in out["history"]] == [
        (r.end_ns - r.start_ns) / 1e9 for r in epochs]
    for name in ("trainer.refresh", "trainer.epoch_batches", "trainer.steps"):
        assert all(by_id[r.parent].name == "trainer.epoch" for r in spans[name])
    evals = spans["trainer.evaluate"]
    assert [h["val_seconds"] for h in out["history"]] == [
        (r.end_ns - r.start_ns) / 1e9 for r in evals]
    for part in ("trainer.evaluate.embed", "trainer.evaluate.ranks"):
        assert len(spans[part]) == 2
        assert all(_inside(r, by_id[r.parent]) and by_id[r.parent].name == "trainer.evaluate"
                   for r in spans[part])
    for h, r in zip(out["history"], spans["trainer.steps"]):
        assert h["step_wall_seconds"] == round((r.end_ns - r.start_ns) / 1e9, 2)


def test_evaluate_alone_has_its_span_and_seconds(recorder, tmp_path):
    tr = _engine(tmp_path).trainer
    recorder.drain()
    tr.evaluate(tr.val_pairs)
    spans = _by_name(recorder.drain())
    (ev,) = spans["trainer.evaluate"]
    assert tr.eval_seconds == (ev.end_ns - ev.start_ns) / 1e9
    assert {"trainer.evaluate.embed", "trainer.evaluate.ranks"} <= set(spans)


# ---- the server -------------------------------------------------------------------

def test_every_request_is_in_one_batch_and_its_queue_ends_at_the_batch_start(recorder):
    emb = _emb()
    rec = _server(emb)
    recorder.drain()          # the warm-up's searches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)   # many thread switches: submits race the worker
    try:
        futs = _load(rec, emb, 160, threads=8)
    finally:
        sys.setswitchinterval(interval)
        rec.close()           # the worker joined: its last counts are in
    queue_ring = list(rec._stats.queue_ms)
    assert all(f.exception() is None for f in futs)
    spans = _by_name(recorder.drain())
    batches = spans["server.batch"]
    ids = [i for b in batches for i in b.attrs["ids"]]
    assert sorted(ids) == list(range(1, 161))
    by_id = {r.id: r for rs in spans.values() for r in rs}
    queue = []
    for b in batches:
        assert len(b.attrs["ids"]) == len(b.attrs["submitted_ns"]) <= 8
        assert all(t <= b.start_ns for t in b.attrs["submitted_ns"])
        queue.extend((b.start_ns - t) / 1e6 for t in b.attrs["submitted_ns"])
    for part in ("server.pack", "server.search", "server.answer"):
        assert len(spans[part]) == len(batches)
        assert all(_inside(r, by_id[r.parent]) and by_id[r.parent].name == "server.batch"
                   for r in spans[part])
    # A batch is taken where its linger ends, on the worker thread.
    lingers = sorted(spans["server.linger"], key=lambda r: r.start_ns)
    for b in batches:
        linger = max((g for g in lingers if g.start_ns <= b.start_ns), key=lambda g: g.start_ns)
        assert b.start_ns <= linger.end_ns and linger.thread == b.thread
    assert sorted(queue) == sorted(queue_ring)


def test_server_stats_report_queue_and_service(off):
    emb = _emb()
    rec = _server(emb)
    try:
        _load(rec, emb, 64)
    finally:
        rec.close()           # the worker joined: its last counts are in
    snap = rec.stats()
    lat, queue, service = (list(rec._stats.latencies_ms), list(rec._stats.queue_ms),
                           list(rec._stats.service_ms))
    assert snap["num_requests"] == 64 == len(queue) == len(service)
    assert {"queue_ms_p50", "queue_ms_p99", "service_ms_p50", "service_ms_p99",
            "latency_ms_p50", "latency_ms_p95", "latency_ms_p99"} <= set(snap)
    assert snap["queue_ms_p50"] <= snap["queue_ms_p99"]
    assert snap["service_ms_p50"] <= snap["service_ms_p99"]
    # Submit to the copy back is the queue and part of the batch's service.
    for lt, q, s in zip(lat, queue, service):
        assert q <= lt <= q + s
    rec.reset_stats()
    assert rec.stats()["queue_ms_p50"] == 0.0
