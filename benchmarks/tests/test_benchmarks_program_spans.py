"""The per-layer metrics read from the port's program spans
(``benchmarks/program_spans.py``), on the CPU at tiny sizes.

The port records its spans while a ``torch.profiler`` runs, which in a
traced run on the card is the measured window. The harness profiles only a
card, so a traced run here is given a CPU profiler over the same window
(``PROFILE_CPU``), the way the card's run has its CUDA one. An untraced
run records no span at all.
"""

from __future__ import annotations

import random
import types

import pytest

from benchmarks import harness, program_spans

from . import tiny

# Run before the cell: a traced window profiles the CPU, as a traced window
# on the card profiles the card; and the spans the port records are counted
# into the result object.
PROFILE_CPU = """
import contextlib
from torch.profiler import ProfilerActivity, profile
_window = harness.Run.window

@contextlib.contextmanager
def window(self):
    if not self.trace:
        with _window(self):
            yield
        return
    with profile(activities=[ProfilerActivity.CPU]):
        with _window(self):
            yield

harness.Run.window = window
"""

COUNT = """
from movie_recommendation_engine_tpu_torch.core import logging as plog
_add, _run_cell, _seen = plog.RECORDER.add, harness.run_cell, set()

def add(record):
    _seen.add(record.name)
    _add(record)

def run_cell(*a, **k):
    out = _run_cell(*a, **k)
    out["recorded"] = sorted(_seen)
    return out

plog.RECORDER.add, harness.run_cell = add, run_cell
"""

TRAIN = {"train.walks_ms", "train.pool_build_ms", "train.batches_ms", "train.embed_ms",
         "train.ranks_ms"}
SERVE = {"server.queue_ms", "server.service_ms", "server.search_ms"}


@pytest.mark.parametrize("cell,names", [
    ("tiny-hub-train", TRAIN), ("tiny-dense-train", TRAIN), ("tiny-serve", SERVE)])
def test_traced_run_reports_program_span_metrics(checkout, cell, names):
    out = tiny.run_cell(checkout, cell, seed=3, seconds=1.0, trace=True,
                        patch=PROFILE_CPU + COUNT)
    assert names <= set(out["metrics"])
    assert all(out["metrics"][n]["value"] > 0 for n in names)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("cell", ["tiny-hub-train", "tiny-serve"])
def test_untraced_run_records_no_span(checkout, cell):
    out = tiny.run_cell(checkout, cell, seed=2 ** 31 + 5, seconds=1.0, patch=PROFILE_CPU + COUNT)
    assert out["recorded"] == []
    assert out["correct"] is True, out["checks"]


def test_a_port_without_a_recorder_reads_nothing(monkeypatch):
    """The parent of the change that added the spans has no ``drain``: every
    reader returns None, and nothing raises or notes."""
    from movie_recommendation_engine_tpu_torch.core import logging as plog

    monkeypatch.delattr(plog, "drain")
    run = types.SimpleNamespace(records={}, device_trace=None, note=None)
    for name in sorted(TRAIN | SERVE):
        assert harness.load_reader(name).read(run) is None
    assert run.records["program_spans"] == []


# ---- the attribution, against a scan of every span for every gap -------------------

def _random_case(rng: random.Random):
    t0, t1 = 1_000, 50_000
    ops, t = [], t0 + rng.randrange(0, 500)
    while t < t1:
        d = rng.randrange(1, 400)
        ops.append(("op", t, t + d))
        t += d + rng.choice([0, 0, rng.randrange(1, 900)])
    spans, sid = [], 0
    for thread in range(3):
        t = t0 - 200
        while t < t1:
            sid += 1
            outer = (f"t{thread}.outer", t, t + rng.randrange(50, 3000), sid, None, str(thread), {})
            spans.append(outer)
            if rng.random() < 0.6:
                a = rng.randrange(outer[1], outer[2])
                sid += 1
                spans.append((f"t{thread}.inner", a, rng.randrange(a + 1, outer[2] + 1), sid,
                              outer[3], str(thread), {}))
            t = outer[2] + rng.randrange(0, 400)
    return sorted(ops, key=lambda o: o[1]), spans, t0, t1


def _scan_idle(ops, spans, t0, t1):
    named = {}
    for start, end in program_spans._gaps(ops, t0, t1):
        inside = [s for s in spans if s[1] <= start < s[2]]
        key = max(inside, key=lambda s: (s[1], s[3]))[0] if inside else program_spans.OUTSIDE
        named[key] = named.get(key, 0.0) + (end - start) / 1e9
    return named


def _scan_over_gaps(ops, spans, t0, t1):
    named = {}
    for start, end in program_spans._gaps(ops, t0, t1):
        for t in range(start, end):
            inside = [s for s in spans if s[1] <= t < s[2]]
            key = max(inside, key=lambda s: (s[1], s[3]))[0] if inside else program_spans.OUTSIDE
            named[key] = named.get(key, 0) + 1
    return {k: v / 1e9 for k, v in named.items()}


def _scan_busy(ops, spans, t0, t1):
    busy = set()
    for _, s, f in ops:
        busy.update(range(max(s, t0), min(f, t1)))
    out = {}
    for name in {s[0] for s in spans}:
        inside = set()
        for s in spans:
            if s[0] == name:
                inside.update(range(s[1], s[2]))
        out[name] = 100.0 * len(busy & inside) / len(busy)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_idle_and_busy_attribution_equal_a_scan(seed):
    ops, spans, t0, t1 = _random_case(random.Random(seed))
    got = program_spans.idle_by_span(ops, spans, t0, t1)
    want = _scan_idle(ops, spans, t0, t1)
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(want[k], abs=1e-15) for k in want)
    got = program_spans.idle_over_spans(ops, spans, t0, t1)
    want = _scan_over_gaps(ops, spans, t0, t1)
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(want[k], abs=1e-15) for k in want)
    got = program_spans.busy_in_spans(ops, spans, t0, t1)
    want = _scan_busy(ops, spans, t0, t1)
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(want[k], rel=1e-12) for k in want)
