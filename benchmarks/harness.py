"""The benchmark's harness: finds a cell's files by name, times set-up and
the measured window, takes the traced run's device window, reads the
per-layer metrics and assembles the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by name:

- ``BENCHMARK.json`` (the checkout's root): the metrics and the cells that
  report each;
- ``benchmarks/workloads/<cell>.json``: the cell's configuration, traffic
  mix, its own parameters (a serving rate) and the limits of its checks;
- ``benchmarks/configs/<config>.json``: sizes, the port's ``Config``
  settings (``port_config``) and the corpus;
- ``benchmarks/traffic/<mix>.json``: the mix's parameters and the driver
  (``benchmarks/drivers/<driver>.py``) that runs it;
- ``benchmarks/metrics/<metric>.py``: one per-layer metric's reader,
  ``read(run) -> float | None``.

A driver builds the program's objects, runs set-up inside ``run.setup()``,
the measured work inside ``run.window()``, sets the end-to-end values in
``run.e2e`` and, after the window, the checks in ``run.check(...)``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import re
import sys
import time
from typing import Any

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache")
# Whole top-level module names the process may not hold once the window has
# closed: the port's name begins with the JAX package's, so names are
# compared whole, never by prefix.
FORBIDDEN = ("jax", "jaxlib", "flax", "movie_recommendation_engine_tpu")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's nvcc builds already land in ``<port>/ops/build``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_spec(cell: str) -> dict:
    """The cell's workload, configuration, mix and the root benchmark file;
    the cell's entry in ``BENCHMARK.json`` must name the same configuration
    and mix as its workload file."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    work = load_json(os.path.join(BENCH, "workloads", f"{cell}.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"cell {cell!r} is not in BENCHMARK.json")
    if (entry["config"], entry["traffic"]) != (work["config"], work["traffic"]):
        raise ValueError(f"cell {cell!r}: BENCHMARK.json names ({entry['config']}, "
                         f"{entry['traffic']}), its workload file ({work['config']}, "
                         f"{work['traffic']})")
    return {"cell": cell, "bench": bench, "work": work, "entry": entry,
            "config": load_json(os.path.join(BENCH, "configs", f"{work['config']}.json")),
            "mix": load_json(os.path.join(BENCH, "traffic", f"{work['traffic']}.json"))}


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that ``cell``
    reports: those whose ``workloads`` list it, or that list none."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmarks_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linearly interpolated."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Run:
    """One run of one cell: its spec, seed, length and device, and what the
    driver and the window record for the readers."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool, device: str):
        self.spec, self.seed, self.seconds, self.trace = spec, int(seed), float(seconds), trace
        self.device = device
        self.cell = spec["cell"]
        self.params = dict(spec["work"].get("params", {}))
        self.limits = spec["work"].get("limits", {})
        self.e2e: dict[str, float] = {}
        self.checks: dict[str, tuple[float, float]] = {}
        self.readings: dict[str, float] = {}           # numbers read, not compared
        self.attempted = 0
        self.failed = 0
        self.spans: list[tuple[str, int, int]] = []      # (name, start ns, end ns), time.time_ns
        self.records: dict[str, Any] = {}                 # for the readers
        self.setup_s: float | None = None
        self.window_s: float | None = None
        self.window_ns: tuple[int, int] | None = None
        self.device_trace: dict | None = None
        self.memory_peak_bytes = 0

    # ---- timing ----------------------------------------------------------

    def sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def note(self, what: str, **fields) -> None:
        print(json.dumps({"note": what, **fields}), file=sys.stderr, flush=True)

    @contextlib.contextmanager
    def span(self, name: str):
        """Host-clock span of the block, the device synchronized at its end."""
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.sync()
            self.spans.append((name, t0, time.time_ns()))

    @contextlib.contextmanager
    def setup(self):
        """Set-up, timed; it ends by collecting its garbage and moving every
        object it made out of the collector's reach (``gc.freeze``), so that
        a full collection in the window walks only what the window made.
        The port does not freeze its heap itself: as it ships, a full
        collection walks the whole set-up heap, 90-170 ms in the serving
        cell (see PERF.md)."""
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - t0
        self.e2e["setup_s"] = self.setup_s

    @contextlib.contextmanager
    def window(self):
        """The measured window; in a traced run a ``torch.profiler`` window
        (device activity only) over exactly it."""
        prof = None
        if self.trace and self.device == "cuda":
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        pauses: list[float] = []
        started = [0.0]

        def on_gc(phase, info):
            if phase == "start":
                started[0] = time.perf_counter()
            elif info.get("generation") == 2:
                pauses.append(time.perf_counter() - started[0])

        gc.callbacks.append(on_gc)
        self.sync()
        t0, n0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.sync()
            self.window_s = time.perf_counter() - t0
            gc.callbacks.remove(on_gc)
            self.records["gc_gen2_pauses_s"] = pauses
            self.window_ns = (n0, time.time_ns())
            if prof is not None:
                prof.stop()
                self.device_trace = digest(prof, *self.window_ns, self.spans)
            if self.device == "cuda":
                import torch
                self.memory_peak_bytes = max(int(torch.cuda.max_memory_allocated(i))
                                             for i in range(torch.cuda.device_count()))

    def check(self, name: str, value: float, limit: float | None = None) -> None:
        """A compared number and its limit (the workload file's ``limits``
        unless given); the run is correct only if every value is at most
        its limit. A number the cell's file gives no limit is a reading
        only (see PERF.md for why a cell leaves one uncompared)."""
        if limit is None and name not in self.limits:
            self.readings[name] = float(value)
            return
        lim = self.limits[name] if limit is None else limit
        self.checks[name] = (float(value), float(lim))

    def spans_named(self, name: str) -> list[float]:
        return [(t1 - t0) / 1e9 for n, t0, t1 in self.spans if n == name]


def digest(prof, t0_ns: int, t1_ns: int, spans) -> dict:
    """The device operations of a profiler window: their time by name, the
    union of their intervals (busy seconds), and the longest idle gaps named
    by the harness span that holds their start."""
    from torch.autograd import DeviceType

    ops = []
    for e in prof.profiler.kineto_results.events():
        if _on_device(e, DeviceType.CUDA):
            ops.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    ops.sort(key=lambda o: o[1])
    by_name: dict[str, float] = {}
    busy, gaps, end = 0, [], t0_ns
    for name, s, f in ops:
        by_name[name] = by_name.get(name, 0.0) + (f - s) / 1e9
        s, f = max(s, t0_ns), min(f, t1_ns)
        if f <= s:
            continue
        if s > end:
            gaps.append((s - end, end))
            busy += f - s
        elif f > end:
            busy += f - end
        end = max(end, f)
    if t1_ns > end:
        gaps.append((t1_ns - end, end))

    def where(t):
        inside = [(b - a, n) for n, a, b in spans if a <= t < b]
        return min(inside)[1] if inside else "outside spans"

    gaps.sort(reverse=True)
    named: dict[str, float] = {}
    for length, start in gaps:
        key = where(start)
        named[key] = named.get(key, 0.0) + length / 1e9
    return {"ops": ops, "by_name": by_name, "busy_s": busy / 1e9,
            "window_s": (t1_ns - t0_ns) / 1e9,
            "top_ops": [(short_name(n), t) for n, t in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
            "top_gaps": [[f"{where(st)} @{(st - t0_ns) / 1e9:.3f}s", ln / 1e9]
                         for ln, st in gaps[:10]],
            "idle_by_span": sorted(named.items(), key=lambda kv: -kv[1])[:10]}


def short_name(name: str) -> str:
    """A device op's name without its template arguments and parameters,
    with the functor or copy kernel named inside them, if any:
    ``at::native::elementwise_kernel [DivFunctor]``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i >= 0), default=len(name))
    base = name[:cut]
    hints = re.findall(r"(\w*(?:Functor|functor|_kernel_cuda)\w*)", name[cut:])
    return f"{base} [{hints[-1]}]" if hints else base


def _on_device(e, cuda) -> bool:
    """A kernel, copy or set on the device (not an annotation's span)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind()).lower() in DEVICE_KINDS
    annotation = getattr(e, "is_user_annotation", None)
    return e.device_type() == cuda and not (annotation is not None and annotation())


def device_info(device: str, count: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """One run of ``cell``; returns the result object (see ``run.py``)."""
    spec = load_spec(cell)
    run = Run(spec, seed, seconds, trace, device)
    driver = importlib.import_module(f"benchmarks.drivers.{spec['mix']['driver']}")
    driver.run(run)
    bench = spec["bench"]
    metrics: dict[str, dict] = {}
    if not trace:
        for m in cell_metrics(bench, cell, "end_to_end"):
            if m["name"] in run.e2e:
                metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
            else:
                run.note("metric_missing", metric=m["name"])
    else:
        for m in cell_metrics(bench, cell, "per_layer"):
            value = load_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(device, spec["entry"]["chips"])
    dev["memory_peak_bytes"] = run.memory_peak_bytes
    out = {"correct": None, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if trace and run.device_trace is not None:
        dev["busy_s"] = run.device_trace["busy_s"] / max(dev["count"], 1)
        dev["window_s"] = run.device_trace["window_s"]
        out["breakdown"] = {"device_ops": [[n, s] for n, s in run.device_trace["top_ops"]],
                            "idle_gaps": [[n, s] for n, s in run.device_trace["idle_by_span"]]}
    elif trace:
        dev["busy_s"] = 0.0
        dev["window_s"] = run.window_s or 0.0
    if run.readings:
        run.note("uncompared", **run.readings)
    ok = bool(run.checks) and run.failed == 0 and all(
        v <= lim for v, lim in run.checks.values())
    out["correct"] = ok
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out
