"""A temporary checkout of the benchmark with tiny cells, for the CPU tests:
the benchmark's files, the port package linked in, and tiny
configurations (a hub-rung one and a dense one), mixes and cells added as
data files, the way a later change adds cells."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
PORT = "movie_recommendation_engine_tpu_torch"

TINY_PORT = {
    "features.feature_dim": 32, "model.hidden_dim": 64, "model.embed_dim": 32,
    "model.num_layers": 2, "model.aggregator_type": "importance", "model.dropout": 0.2,
    "model.pool_impl": "auto", "model.gather_impl": "pallas",
    "walk.num_neighbors": 8, "walk.num_walks": 20, "walk.walk_length": 2,
    "train.batch_size": 64, "train.num_negative_samples": 32, "train.max_hard_negatives": 6,
    "train.loss": "nce", "train.learning_rate": 0.001, "train.compute_dtype": "bfloat16",
    "train.seed": 42, "train.epochs": 10, "train.num_workers": 1,
    "search.search_method": "exact", "serve.max_batch": 8, "serve.max_wait_ms": 2.0,
    "serve.max_k": 20,
}
HUB = {"model.dense_pool_max_rows": 64, "model.dense_pool_hybrid_max_rows": 64,
       "model.hub_pool_head": 64, "model.hub_pool_residual": 4}


def limits(cell: str) -> dict:
    """The committed limits of ``cell``, which its tiny stand-in is held to."""
    with open(os.path.join(BENCH, "workloads", f"{cell}.json")) as f:
        return json.load(f)["limits"]


# Each tiny cell is held to the limits of the cell it stands for.
STANDS_FOR = {"tiny-hub-train": "ml25m-train-full", "tiny-dense-train": "ml20m-train-full",
              "tiny-serve": "ml25m-serve-item"}


def make(dest: str) -> str:
    """The checkout at ``dest``; returns it."""
    shutil.copytree(BENCH, os.path.join(dest, "benchmarks"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, PORT), os.path.join(dest, PORT))
    b = os.path.join(dest, "benchmarks")
    corpus = {"num_movies": 300, "num_users": 600, "num_ratings": 24000, "seed": 7}
    for name, extra in (("tiny-hub", HUB), ("tiny-dense", {})):
        cfg = {"name": name, "source": "a tiny CPU test configuration", "corpus": corpus,
               "port_config": {**TINY_PORT, **extra}}
        _dump(os.path.join(b, "configs", f"{name}.json"), cfg)
    _dump(os.path.join(b, "traffic", "tiny_epochs.json"),
          {"driver": "train", "start_epoch": 6, "check_steps": 3,
           "overrides": {"train.max_pairs_per_epoch": 256, "eval.max_val_pairs": None}})
    cells = {"tiny-hub-train": ("tiny-hub", "tiny_epochs", {}),
             "tiny-dense-train": ("tiny-dense", "tiny_epochs", {}),
             "tiny-serve": ("tiny-hub", "open_loop_item", {"rate_per_s": 200.0, "warm_s": 0.2,
                                                           "check_requests": 50})}
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for name, (config, traffic, params) in cells.items():
        _dump(os.path.join(b, "workloads", f"{name}.json"),
              {"config": config, "traffic": traffic, "params": params,
               "limits": limits(STANDS_FOR[name]), "why": "tiny"})
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "tiny"})
        kind = "serve" if "serve" in name else "train"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(kind in w for w in m["workloads"]):
                m["workloads"].append(name)
    _dump(os.path.join(dest, "BENCHMARK.json"), bench)
    return dest


def _dump(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


RUNNER = """
import json, sys
sys.path.insert(0, {root!r})
from benchmarks import harness
{patch}
out = harness.run_cell({cell!r}, {seed}, {seconds}, {trace}, device={device!r})
found = harness.forbidden_modules()
if found:
    raise SystemExit(f"JAX modules loaded: {{found}}")
print(json.dumps(out))
"""


def run_cell(dest: str, cell: str, seed: int = 5, seconds: float = 1.0, trace: bool = False,
             patch: str = "", timeout: float = 600, device: str = "cpu") -> dict:
    """One CPU run of ``cell`` in the checkout, in its own process (the
    harness skips its look for a card); ``patch`` is Python run first, to
    break the timed path underneath. The process fails if it loaded a JAX
    module. Returns the result object."""
    env = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
    p = subprocess.run([sys.executable, "-c", RUNNER.format(
        root=dest, cell=cell, seed=seed, seconds=seconds, trace=trace, patch=patch,
        device=device)],
        cwd=dest, capture_output=True, text=True, timeout=timeout, env=env)
    if p.returncode != 0:
        raise RuntimeError(f"run failed ({p.returncode}):\n{p.stderr[-6000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])
