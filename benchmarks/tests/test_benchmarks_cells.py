"""The harness end to end on the CPU at tiny sizes, through the port's plain
paths: each driver's result line, the per-layer readers, and cells and
metrics that are only added files."""

import json
import os

import pytest

from . import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", ["tiny-hub-train", "tiny-dense-train", "tiny-serve"])
def test_cell_runs_and_is_correct(checkout, cell):
    out = tiny.run_cell(checkout, cell, seed=2 ** 31 + 17, seconds=1.5)
    assert KEYS <= set(out)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert "setup_s" in out["metrics"] and out["metrics"]["setup_s"]["value"] > 0
    other = {"train_ex_per_s"} if "train" in cell else {"serve_p50_ms"}
    assert other <= set(out["metrics"])
    assert out["device"]["platform"] == "cpu"
    assert list(out)[-1] == "checks"
    assert out["checks"]["tables_mismatch"]["value"] == 0.0


@pytest.mark.parametrize("cell,names", [
    ("tiny-hub-train", {"train.refresh_ms", "train.val_ms", "train.mfu"}),
    ("tiny-serve", {"server.batch_mean", "serve.p99_ms"}),
])
def test_traced_run_reports_per_layer_metrics(checkout, cell, names):
    out = tiny.run_cell(checkout, cell, seed=3, seconds=1.0, trace=True)
    assert names <= set(out["metrics"])
    assert "setup_s" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])


def test_added_files_make_a_cell_and_a_metric(checkout, tmp_path):
    """A new cell and a new per-layer metric are data and reader files
    only: the harness runs them without an edit."""
    b = os.path.join(checkout, "benchmarks")
    with open(os.path.join(b, "metrics", "test.epochs_seen.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.records.get('epochs', [])))\n")
    with open(os.path.join(b, "traffic", "test_one_epoch.json"), "w") as f:
        json.dump({"driver": "train", "start_epoch": 1, "check_steps": 3,
                   "overrides": {"train.max_pairs_per_epoch": 192}}, f)
    with open(os.path.join(b, "workloads", "test-added.json"), "w") as f:
        json.dump({"config": "tiny-dense", "traffic": "test_one_epoch", "params": {},
                   "limits": tiny.limits("ml20m-train-full"), "why": "added"}, f)
    path = os.path.join(checkout, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["workloads"].append({"name": "test-added", "config": "tiny-dense",
                               "traffic": "test_one_epoch", "chips": 1, "why": "added"})
    bench["end_to_end"][1]["workloads"].append("test-added")
    bench["per_layer"].append({"name": "test.epochs_seen", "unit": "epochs", "better": "higher",
                               "source": "program_counter", "layer": "train driver",
                               "moves": "train_ex_per_s", "workloads": ["test-added"]})
    json.dump(bench, open(path, "w"))
    out = tiny.run_cell(checkout, "test-added", seed=4, seconds=0.5, trace=True)
    assert out["metrics"]["test.epochs_seen"]["value"] >= 1
    assert out["correct"] is True, out["checks"]


@pytest.mark.cuda
def test_cell_on_the_card(card, checkout):
    out = tiny.run_cell(checkout, "tiny-hub-train", seed=9, seconds=1.0, device="cuda")
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
