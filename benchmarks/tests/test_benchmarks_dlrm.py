"""The DLRM-DCNv2 training cell end to end on the CPU at a tiny size: a tiny
click configuration and cell added to the tiny checkout as data files
(appended to the metrics' lists as the real cell is), held to the committed
limits of ``criteo-dlrm-train``; the new readers on a PinSage cell; the
click corpus through the port's reader; the benchmark's reference against
the tests' one; the yardstick by hand; and the faults each check is there
to catch."""

import json
import os

import numpy as np
import pytest
import torch

from . import tiny

BAGS, HELD, PUBLISHED = [3, 1, 6, 2], [40, 5, 120, 3], [80, 5, 120, 3]
CORPUS = {"seed": 7, "dense_features": 13, "bag_sizes": BAGS, "rows_held": HELD,
          "train_samples": 20 * 32 + 7, "val_samples": 96, "zipf_s": 1.05,
          "click_rate": 0.2, "id_weight": 0.3}
# float32 matmuls: the committed limits are set at the cell's 8,192 samples a
# step, whose loss and logits average bf16's rounding away, and a tiny
# step's do not.
TINY_DLRM = {
    "model.arch": "dlrm_dcnv2", "model.embed_dim": 16, "model.dlrm_dense_features": 13,
    "model.dlrm_bag_sizes": BAGS, "model.dlrm_table_rows": PUBLISHED,
    "model.dlrm_rows_held": HELD, "model.dlrm_bottom": [24, 16], "model.dlrm_top": [32, 16, 1],
    "model.dlrm_cross_layers": 2, "model.dlrm_cross_rank": 8, "train.batch_size": 32,
    "train.learning_rate": 0.004, "train.compute_dtype": "float32", "train.seed": 42,
}
CELL = "tiny-dlrm-train"


@pytest.fixture(scope="module")
def cells(checkout):
    """The tiny click configuration and its cell in the checkout."""
    b = os.path.join(checkout, "benchmarks")
    tiny._dump(os.path.join(b, "configs", "tiny-dlrm.json"),
               {"name": "tiny-dlrm", "source": "a tiny CPU test configuration",
                "corpus": CORPUS, "port_config": TINY_DLRM})
    path = os.path.join(checkout, "BENCHMARK.json")
    bench = json.load(open(path))
    tiny._dump(os.path.join(b, "workloads", f"{CELL}.json"),
               {"config": "tiny-dlrm", "traffic": "click_epochs", "params": {},
                "limits": tiny.limits("criteo-dlrm-train"), "why": "tiny"})
    bench["workloads"].append({"name": CELL, "config": "tiny-dlrm", "traffic": "click_epochs",
                               "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "criteo-dlrm-train" in m.get("workloads", []):
            m["workloads"].append(CELL)
    json.dump(bench, open(path, "w"))
    return checkout


def test_tiny_click_cell_runs_and_is_correct(cells):
    out = tiny.run_cell(cells, CELL, seed=2 ** 31 + 29, seconds=1.5)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert {"setup_s", "train_ex_per_s"} <= set(out["metrics"])
    assert {"grad_gap", "change_gap", "loss_gap", "logit_gap"} <= set(out["checks"])


def test_traced_click_run_reports_its_metrics(cells):
    from .test_benchmarks_program_spans import PROFILE_CPU

    out = tiny.run_cell(cells, CELL, seed=3, seconds=1.0, trace=True, patch=PROFILE_CPU)
    # The device trace's readers (the bags' roofline, the idle share) read
    # nothing without a card.
    names = {"dlrm.mfu", "dlrm.unique_share", "train.step_ms", "train.val_ms",
             "train.batches_ms"}
    assert names <= set(out["metrics"]), out["metrics"]
    assert 0 < out["metrics"]["dlrm.unique_share"]["value"] <= 100
    assert out["metrics"]["dlrm.mfu"]["value"] > 0


def test_new_readers_read_nothing_on_a_pinsage_cell(cells):
    bench = json.load(open(os.path.join(cells, "BENCHMARK.json")))
    names = ("dlrm.mfu", "dlrm.bag_roofline", "dlrm.unique_share")
    for name in names:
        assert "tiny-hub-train" in next(m for m in bench["per_layer"]
                                        if m["name"] == name)["workloads"]
    out = tiny.run_cell(cells, "tiny-hub-train", seed=3, seconds=1.0, trace=True)
    assert "train.refresh_ms" in out["metrics"]
    assert not set(names) & set(out["metrics"])


ADAGRAD_UNCHANGED = """
import movie_recommendation_engine_tpu_torch.train.optim as o
o.adagrad_update = lambda grads, acc, params, lr, **kw: None
o.rowwise_adagrad_update = lambda *a, **kw: None
"""
SKIP_TABLE = """
import movie_recommendation_engine_tpu_torch.train.optim as o
_update, _seen = o.rowwise_adagrad_update, [0]
def skip_first(table, *a, **kw):
    _seen[0] += 1
    if _seen[0] % 4 != 1:
        _update(table, *a, **kw)
o.rowwise_adagrad_update = skip_first
"""
HALF_BATCH = """
import types
import torch
import torch.nn.functional as F
import movie_recommendation_engine_tpu_torch.models.dlrm as M
def half(logits, labels):
    w = torch.ones_like(labels)
    w[1::2] = 0.0
    loss = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    return (loss * w).sum() / w.sum()
M.F = types.SimpleNamespace(binary_cross_entropy_with_logits=half, relu=F.relu)
"""
NO_X0 = """
import torch
import movie_recommendation_engine_tpu_torch.models.dlrm as M
def logits(params, dense, emb, dtype=torch.bfloat16):
    x = torch.cat([M.mlp(params["bottom"], dense, dtype, True), emb], dim=1)
    for c in params["cross"]:
        x = ((x.to(dtype) @ c["v"].to(dtype)) @ c["u"].to(dtype)).float() + c["b"] + x
    return M.mlp(params["top"], x, dtype, False)[:, 0]
M.logits = logits
"""


@pytest.mark.parametrize("patch,fails", [
    (ADAGRAD_UNCHANGED, "change_gap"),
    (SKIP_TABLE, "change_gap"),
    (HALF_BATCH, "grad_gap"),
    (NO_X0, "grad_gap"),
    (NO_X0, "logit_gap"),
])
def test_fault_makes_the_run_incorrect(cells, patch, fails):
    out = tiny.run_cell(cells, CELL, seed=21, seconds=0.5, patch=patch)
    assert out["correct"] is False
    c = out["checks"][fails]
    assert c["value"] > c["limit"], out["checks"]


def test_click_corpus_loads_through_the_port(tmp_path, monkeypatch):
    from benchmarks.corpus import criteo as corpus
    from movie_recommendation_engine_tpu_torch.config import Config
    from movie_recommendation_engine_tpu_torch.graph import criteo

    monkeypatch.setattr(corpus, "CACHE", str(tmp_path))
    spec = dict(CORPUS, train_samples=20000, val_samples=3000, click_rate=0.034)
    d, gen_s = corpus.ensure(spec)
    assert gen_s is not None and corpus.ensure(spec) == (d, None)
    cfg = Config().override({**TINY_DLRM, "data.source": "criteo", "data.data_dir": d})
    data = criteo.load(cfg)
    assert (data.train.size, data.val.size) == (20000, 3000)
    assert abs(float(data.train.labels.mean()) - 0.034) < 0.01
    assert data.train.dense.shape == (20000, 13) and float(data.train.dense.min()) >= 0
    first = data.train.sparse[2][:, 0]
    counts = np.bincount(first, minlength=HELD[2])
    assert counts.max() > 10 * counts.mean()        # Zipf-skewed first ids
    again = corpus.generate(spec, "val", corpus._tables(spec))
    assert np.array_equal(again[0], data.val.dense)
    assert all(np.array_equal(a, b) for a, b in zip(again[1], data.val.sparse))


def test_benchmark_reference_equals_the_tests_reference():
    from benchmarks.reference import dlrm as bref
    from tests import dlrm_reference as tref

    dm = bref.Dims(5, (3, 1, 6), (40, 5, 120), (80, 5, 120), 16, (24, 16), (32, 16, 1), 2, 8)
    tables = list(bref.init_tables(5, dm, "cpu"))
    dense = bref.init_dense(5, dm, "cpu")
    params = {"tables": [torch.cat([t, torch.zeros(1, 16)]) for t in tables], **dense}
    g = torch.Generator().manual_seed(6)
    batches = [(torch.rand((32, 5), generator=g),
                [torch.randint(0, r, (32, k), generator=g) for k, r in zip(dm.bags, dm.rows)],
                (torch.rand(32, generator=g) < 0.3).float()) for _ in range(3)]
    want = tref.train_steps(params, dm.rows, batches, 0.004)
    got = bref.train_steps([t.clone() for t in tables], dense, batches, 0.004,
                           bref.Precision("f32"))
    assert got["losses"] == pytest.approx(want["losses"], rel=1e-6)
    flat = bref.dense_leaves(want["params"])
    for k, v in got["dense"].items():
        torch.testing.assert_close(v, flat[k], atol=1e-6, rtol=0)
    x, ids, _ = batches[0]
    torch.testing.assert_close(
        bref.logits([t.clone() for t in tables], dense, (x, ids), bref.Precision("f32")),
        tref.DLRM(params, dm.rows)(x, ids).detach(), atol=1e-5, rtol=1e-5)


def test_reference_auc_and_yardstick_by_hand():
    from benchmarks.reference import dlrm as bref
    from benchmarks.yardstick import dlrm as y

    assert bref.auc(torch.tensor([0.1, 0.4, 0.4, 0.8]), torch.tensor([0.0, 0.0, 1.0, 1.0])) \
        == 0.875
    # bottom 3->4->2: 2*(12+8) = 40; two cross layers at width 6, rank 3:
    # 2*2*2*6*3 = 144; top 6->5->1: 2*(30+5) = 70.
    assert y.forward_flops(3, [4, 2], 6, 3, 2, [5, 1]) == 40 + 144 + 70
    assert y.train_flops(10, 3, [4, 2], 6, 3, 2, [5, 1]) == 30 * 254
    # 2 calls of bags [2, 1] on 4 samples at d 8, 5 distinct rows read:
    # per call 4*3*8 + 2*4*8*4 = 352; rows 5*8*4 = 160.
    assert y.bag_fwd_bytes(2, 4, [2, 1], 8, 5) == 2 * 352 + 160
    assert y.bag_bwd_bytes(2, 4, [2, 1], 8, 5) == 2 * (2 * 4 * 8 * 4 + 4 * 3 * 8) + 160


def test_bag_roofline_counts_every_bag_kernel_by_name():
    from benchmarks import harness

    counted = harness.load_reader("dlrm.bag_roofline").counted
    ours = ["void (anonymous namespace)::gather_pool_kernel<float, true>(float const*, int const*)",
            "void (anonymous namespace)::segment_sum_kernel<4, false>(int const*, int4 const*)",
            "void (anonymous namespace)::combine_kernel<4, false>(int const*, int const*)",
            "(anonymous namespace)::segment_plan_tile_kernel(int const*, int3*, int, int)",
            "(anonymous namespace)::segment_plan_offsets_kernel(int3*, int, int*)",
            "(anonymous namespace)::segment_plan_write_kernel(int const*, int3 const*, int4*)",
            "segment_plan_kernel"]
    others = ["void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*)",
              "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>(int*)",
              "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT", "Memset (Device)"]
    assert all(counted(n) for n in ours)
    assert not any(counted(n) for n in others)
