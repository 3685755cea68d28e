"""The HSTU training cell and the LSH serving cell end to end on the CPU at
tiny sizes: each added to the tiny checkout as data files (a configuration
and a cell, appended to the metrics' lists as the real cells are), held to
the committed limits of the cell it stands for; the new readers on a
PinSage cell; the benchmark's HSTU reference against the tests' one; and
the faults each check is there to catch."""

import json
import os

import pytest
import torch

from . import tiny

# float32 matmuls: the committed limits are set at the cell's 25,600 positions
# a step, whose loss averages bf16's rounding away, and a tiny step's does not.
TINY_HSTU = {
    "model.arch": "hstu", "model.embed_dim": 32, "model.num_layers": 2, "model.dropout": 0.2,
    "model.hstu_heads": 2, "model.hstu_dqk": 16, "model.hstu_dv": 16, "model.hstu_max_len": 24,
    "data.use_data_subset": False, "train.batch_size": 16, "train.num_negative_samples": 16,
    "train.nce_temperature": 0.05, "train.learning_rate": 0.001,
    "train.compute_dtype": "float32", "train.seed": 42, "train.num_workers": 1,
}
CELLS = {"tiny-hstu-train": ("tiny-hstu", "seq_epochs", {}, "ml20m-hstu-train"),
         "tiny-serve-lsh": ("tiny-hub", "open_loop_item_lsh",
                            {"rate_per_s": 200.0, "warm_s": 0.2, "check_requests": 50},
                            "ml25m-serve-lsh")}


@pytest.fixture(scope="module")
def cells(checkout):
    """The tiny HSTU configuration and the two tiny cells in the checkout."""
    b = os.path.join(checkout, "benchmarks")
    corpus = {"num_movies": 300, "num_users": 400, "num_ratings": 24000, "seed": 7}
    tiny._dump(os.path.join(b, "configs", "tiny-hstu.json"),
               {"name": "tiny-hstu", "source": "a tiny CPU test configuration",
                "corpus": corpus, "port_config": TINY_HSTU})
    path = os.path.join(checkout, "BENCHMARK.json")
    bench = json.load(open(path))
    for name, (config, traffic, params, stands_for) in CELLS.items():
        tiny._dump(os.path.join(b, "workloads", f"{name}.json"),
                   {"config": config, "traffic": traffic, "params": params,
                    "limits": tiny.limits(stands_for), "why": "tiny"})
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if stands_for in m.get("workloads", []):
                m["workloads"].append(name)
    json.dump(bench, open(path, "w"))
    return checkout


def test_tiny_hstu_cell_runs_and_is_correct(cells):
    out = tiny.run_cell(cells, "tiny-hstu-train", seed=2 ** 31 + 19, seconds=1.5)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert {"setup_s", "train_ex_per_s"} <= set(out["metrics"])
    assert {"loss_gap", "grad_gap", "change_gap", "emb_gap"} <= set(out["checks"])


def test_traced_hstu_run_reports_its_metrics(cells):
    out = tiny.run_cell(cells, "tiny-hstu-train", seed=3, seconds=1.0, trace=True)
    # The program's spans record while a profiler of the card runs, so the
    # span readers (train.batches_ms, .embed_ms, .ranks_ms) read nothing here.
    names = {"hstu.mfu", "hstu.pad_share", "train.step_ms", "train.val_ms"}
    assert names <= set(out["metrics"])
    assert 0 < out["metrics"]["hstu.pad_share"]["value"] < 100
    assert out["metrics"]["hstu.mfu"]["value"] > 0


def test_new_readers_read_nothing_on_a_pinsage_cell(cells):
    bench = json.load(open(os.path.join(cells, "BENCHMARK.json")))
    for name in ("hstu.mfu", "hstu.pad_share"):
        assert "tiny-hub-train" in next(m for m in bench["per_layer"]
                                        if m["name"] == name)["workloads"]
    out = tiny.run_cell(cells, "tiny-hub-train", seed=3, seconds=1.0, trace=True)
    assert "train.refresh_ms" in out["metrics"]
    assert not {"hstu.mfu", "hstu.pad_share"} & set(out["metrics"])


def test_benchmark_reference_forward_equals_the_tests_reference():
    from benchmarks.reference import hstu as bref
    from tests import hstu_reference as tref

    dm = bref.Dims(16, 2, 2, 8, 8, 12, 128, 0.0, 0.0)
    p = bref.init(5, 30, dm, "cpu")
    g = torch.Generator().manual_seed(6)
    ids = torch.randint(-1, 30, (4, 12), generator=g).sort(dim=1, descending=True).values
    ts = torch.cumsum(torch.randint(1, 10 ** 6, (4, 13), generator=g), dim=1)
    want = tref.forward(p, ids, ts, heads=2, dqk=8, dv=8, buckets=128)
    got = bref.forward(p, ids, ts, dm, bref.Precision("f32"))
    real = ids >= 0
    torch.testing.assert_close(got[real], want[real], atol=1e-5, rtol=0)


ADAM_UNCHANGED = """
import movie_recommendation_engine_tpu_torch.train.optim as o
o.adam_update = lambda grads, state, params, lr, **kw: (params, state)
"""
HALF_POSITIONS = """
import torch
import movie_recommendation_engine_tpu_torch.models.hstu as H
_loss = H.sampled_softmax_loss
def half(states, rows, targets, negatives, temperature):
    odd = torch.arange(targets.shape[-1], device=targets.device) % 2 == 1
    return _loss(states, rows, torch.where(odd, -1, targets), negatives, temperature)
H.sampled_softmax_loss = half
"""
NO_BIAS = """
import torch
import movie_recommendation_engine_tpu_torch.models.hstu as H
H.bias_lookup = lambda w, index: (w[:1] * 0).reshape(()).expand(index.shape)
"""
ANSWER_ALTERED = """
import torch
import movie_recommendation_engine_tpu_torch.retrieval.lsh as L
_rerank = L._exact_rerank
def altered(q, emb, sqnorm, cand, k):
    d, i = _rerank(q, emb, sqnorm, cand, k)
    return d, torch.roll(i, 1, dims=1)
L._exact_rerank = altered
"""
ONE_ANSWER_ALTERED = """
import torch
import benchmarks.drivers.serve_lsh as S
from benchmarks.reference import lsh as R
_compare = S.compare
def altered(run, served, want, planes, k, c):
    # The first judged answer without its best item, the reference's
    # (k + 1)-th taken in, each score true to its id in float32.
    e, q = served["emb"].double(), torch.as_tensor(served["queries"][0]).double()
    ids, _, _ = R.answers(served["emb"], planes, torch.as_tensor(served["queries"][:1]),
                          served["excludes"][:1], k + 1, c)
    served["ids"][0] = ids[0][1:]
    served["scores"][0] = [float(torch.tensor(float(-((e[i] - q) ** 2).sum()),
                                              dtype=torch.float32)) for i in ids[0][1:]]
    return _compare(run, served, want, planes, k, c)
S.compare = altered
"""
TF32_RERANK = """
import torch
import movie_recommendation_engine_tpu_torch.retrieval.lsh as L
_rerank = L._exact_rerank
def tf32(x):
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
def rounded(q, emb, sqnorm, cand, k):
    return _rerank(tf32(q), tf32(emb), sqnorm, cand, k)
L._exact_rerank = rounded
"""


@pytest.mark.parametrize("cell,patch,fails", [
    ("tiny-hstu-train", ADAM_UNCHANGED, "change_gap"),
    ("tiny-hstu-train", HALF_POSITIONS, "grad_gap"),
    ("tiny-hstu-train", NO_BIAS, "change_gap"),
    ("tiny-serve-lsh", ANSWER_ALTERED, "id_mismatch"),
    ("tiny-serve-lsh", ONE_ANSWER_ALTERED, "rank_gap"),
    ("tiny-serve-lsh", TF32_RERANK, "score_gap"),
])
def test_fault_makes_the_run_incorrect(cells, cell, patch, fails):
    out = tiny.run_cell(cells, cell, seed=21, seconds=0.5, patch=patch)
    assert out["correct"] is False
    c = out["checks"][fails]
    assert c["value"] > c["limit"], out["checks"]


def test_tiny_lsh_cell_runs_and_is_correct(cells):
    out = tiny.run_cell(cells, "tiny-serve-lsh", seed=2 ** 31 + 23, seconds=1.5)
    assert out["correct"] is True, out["checks"]
    assert {"setup_s", "serve_p50_ms"} <= set(out["metrics"])
    assert out["checks"]["id_mismatch"]["value"] == 0.0


def test_lsh_reference_sure_distance_bounds_its_answers(monkeypatch):
    """The distance every rounding of the signatures reaches lies at or
    beyond the reference's own k-th answer; with no sign left in doubt it is
    that answer's; with every sign in doubt no item is surely shortlisted."""
    from benchmarks.reference import lsh as R

    g = torch.Generator().manual_seed(3)
    emb, queries = torch.randn((400, 16), generator=g), torch.randn((9, 16), generator=g)
    planes = R.planes(5, 16, 32, 4)
    excludes = [[i] for i in range(9)]
    ids, scores, sure = R.answers(emb, planes, queries, excludes, 5, 60)
    assert all(len(a) == 5 and s >= -sc[-1] - 1e-12 for a, sc, s in zip(ids, scores, sure))
    monkeypatch.setattr(R, "SIGN_TOL", 0.0)
    ids0, scores0, sure0 = R.answers(emb, planes, queries, excludes, 5, 60)
    assert ids0 == ids
    assert sure0 == pytest.approx([-sc[-1] for sc in scores0], rel=1e-12)
    monkeypatch.setattr(R, "SIGN_TOL", 1.0)
    assert R.answers(emb, planes, queries, excludes, 5, 60)[2] == [float("inf")] * 9


def test_hstu_train_flops_by_hand():
    from benchmarks.yardstick import hstu

    # d 4, 2 blocks, 1 head, dqk 2, dv 3, 5 negatives; 7 real positions, 10
    # attention pairs, 6 supervised positions:
    # f1 2*7*4*(2*1*(3+2)) = 560, f2 2*7*3*4 = 168, attention 2*10*(2+3) = 100,
    # loss 2*6*(1+5)*4 = 288; forward 2*(560+168+100) + 288 = 1944, times 3.
    assert hstu.train_flops(4, 2, 1, 2, 3, 5, 7, 10, 6) == 3 * 1944
