"""DLRM-DCNv2 on the port's training path (``models/dlrm.py``,
``train/click_trainer.py``, ``ops/pool.compact_rows`` / ``compact_grad``,
``train/optim.py``'s Adagrads, ``evaluation/metrics.auc``,
``graph/criteo.py``) against the plain reference (``tests/dlrm_reference.py``)
on the CPU, at a small size: 4 features with bags of 1-6 ids over tables of
3-120 rows (one held in part), d = 16, two cross layers of rank 8.

Tolerances, each with its reason:

- logits, loss and gradients in float32, 1e-5 relative to each tensor's
  largest element: the same float32 math in another order of sums
  (``gather_pool``'s plain version and matmuls against ``EmbeddingBag`` and
  ``nn.Linear``);
- params after 3 Adagrad steps 1e-6 absolute (lr 0.01): Adagrad divides each
  gradient by its own root sum of squares, so a gradient known to 1e-5 of
  its size moves its parameter by at most ~1e-7;
- bfloat16 matmuls: 0.05 relative on the logits, as bf16 rounds each
  operand to 2**-8 relative through six matmuls.
"""

from __future__ import annotations

import io
import os

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch import api, small_test_config
from movie_recommendation_engine_tpu_torch.core import tree
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
from movie_recommendation_engine_tpu_torch.evaluation import metrics
from movie_recommendation_engine_tpu_torch.graph import criteo, dataset
from movie_recommendation_engine_tpu_torch.models import dlrm
from movie_recommendation_engine_tpu_torch.ops import pool
from movie_recommendation_engine_tpu_torch.train import optim
from movie_recommendation_engine_tpu_torch.train.click_trainer import ClickTrainer
from movie_recommendation_engine_tpu_torch.train.loop import make_trainer
from tests import dlrm_reference as ref

BAGS, HELD, PUBLISHED = (3, 1, 6, 2), (40, 5, 120, 3), (80, 5, 120, 3)
DENSE, D, B, LR = 5, 16, 32, 0.01
DM = dlrm.Dims(DENSE, BAGS, HELD, PUBLISHED, D, (24, D), (32, 16, 1), 2, 8)


def _cfg(data_dir: str, **extra) -> object:
    return small_test_config().override({
        "model.arch": "dlrm_dcnv2", "data.source": "criteo", "data.data_dir": data_dir,
        "model.embed_dim": D, "model.dlrm_dense_features": DENSE,
        "model.dlrm_bag_sizes": list(BAGS), "model.dlrm_table_rows": list(PUBLISHED),
        "model.dlrm_rows_held": list(HELD), "model.dlrm_bottom": [24, D],
        "model.dlrm_top": [32, 16, 1], "model.dlrm_cross_layers": 2,
        "model.dlrm_cross_rank": 8, "train.batch_size": B, "train.learning_rate": LR,
        "train.compute_dtype": "float32", "train.epochs": 2,
        "paths.checkpoint_dir": os.path.join(data_dir, "ckpt"), **extra})


def _samples(seed: int, n: int):
    """``n`` samples: dense features log1p of log-normals, ids with repeats,
    labels that follow the dense features."""
    rng = np.random.default_rng(seed)
    dense = np.log1p(rng.lognormal(0.0, 1.0, (n, DENSE))).astype(np.float32)
    sparse = [rng.integers(0, r, (n, k)).astype(np.int32) for k, r in zip(BAGS, HELD)]
    labels = (rng.random(n) < 1 / (1 + np.exp(2 - dense[:, 0]))).astype(np.float32)
    return dense, sparse, labels


@pytest.fixture
def data_dir(tmp_path):
    d = str(tmp_path / "criteo")
    criteo.write_split(d, "train", *_samples(1, 5 * B + 7))
    criteo.write_split(d, "val", *_samples(2, 96))
    return d


def _params(seed: int = 0) -> dict:
    return dlrm.init_params(torch.Generator().manual_seed(seed), DM, "cpu")


def _batch(seed: int):
    dense, sparse, labels = _samples(seed, B)
    return (torch.from_numpy(dense), [torch.from_numpy(s) for s in sparse],
            torch.from_numpy(labels))


def _ones(b: int = B) -> list:
    return [torch.ones((b, k)) for k in BAGS]


def _close(got, want, rel=1e-5):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale, (got, want)


def test_forward_logits_match_the_reference():
    p = _params()
    dense, ids, _ = _batch(3)
    got = dlrm.predict(p, dense, ids, _ones(), DM, torch.float32)
    _close(got, ref.DLRM(p, HELD)(dense, ids).detach())


def test_bf16_logits_stay_near_the_reference():
    p = _params()
    dense, ids, _ = _batch(3)
    got = dlrm.predict(p, dense, ids, _ones(), DM, torch.bfloat16)
    _close(got, ref.DLRM(p, HELD)(dense, ids).detach(), rel=0.05)


def test_loss_and_every_gradient_match_the_reference():
    p = _params(1)
    dense, ids, labels = _batch(4)
    loss, grads, d_emb = dlrm.loss_and_grads(p, dense, ids, _ones(), labels, DM, torch.float32)
    r_loss, r_grads, r_rows = ref.loss_and_grads(ref.DLRM(p, HELD), dense, ids, labels)
    assert float(loss) == pytest.approx(r_loss, rel=1e-6)
    want = tree.flatten(r_grads)
    got = tree.flatten(grads)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])
    for f, (i, w, rows) in enumerate(zip(ids, _ones(), HELD)):
        c = pool.compact_rows(i, spare=rows)
        d_rows = pool.compact_grad(d_emb[:, f].contiguous(), i, w, c)
        u = int(c.count)
        r_idx, r_val = r_rows[f]
        assert torch.equal(c.rows[:u], r_idx)
        _close(d_rows[:u], r_val)


@pytest.mark.parametrize("b,k,n", [(32, 1, 7), (16, 100, 5), (64, 6, 500), (8, 3, 2**15 + 3)])
def test_compact_route_equals_the_dense_segment_route(b, k, n):
    """The compact rows' sums are the dense segment route's touched rows, bit
    for bit, the count is exact, and the layout is ``segment_layout`` of the
    compact ids (long runs of one id split into 32-slot chunks)."""
    g = torch.Generator().manual_seed(b * k + n)
    ids = torch.randint(0, n, (b, k), generator=g, dtype=torch.int32)
    ones = torch.ones((b, k))
    cot = torch.randn((b, D), generator=g)
    c = pool.compact_rows(ids, spare=n)
    got = pool.compact_grad(cot, ids, ones, c)
    assert got.shape == (b * k, D)
    table = torch.zeros((n + 1, D))
    dense = pool.gather_pool_bwd_segment_plain(table, ids, ones, n, cot,
                                               pool.segment_layout(ids, n))
    uniq = torch.unique(ids.long())
    u = int(c.count)
    assert u == uniq.numel()
    assert torch.equal(c.rows[:u], uniq) and bool((c.rows[u:] == n).all())
    assert torch.equal(got[:u], dense[uniq]) and bool((got[u:] == 0).all())
    compact_ids = torch.searchsorted(uniq, ids.long()).to(torch.int32)
    want = pool.segment_layout(compact_ids, b * k)
    cc, ss = int(c.layout.totals[0]), int(c.layout.totals[1])
    assert torch.equal(c.layout.totals, want.totals)
    for name in ("row_ptr", "slots"):
        assert torch.equal(getattr(c.layout, name), getattr(want, name)), name
    assert torch.equal(c.layout.chunks[:cc], want.chunks[:cc])
    assert torch.equal(c.layout.splits[:ss], want.splits[:ss])


def test_rowwise_adagrad_touches_only_its_rows():
    table = torch.randn((10, 4))
    acc = torch.rand(10)
    before, acc0 = table.clone(), acc.clone()
    rows = torch.tensor([2, 7, 9, 9, 9])        # three padding entries at the spare row 9
    g = torch.randn((5, 4))
    g[2:] = 0.0
    optim.rowwise_adagrad_update(table, acc, rows, g, 0.1)
    for r in (2, 7):
        a = acc0[r] + (g[[2, 7].index(r)] ** 2).mean()
        assert float(acc[r]) == pytest.approx(float(a), rel=1e-6)
        want = before[r] - 0.1 / (a.sqrt() + optim.ADAGRAD_EPS) * g[[2, 7].index(r)]
        torch.testing.assert_close(table[r], want)
    untouched = [r for r in range(10) if r not in (2, 7)]
    assert torch.equal(table[untouched], before[untouched])
    assert torch.equal(acc[untouched], acc0[untouched])


@pytest.mark.parametrize("seed", range(3))
def test_auc_equals_a_brute_force_pair_count(seed):
    g = torch.Generator().manual_seed(seed)
    n = 300
    scores = torch.round(torch.randn(n, generator=g) * 4) / 4        # many ties
    labels = (torch.rand(n, generator=g) < 0.3).float()
    pos, neg = scores[labels == 1], scores[labels == 0]
    wins = (pos[:, None] > neg[None, :]).double().sum() + 0.5 * (
        pos[:, None] == neg[None, :]).double().sum()
    want = float(wins / (pos.numel() * neg.numel()))
    assert float(metrics.auc(scores, labels)) == pytest.approx(want, abs=1e-15)


def test_auc_of_perfect_and_reversed_scores():
    labels = torch.tensor([0.0, 0.0, 1.0, 1.0])
    assert float(metrics.auc(torch.tensor([0.1, 0.2, 0.3, 0.4]), labels)) == 1.0
    assert float(metrics.auc(torch.tensor([0.4, 0.3, 0.2, 0.1]), labels)) == 0.0
    assert float(metrics.auc(torch.zeros(4), labels)) == 0.5


def test_criteo_reader_reads_the_written_arrays(data_dir):
    data = dataset.load(_cfg(data_dir), MetricsLogger(io.StringIO()))
    dense, sparse, labels = _samples(1, 5 * B + 7)
    assert np.array_equal(data.train.dense, dense) and np.array_equal(data.train.labels, labels)
    assert all(np.array_equal(a, b) for a, b in zip(data.train.sparse, sparse))
    assert data.val.size == 96 and data.test is None


def test_criteo_reader_refuses_ids_past_the_rows_held(tmp_path):
    d = str(tmp_path / "bad")
    dense, sparse, labels = _samples(1, 40)
    sparse[0][3, 1] = HELD[0]
    criteo.write_split(d, "train", dense, sparse, labels)
    criteo.write_split(d, "val", *_samples(2, 8))
    with pytest.raises(ValueError, match="rows held"):
        dataset.load(_cfg(d))


def test_make_trainer_picks_the_click_trainer(data_dir):
    cfg = _cfg(data_dir)
    tr = make_trainer(cfg, dataset.load(cfg), MetricsLogger(io.StringIO()), device="cpu")
    assert isinstance(tr, ClickTrainer)
    with pytest.raises(ValueError, match="criteo"):
        make_trainer(cfg.override({"model.arch": "hstu"}), None, device="cpu")


def _trainer(data_dir, **extra) -> ClickTrainer:
    cfg = _cfg(data_dir, **extra)
    return ClickTrainer(cfg, dataset.load(cfg), MetricsLogger(io.StringIO()), device="cpu")


def test_three_steps_of_both_adagrads_match_the_reference(data_dir, monkeypatch):
    """Three steps through ``train_steps``; every gradient the step makes for
    a table has the batch's B * K_f rows, never the table's."""
    tr = _trainer(data_dir)
    p0 = {k: v.clone() for k, v in tree.flatten(tr.params).items()}
    shapes = []
    real = pool.compact_grad

    def spy(g, ids, w, c):
        out = real(g, ids, w, c)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(pool, "compact_grad", spy)
    idx = torch.arange(3 * B).view(3, B)
    labels = tr.train_set.labels[idx]
    losses = tr.train_steps(idx, labels, LR)
    assert shapes == [(B * k, D) for k in BAGS] * 3
    s = tr.train_set
    batches = [(s.dense[i], [x[i] for x in s.sparse], s.labels[i]) for i in idx]
    want = ref.train_steps(tree.unflatten(p0), HELD, batches, LR)
    assert losses.tolist() == pytest.approx(want["losses"], rel=1e-6)
    got, exp = tree.flatten(tr.params), tree.flatten(want["params"])
    for k in exp:
        torch.testing.assert_close(got[k][:exp[k].shape[0]], exp[k], atol=1e-6, rtol=0)
    for t, a, w, rows in zip(tr.params["tables"], tr.opt_state.rows, want["row_acc"], HELD):
        torch.testing.assert_close(a[:rows], w, rtol=1e-5, atol=1e-12)
        assert t.shape[0] == rows + dlrm.SPARE_ROWS
        assert not a[rows:].any() and not t[rows:].any()      # the spare rows stay 0
    touched = [torch.unique(torch.cat([x[i].reshape(-1) for i in idx]).long()) for x in s.sparse]
    for t, rows, before in zip(tr.params["tables"], touched,
                               [p0[f"tables/{f}"] for f in range(len(BAGS))]):
        keep = torch.ones(t.shape[0], dtype=torch.bool)
        keep[rows] = False
        assert torch.equal(t[keep], before[keep])


def test_epoch_counts_lookups_and_distinct_rows(data_dir):
    tr = _trainer(data_dir)
    stats = tr.train_epoch(0)
    assert stats["steps"] == 5 and stats["samples"] == 5 * B
    assert stats["lookups"] == 5 * B * sum(BAGS)
    idx = tr.epoch_batches(0)[0]
    want = sum(int(torch.unique(x[i]).numel()) for i in idx for x in tr.train_set.sparse)
    assert stats["unique_rows"] == want


def test_validation_auc_is_the_metric_of_its_logits(data_dir):
    tr = _trainer(data_dir)
    val = tr.validate()
    logits = tr.split_logits("val")
    assert logits.shape == (96,)
    want = dlrm.predict(tr.params, torch.from_numpy(tr.data.val.dense),
                        [torch.from_numpy(x) for x in tr.data.val.sparse], _ones(96), DM,
                        torch.float32)
    torch.testing.assert_close(logits, want)
    labels = torch.from_numpy(tr.data.val.labels)
    assert val["auc"] == float(metrics.auc(want, labels))
    assert 0.0 <= val["auc"] <= 1.0 and val["logloss"] > 0


def test_engine_fits_checkpoints_and_resumes(data_dir):
    cfg = _cfg(data_dir)
    eng = api.Engine(cfg, logger=MetricsLogger(io.StringIO()), device="cpu")
    out = eng.fit()
    assert [set(h) >= {"loss", "val_auc", "lookups", "unique_rows"} for h in out["history"]] \
        == [True, True]
    path = os.path.join(cfg.paths.checkpoint_dir, "last_model")
    twin = api.Engine(cfg.override({"train.epochs": 3}), logger=MetricsLogger(io.StringIO()),
                      device="cpu")
    twin.load_checkpoint(path)
    for a, b in zip(tree.leaves(twin.trainer.params), tree.leaves(eng.trainer.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree.leaves(twin.trainer.opt_state), tree.leaves(eng.trainer.opt_state)):
        assert torch.equal(a, b)
    assert twin.trainer.epoch == 2
    assert len(twin.fit(resume_from=path)["history"]) == 1
    assert set(eng.evaluate()) == {"auc", "logloss"}


def test_cli_train_runs_the_click_model(data_dir, capsys):
    from movie_recommendation_engine_tpu_torch.cli.main import main

    args = ["train", "--device", "cpu"]
    for key, value in {"model.arch": "dlrm_dcnv2", "data.source": "criteo",
                       "data.data_dir": data_dir, "model.embed_dim": D,
                       "model.dlrm_dense_features": DENSE,
                       "model.dlrm_bag_sizes": list(BAGS),
                       "model.dlrm_table_rows": list(PUBLISHED),
                       "model.dlrm_rows_held": list(HELD), "model.dlrm_bottom": [24, D],
                       "model.dlrm_top": [32, 16, 1], "model.dlrm_cross_rank": 8,
                       "train.batch_size": B, "train.epochs": 1,
                       "paths.checkpoint_dir": os.path.join(data_dir, "cli_ckpt")}.items():
        args += ["--set", f"{key}={value}"]
    assert main(args) == 0
    assert os.path.exists(os.path.join(data_dir, "cli_ckpt", "last_model.npz"))
