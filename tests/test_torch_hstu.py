"""HSTU on the port's training path (``models/hstu.py``,
``train/seq_trainer.py``) against the plain reference
(``tests/hstu_reference.py``) on the CPU: seeded weights, d = 32, 2 blocks,
windows of 1-24 items with padding.

Tolerances, each with its reason:

- states and loss in float32, 2e-5 absolute on unit vectors and 1e-5
  relative on the loss: the same float32 math in another order of sums
  (einsum against matmul, the bias gradient summed exactly);
- gradients 1e-4 of the largest element of each leaf: float32 sums of
  up to B * L * L terms in different orders;
- params after 3 Adam steps 2e-6 absolute (lr 1e-3): the update divides
  each gradient by its own root mean square, so a gradient known to 1e-4 of
  its leaf moves its parameter by at most a few 1e-7;
- bfloat16 matmuls: 0.03 on unit-vector states, as bf16 rounds each
  operand to 2**-8 relative and the error grows through two blocks.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch import api, small_test_config
from movie_recommendation_engine_tpu_torch.core import tree
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
from movie_recommendation_engine_tpu_torch.evaluation import metrics
from movie_recommendation_engine_tpu_torch.graph.split import leave_two_out
from movie_recommendation_engine_tpu_torch.models import hstu
from movie_recommendation_engine_tpu_torch.train import optim
from movie_recommendation_engine_tpu_torch.train.seq_trainer import SeqTrainer
from movie_recommendation_engine_tpu_torch.train.trainer import Trainer
from tests import hstu_reference as ref

N_ITEMS, D, BLOCKS, HEADS, DQK, DV, MAX_LEN, BUCKETS = 50, 32, 2, 2, 8, 8, 24, hstu.TIME_BUCKETS
DM = hstu.Dims(D, BLOCKS, HEADS, DQK, DV, MAX_LEN, 0.2)
KW = dict(heads=HEADS, dqk=DQK, dv=DV, buckets=BUCKETS)
TAU = 0.05


def _params(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return ref.params_like(g, N_ITEMS, D, BLOCKS, HEADS, DQK, DV, MAX_LEN, BUCKETS)


def _windows(seed: int, b: int = 6, length: int = MAX_LEN):
    """``b`` windows of ``length + 1`` slots, real lengths 1..length + 1
    (with one empty window), timestamps growing by 1 s to ~40 days."""
    rng = np.random.default_rng(seed)
    n = np.concatenate([[0, 1, 2, length + 1], rng.integers(1, length + 2, b - 4)])
    ids = np.full((b, length + 1), -1, np.int32)
    ts = np.zeros((b, length + 1), np.int64)
    for r, k in enumerate(n):
        ids[r, :k] = rng.integers(0, N_ITEMS, k)
        t = 1_000_000 + np.cumsum(rng.integers(1, 3_500_000, max(k, 1)))
        ts[r, :max(k, 1)] = t[:max(k, 1)]
        ts[r, max(k, 1):] = t[max(k, 1) - 1]
    return torch.as_tensor(ids), torch.as_tensor(ts)


def _draws(seed: int, b: int, length: int, r: int = 7) -> hstu.Draws:
    g = torch.Generator().manual_seed(seed)
    return hstu.draw_step(g, b, length, r, N_ITEMS, DM, "cpu")


def test_states_match_reference_at_every_position():
    p = _params()
    ids, ts = _windows(1)
    got = hstu.encode(p, ids[:, :-1], ts, DM, dtype=torch.float32)
    want = ref.forward(p, ids[:, :-1], ts, **KW)
    real = (ids[:, :-1] >= 0)
    torch.testing.assert_close(got[real], want[real], atol=2e-5, rtol=0)


def test_states_in_bf16_stay_near_reference():
    p = _params(3)
    ids, ts = _windows(4)
    got = hstu.encode(p, ids[:, :-1], ts, DM, dtype=torch.bfloat16)
    want = ref.forward(p, ids[:, :-1], ts, **KW)
    real = ids[:, :-1] >= 0
    assert float((got - want)[real].abs().max()) < 0.03


def test_loss_gradients_and_three_adam_steps_match_reference():
    p = _params(5)
    batches, kw = [], dict(KW, temperature=TAU, rate_in=DM.dropout, rate_lin=hstu.LINEAR_DROPOUT)
    for s in range(3):
        ids, ts = _windows(10 + s)
        d = _draws(20 + s, ids.shape[0], MAX_LEN)
        batches.append((ids, ts, d))
    want_losses, want_params, want_grads = ref.train(
        p, [(i, t, d.negatives, d.keep_in, d.keep_lin) for i, t, d in batches], 1e-3, **kw)

    params = tree.map_tree(torch.clone, p)
    state = optim.adam_init(params)
    losses = []
    for s, (ids, ts, d) in enumerate(batches):
        flat = tree.flatten(params)
        leaves = [x.detach().requires_grad_() for x in flat.values()]
        loss = hstu.seq_loss(tree.unflatten(dict(zip(flat, leaves))), ids, ts, d, DM, TAU,
                             torch.float32)
        grads = dict(zip(flat, torch.autograd.grad(loss, leaves)))
        if s == 0:
            for k, g in grads.items():
                scale = float(want_grads[k].abs().max())
                assert float((g - want_grads[k]).abs().max()) <= 1e-4 * scale + 1e-12, k
        optim.adam_update(tree.unflatten(grads), state, params, 1e-3)
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for k, v in tree.flatten(params).items():
        torch.testing.assert_close(v, tree.flatten(want_params)[k], atol=2e-6, rtol=0,
                                   msg=k)


@pytest.mark.parametrize("t", [1, 7, 16])
def test_a_change_at_position_t_moves_no_earlier_output(t):
    p = _params(7)
    ids, ts = _windows(8, b=4)
    ids, ts = ids[3:4].clone(), ts[3:4].clone()        # the full window
    base = hstu.encode(p, ids[:, :-1], ts, DM, dtype=torch.float32)
    ids2, ts2 = ids.clone(), ts.clone()
    ids2[0, t] = (ids2[0, t] + 1) % N_ITEMS
    ts2[0, t + 1:] += 86_400 * 30
    moved = hstu.encode(p, ids2[:, :-1], ts2, DM, dtype=torch.float32)
    assert torch.equal(moved[0, :t], base[0, :t])
    assert not torch.equal(moved[0, t], base[0, t])


def test_time_buckets_against_hand_values():
    gaps = [0, 1, 2, 10, -10, 86_400, 10 ** 9, 2 ** 62]
    want = [0, 0, 2, 7, 7, 37, 68, 128]   # floor(ln(max(|g|, 1)) / 0.301), capped at 128
    ts = torch.tensor([[0, *gaps]], dtype=torch.int64)
    got = hstu.time_buckets(ts)[0, :, 0]    # key 0 (time 0) against each query time
    assert got.tolist() == want
    assert ref.bucket(torch.tensor(gaps), 128).tolist() == want


def test_relative_position_rows_match_the_published_toeplitz():
    w = torch.arange(2 * MAX_LEN - 1, dtype=torch.float32)
    for n in (2, 5, MAX_LEN):           # the published slicing needs n >= 2
        assert torch.equal(w[hstu.relative_positions(n, "cpu")], ref.toeplitz(w, n))


def test_bias_gradient_sums_exactly():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(9, generator=g, requires_grad=True)
    idx = torch.randint(0, 9, (5, 10, 10), generator=g)     # a batch of [L, L] buckets
    up = torch.randn(500, generator=g, dtype=torch.float64).float().reshape(5, 10, 10)
    hstu.bias_lookup(w, idx).backward(up)
    want = torch.zeros(9, dtype=torch.float64).index_add_(0, idx.reshape(-1),
                                                           up.double().reshape(-1))
    torch.testing.assert_close(w.grad.double(), want, atol=1e-6, rtol=0)


def test_leave_two_out_on_a_hand_made_history():
    u = np.array([0, 0, 0, 0, 1, 1, 2, 2, 2])
    m = np.array([5, 6, 7, 8, 1, 2, 3, 4, 9])
    t = np.array([4, 3, 2, 1, 1, 2, 5, 5, 6])
    h = leave_two_out(u, m, t, 3, 3)
    # user 0 in time order 8, 7, 6, 5; user 1 has two ratings (empty);
    # user 2: 3, 4 tie at t = 5 and keep their file order, then 9.
    assert h.train_ids.tolist() == [[8, 7, -1], [-1, -1, -1], [3, -1, -1]]
    assert h.val_ids.tolist() == [[8, 7, 6], [-1, -1, -1], [3, 4, -1]]
    assert h.test_ids.tolist() == [[7, 6, 5], [-1, -1, -1], [3, 4, 9]]
    assert h.train_ts.tolist() == [[1, 2, 2], [0, 0, 0], [5, 5, 5]]
    assert h.test_ts.tolist()[0] == [2, 3, 4]
    assert h.train_lengths.tolist() == [2, 0, 1] and h.test_lengths.tolist() == [3, 0, 3]


def test_query_ranks_and_rank_metrics():
    g = torch.Generator().manual_seed(1)
    items, queries = torch.randn(40, 8, generator=g), torch.randn(13, 8, generator=g)
    gt = torch.randint(0, 40, (13,), generator=g)
    got = metrics.query_ranks(items, queries, gt, chunk=4)
    sims = queries @ items.T
    want = 1 + (sims > (queries * items[gt]).sum(1)[:, None]).sum(1)
    assert torch.equal(got, want)
    out = metrics.rank_metrics(np.array([1, 3, 20]), k_values=(10,))
    assert out["hit_rate@10"] == pytest.approx(2 / 3)
    assert out["ndcg@10"] == pytest.approx((1 + 1 / np.log2(4)) / 3)
    assert out["mrr_standard"] == pytest.approx((1 + 1 / 3 + 1 / 20) / 3)


def _cfg(tmp_path, **over):
    return small_test_config().override({
        "model.arch": "hstu", "model.embed_dim": D, "model.num_layers": BLOCKS,
        "model.hstu_heads": HEADS, "model.hstu_dqk": DQK, "model.hstu_dv": DV,
        "model.hstu_max_len": MAX_LEN, "train.batch_size": 16,
        "train.num_negative_samples": 8, "train.nce_temperature": TAU,
        "data.use_data_subset": False, "paths.checkpoint_dir": str(tmp_path / "ck"), **over})


def test_engine_fits_hstu_and_resume_continues_as_one_run(tmp_path):
    cfg = _cfg(tmp_path, **{"train.epochs": 2})
    eng = api.Engine(cfg, logger=MetricsLogger(io.StringIO()), device="cpu")
    assert isinstance(eng.trainer, SeqTrainer) and not isinstance(eng.trainer, Trainer)
    out = eng.fit()
    assert len(out["history"]) == 2 and all(np.isfinite(h["loss"]) for h in out["history"])
    h = out["history"][0]
    assert h["positions"] > 0 and h["pad_slots"] > 0 and "val_ndcg@10" in h
    emb = eng.embeddings()
    assert emb.shape == (eng.data.num_movies, D)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
    assert set(eng.evaluate()) >= {"hit_rate@10", "ndcg@10", "mrr"}
    with pytest.raises(ValueError, match="no pairs"):
        eng.evaluate(np.zeros((3, 2), np.int64))

    # Without validation only last_model is written (each save reseeds the
    # generator), so a run resumed from it continues as one run.
    def run(epochs, ck, resume=None):
        c = _cfg(tmp_path, **{"train.epochs": epochs, "eval.eval_every": 0,
                              "paths.checkpoint_dir": str(tmp_path / ck)})
        e = api.Engine(c, logger=MetricsLogger(io.StringIO()), device="cpu")
        e.fit(resume_from=resume)
        return e

    whole = run(2, "whole")
    run(1, "half")
    resumed = run(2, "rest", resume=str(tmp_path / "half" / "last_model"))
    assert resumed.trainer.epoch == 2
    np.testing.assert_array_equal(resumed.embeddings(), whole.embeddings())


def test_cli_train_mode_trains_hstu(tmp_path, monkeypatch):
    from movie_recommendation_engine_tpu_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    sets = []
    for k, v in _cfg(tmp_path, **{"train.epochs": 1}).to_dict()["model"].items():
        if k.startswith("hstu") or k in ("arch", "embed_dim", "num_layers"):
            sets += ["--set", f"model.{k}={v}"]
    rc = main(["train", "--device", "cpu", "--set", "data.source=synthetic",
               "--set", "data.synthetic_num_movies=200", "--set", "data.synthetic_num_users=400",
               "--set", "data.synthetic_num_ratings=8000", "--set", "train.epochs=1",
               "--set", "train.batch_size=32", "--set", "train.num_negative_samples=8", *sets])
    assert rc == 0
    assert (tmp_path / "checkpoints" / "last_model.npz").exists()


def test_default_arch_builds_the_pinsage_trainer():
    eng = api.Engine(small_test_config(), logger=MetricsLogger(io.StringIO()), device="cpu")
    assert type(eng.trainer) is Trainer
    with pytest.raises(ValueError, match="model.arch"):
        api.Engine(small_test_config().override({"model.arch": "sasrec"}),
                   logger=MetricsLogger(io.StringIO()), device="cpu")


def test_epoch_counts_match_the_windows(tmp_path):
    """An epoch's ``positions``, ``real_slots``, ``pad_slots`` and
    ``attn_pairs`` are what its device windows hold."""
    eng = api.Engine(_cfg(tmp_path), logger=MetricsLogger(io.StringIO()), device="cpu")
    tr = eng.trainer
    ids, ts, block, counts = tr.epoch_batches(3)
    inputs, targets = ids[..., :MAX_LEN], ids[..., 1:]
    real = (inputs >= 0).sum(-1)
    assert counts["positions"] == int((targets >= 0).sum())
    assert counts["real_slots"] == int(real.sum())
    assert counts["slots"] == inputs.numel() == counts["real_slots"] + counts["pad_slots"]
    assert counts["attn_pairs"] == int((real * (real + 1) // 2).sum())
    users = set(tr.train_users.tolist())
    assert ids.shape[1] == 16 and block == min(8, ids.shape[0])
    assert int((inputs[..., 0] >= 0).sum()) == len(users)     # each user once an epoch
    assert torch.equal(ts[..., 1:] >= ts[..., :-1], torch.ones_like(ts[..., 1:], dtype=torch.bool))
