"""HSTU's step on the card (``train/seq_trainer.py``): graphed against eager,
bit for bit, and a repeat of the same run, bit for bit.

Needs no JAX, so it runs on the card machine (``-m cuda --noconftest``);
every test is marked ``cuda`` and skips without a card. A graphed trainer
and an eager twin (``graphed = False``) start from one seed, so from the
same params and generator; both train epochs 0 and 1 (the first step eager,
then the captured graph replayed) and must agree in params, Adam state,
losses and the generator's state, and encode the validation users alike.
"""

from __future__ import annotations

import io

import pytest
import torch

from movie_recommendation_engine_tpu_torch import small_test_config
from movie_recommendation_engine_tpu_torch.core import tree
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
from movie_recommendation_engine_tpu_torch.graph import dataset
from movie_recommendation_engine_tpu_torch.models import hstu
from movie_recommendation_engine_tpu_torch.train.seq_trainer import SeqTrainer

CFG = {"model.arch": "hstu", "model.embed_dim": 64, "model.num_layers": 2,
       "model.hstu_heads": 2, "model.hstu_dqk": 32, "model.hstu_dv": 32,
       "model.hstu_max_len": 48, "train.batch_size": 16, "train.num_negative_samples": 16,
       "train.nce_temperature": 0.05, "data.use_data_subset": False}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _state(t: SeqTrainer) -> dict:
    out = {f"params/{k}": v for k, v in tree.flatten(t.params).items()}
    for name in ("mu", "nu"):
        out.update({f"{name}/{k}": v for k, v in tree.flatten(getattr(t.opt_state, name)).items()})
    out["step"] = t.opt_state.step
    return out


def _trainers(device, graphed=(True, False)):
    cfg = small_test_config().override(CFG)
    data = dataset.load(cfg)
    out = []
    for g in graphed:
        t = SeqTrainer(cfg, data, logger=MetricsLogger(io.StringIO()), device=device)
        t.graphed = g
        out.append(t)
    return out


def _run(t: SeqTrainer) -> list:
    return [t.train_epoch(e)["loss"] for e in (0, 1)]


def _assert_same(a: SeqTrainer, b: SeqTrainer) -> None:
    sa, sb = _state(a), _state(b)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.cuda
def test_graphed_steps_equal_eager_steps_bitwise(cuda):
    graphed, eager = _trainers(cuda)
    assert _run(graphed) == _run(eager)
    assert [e["key"][0] for e in graphed.graphs.events] == ["seq_step"]
    _assert_same(graphed, eager)
    for _ in range(2):                 # eager, then captured, then replayed
        g_states, g_targets = graphed.user_states("val")
    e_states, e_targets = eager.user_states("val")
    assert torch.equal(g_states, e_states) and torch.equal(g_targets, e_targets)
    assert graphed.validate() == eager.validate()


@pytest.mark.cuda
def test_graphed_step_repeats_bitwise(cuda):
    a, b = _trainers(cuda, graphed=(True, True))
    assert _run(a) == _run(b)
    _assert_same(a, b)


@pytest.mark.cuda
def test_card_step_in_f32_matches_the_cpu(cuda):
    """One f32 step (TF32 off) on the card against the same step on the
    CPU: the same math in another order of sums, 1e-5 on the loss."""
    torch.backends.cuda.matmul.allow_tf32 = False
    (t,) = _trainers(cuda, graphed=(False,))
    dm = t.dims
    ids, ts = t.train_ids[:16], t.train_ts[:16]
    g = torch.Generator(device=cuda).manual_seed(3)
    d = hstu.draw_step(g, 16, t.length, 16, t.num_items, dm, cuda)
    card = hstu.seq_loss(t.params, ids, ts, d, dm, 0.05, torch.float32)
    cpu_params = tree.map_tree(lambda x: x.cpu(), t.params)
    d_cpu = hstu.Draws(d.negatives.cpu(), d.keep_in.cpu(), [k.cpu() for k in d.keep_lin])
    cpu = hstu.seq_loss(cpu_params, ids.cpu(), ts.cpu(), d_cpu, dm, 0.05, torch.float32)
    assert abs(float(card) - float(cpu)) <= 1e-5 * abs(float(cpu))
