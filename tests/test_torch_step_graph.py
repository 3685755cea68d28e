"""The port's train step as the card replays it (``train/loop.py`` through
``core/graphs.GraphCache.run``), held to the JAX package on the CPU.

A captured step reads every number of the update from the device: Adam's
step count and ``lr`` are 0-d tensors, and ``curriculum_loss`` takes the
epoch as one, as JAX traces them into its jitted step. These tests hold
those forms to JAX's functions (Adam over 5 steps in f32 within 1e-7, the
curriculum loss within 1e-6), the trainer's steps to JAX's ``_run_steps``
given JAX's draws (the tolerances of ``test_torch_train.py``) with every
param and Adam storage kept in place, and the graph cache's rules through
the trainers' own ``train_steps`` on stand-in graphs: which events keep the
graphs (tables of the same shapes are copied into the captured storages; a
reseed resets the registered generator in place) and which drop them, that
a replay counts its launches, and, for PinSage and HSTU alike, that the
first step under a key runs eager and that the CPU and given draws run
eager. No capture runs here; ``test_torch_step_graph_cuda.py`` holds graphed
steps against eager ones on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu.core.checkpoint import _flatten
from movie_recommendation_engine_tpu.graph import dataset as j_dataset
from movie_recommendation_engine_tpu.models import losses as j_losses
from movie_recommendation_engine_tpu.models import pinsage as j_ps
from movie_recommendation_engine_tpu.train import optim as j_optim
from movie_recommendation_engine_tpu.train.trainer import Trainer as JTrainer
from movie_recommendation_engine_tpu_torch import small_test_config as t_small_config
from movie_recommendation_engine_tpu_torch.config import Config as TConfig
from movie_recommendation_engine_tpu_torch.core import graphs, tree
from movie_recommendation_engine_tpu_torch.core.checkpoint import params_from_jax
from movie_recommendation_engine_tpu_torch.graph import dataset as t_dataset
from movie_recommendation_engine_tpu_torch.models import losses as t_losses
from movie_recommendation_engine_tpu_torch.ops import pool as t_pool
from movie_recommendation_engine_tpu_torch.ops.pool import segment_layout
from movie_recommendation_engine_tpu_torch.train import optim as t_optim
from movie_recommendation_engine_tpu_torch.train.seq_trainer import SeqTrainer
from movie_recommendation_engine_tpu_torch.train.trainer import Trainer as TTrainer
from movie_recommendation_engine_tpu_torch.train.trainer import rung
from tests.test_torch_epoch_graph import _fake_capture as _fake_program_capture
from tests.test_torch_train import _jax_draws, _port_trainer_like, _rung, _t


def _storages(tt) -> list[int]:
    return [t.data_ptr() for t in tree.leaves(tt.params) + tree.leaves(tt.opt_state.mu)
            + tree.leaves(tt.opt_state.nu) + [tt.opt_state.step]]


# ---------------------------------------------------------------------------
# Adam with its step count on the device and a tensor lr
# ---------------------------------------------------------------------------

def test_adam_with_a_device_step_and_tensor_lr_matches_jax():
    rng = np.random.default_rng(3)
    jp = j_ps.init_params(jax.random.PRNGKey(1), 6, 8, 4, 2)
    tp = params_from_jax(_flatten(jp), "cpu")
    js, ts = j_optim.adam_init(jp), t_optim.adam_init(tp)
    step_count = ts.step
    assert step_count.dtype == torch.int32 and step_count.dim() == 0 and int(step_count) == 0
    lr_t = torch.zeros((), dtype=torch.float32)
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)), jp)
        lr = 1e-3 * 0.5 ** (step // 2)
        lr_t.fill_(lr)
        jp, js = j_optim.adam_update(grads, js, jp, jnp.float32(lr))
        out_p, out_s = t_optim.adam_update(params_from_jax(_flatten(grads), "cpu"), ts, tp,
                                           lr_t)
        assert out_p is tp and out_s is ts          # in place, the same objects
    assert ts.step is step_count and int(step_count) == int(js.step) == 5
    for got_tree, ref_tree in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        got = tree.flatten(got_tree)
        for k, v in _flatten(ref_tree).items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0, atol=1e-7,
                                       err_msg=k)


def test_adam_state_round_trip_loads_in_jax_trainer(tmp_path):
    """The port's device step count is written as JAX's int32 ``opt/step``:
    a port checkpoint taken after two graph-form steps loads in JAX's
    ``Trainer``, and JAX's loads back as a 0-d int32 tensor."""
    cfg = _rung("dense", "float32").override({"paths.checkpoint_dir": str(tmp_path)})
    tcfg = TConfig.from_dict(cfg.to_dict())
    tt = TTrainer(tcfg, t_dataset.load(tcfg), device="cpu")
    q_all, p_all, _, _, num_hard = tt.epoch_batches(0)
    tt.train_steps(q_all[:2], p_all[:2], 1e-3, 0.0, num_hard)
    path = str(tmp_path / "port")
    tt.save_checkpoint(path)
    jt = JTrainer(cfg, j_dataset.load(cfg))
    jt.load_checkpoint(path)
    assert int(jt.opt_state.step) == int(tt.opt_state.step) == 2
    for name in ("mu", "nu"):
        got = tree.flatten(getattr(tt.opt_state, name))
        for k, v in _flatten(getattr(jt.opt_state, name)).items():
            np.testing.assert_array_equal(np.asarray(v), got[k].numpy(), err_msg=k)
    jt.save_checkpoint(str(tmp_path / "jax"))
    back = TTrainer(tcfg, t_dataset.load(tcfg), device="cpu")
    back.load_checkpoint(str(tmp_path / "jax"))
    assert back.opt_state.step.dtype == torch.int32 and back.opt_state.step.dim() == 0
    assert int(back.opt_state.step) == 2


# ---------------------------------------------------------------------------
# curriculum_loss with a tensor epoch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epoch", [0.0, 1.5, 10.0, 12.5])
def test_curriculum_loss_with_a_tensor_epoch_matches_jax(epoch):
    rng = np.random.default_rng(7)

    def unit(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    q, p, r, h = unit(6, 8), unit(6, 8), unit(5, 8), unit(6, 3, 8)
    ref = j_losses.curriculum_loss(jnp.asarray(q), jnp.asarray(p), jnp.asarray(r),
                                   jnp.asarray(h), jnp.float32(epoch), margin=0.3,
                                   max_epochs=10, hard_negative_factor=2.0)
    got = t_losses.curriculum_loss(_t(q), _t(p), _t(r), _t(h),
                                   torch.tensor(epoch, dtype=torch.float32), margin=0.3,
                                   max_epochs=10, hard_negative_factor=2.0)
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(ref), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# train_steps against JAX's _run_steps, storages in place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rung", ["dense", "gather"])
def test_train_steps_match_jax_and_keep_their_storages(rung):
    """A block of 3 steps at epoch 1 (one hard negative, NCE, dropout 0.2,
    f32) from the same params, tables and JAX's draws: losses within 1e-5
    relative and params within 1e-5 of JAX's; every param, moment and the
    step count stays in its storage (what a captured step reads)."""
    cfg = _rung(rung, "float32")
    jt = JTrainer(cfg, j_dataset.load(cfg))
    jt.refresh_neighborhoods()
    tt = _port_trainer_like(jt, cfg)
    before = _storages(tt)
    batches = jt._epoch_pairs(np.random.default_rng(5))[:3]
    q_blk, p_blk = batches[:, :, 0].astype(np.int32), batches[:, :, 1].astype(np.int32)
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(jt, key, q_blk, 1)
    jt.params, jt.opt_state, j_out = jt._run_steps(
        jt.params, jt.opt_state, jt.x_table, tuple(t[0] for t in jt.nbr_tables),
        tuple(t[1] for t in jt.nbr_tables), jt.pool_mats, jt.graph, jnp.asarray(q_blk),
        jnp.asarray(p_blk), key, jnp.float32(1e-3), jnp.float32(1.0), num_hard=1)
    t_out = tt.train_steps(q_blk, p_blk, 1e-3, 1.0, 1, draws=draws)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5, atol=0)
    got = tree.flatten(tt.params)
    for k, v in _flatten(jt.params).items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=1e-5, rtol=0,
                                   err_msg=k)
    assert int(tt.opt_state.step) == int(jt.opt_state.step) == 3
    assert _storages(tt) == before
    assert float(tt._lr) == np.float32(1e-3) and float(tt._epoch) == 1.0


# ---------------------------------------------------------------------------
# The graph cache: what keeps and what drops the graphs, replays counted
# ---------------------------------------------------------------------------

class _FakeGraph:
    """Stands in for a captured ``torch.cuda.CUDAGraph``: counts replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _fake_capture(cache) -> None:
    """Replaces ``cache.capture`` with one that runs nothing and keeps a
    ``_FakeGraph`` whose static loss is 1.5 and whose replay counts
    (2, 2, 2, 1, 0) launches (no capture runs on the CPU)."""
    def capture(key, fn, inputs, generator=None):
        g = graphs.Captured(_FakeGraph(), tuple(x.clone() for x in inputs),
                            torch.tensor(1.5), (2, 2, 2, 1, 0))
        cache.graphs[key] = g
        return g
    cache.capture = capture


HSTU = {"model.arch": "hstu", "model.embed_dim": 32, "model.num_layers": 2,
        "model.hstu_heads": 2, "model.hstu_dqk": 8, "model.hstu_dv": 8,
        "model.hstu_max_len": 24, "train.batch_size": 16, "train.num_negative_samples": 8,
        "data.use_data_subset": False}


def _gather_trainer() -> TTrainer:
    cfg = t_small_config().override({"model.pool_impl": "gather",
                                     "model.gather_impl": "pallas"})
    tt = TTrainer(cfg, t_dataset.load(cfg), device="cpu")
    tt.refresh_neighborhoods()
    return tt


def _hstu_trainer() -> SeqTrainer:
    cfg = t_small_config().override(HSTU)
    return SeqTrainer(cfg, t_dataset.load(cfg), device="cpu")


TRAINERS = {"pinsage": _gather_trainer, "hstu": _hstu_trainer}


def _block(tr, rows: int) -> tuple:
    """The first ``rows`` steps of epoch 0: the two batch blocks and the
    rest of ``train_steps``'s arguments after ``lr``."""
    batches = tr.epoch_batches(0)
    args, _ = tr._epoch_steps(0, batches)
    return batches[0][:rows], batches[1][:rows], *args


def _draws(tr, a, args) -> object:
    return (tr.draw_step(a, args[1]) if isinstance(tr, TTrainer)
            else tr.draw_step(int(a.shape[0])))


def _with_fake_graph(tt) -> tuple:
    """The trainer graphed on stand-in graphs: a block of two steps, the
    first eager, the second captured and replayed. Returns the step's key,
    its graph and the block."""
    tt.graphed = True
    _fake_capture(tt.graphs)
    _fake_program_capture(tt.graphs.programs)
    blk = _block(tt, 2)
    tt.train_steps(blk[0], blk[1], 1e-3, *blk[2:])
    (key,) = tt.graphs.graphs
    return key, tt.graphs.graphs[key], blk


def _event(tt, event: str, tmp_path) -> None:
    if event == "refresh_neighborhoods":
        tt.refresh_neighborhoods()
    elif event == "set_tables_same_shapes":
        tt.set_neighborhood_tables([(nb.flip(0), w.flip(0)) for nb, w in tt.nbr_tables])
    elif event == "set_tables_new_shapes":
        tt.set_neighborhood_tables([(nb[:, :4], w[:, :4]) for nb, w in tt.nbr_tables])
    elif event == "load_checkpoint":
        tt.save_checkpoint(str(tmp_path / "ck"))
        tt.load_checkpoint(str(tmp_path / "ck"))
    elif event == "reseed":
        tt._reseed(np.array([5, 6], np.uint32))
    elif event == "params_assigned":
        tt.params = tree.map_tree(torch.clone, tt.params)
    elif event == "other_generator":
        tt.generator = torch.Generator().manual_seed(3)


@pytest.mark.parametrize("event, kept", [
    ("refresh_neighborhoods", True), ("set_tables_same_shapes", True),
    ("set_tables_new_shapes", False), ("load_checkpoint", False), ("reseed", True),
    ("params_assigned", False), ("other_generator", False)])
def test_graph_cache_keeps_or_drops_its_graphs(event, kept, tmp_path):
    tt = _gather_trainer()
    key, g, (q, p, *args) = _with_fake_graph(tt)
    _event(tt, event, tmp_path)
    # The next block checks what its graphs read before its first step: a
    # kept graph replays, a dropped one leaves the key to an eager step.
    tt.train_steps(q[:1], p[:1], 1e-3, *args)
    assert (tt.graphs.graphs.get(key) is g) == kept
    assert g.graph.replays == 1 + kept
    assert (key in tt.graphs.warm) and (key in tt.graphs.graphs) == kept


def test_new_tables_are_copied_into_the_captured_storages():
    tt = _gather_trainer()
    _with_fake_graph(tt)
    old = graphs.tensors((tt.nbr_tables, tt.pool_mats, tt.bwd_layouts))
    ptrs = [t.data_ptr() for t in old]
    new = [(nb.flip(0).clone(), w.flip(0).clone()) for nb, w in tt.nbr_tables]
    tt.set_neighborhood_tables(new)
    now = graphs.tensors((tt.nbr_tables, tt.pool_mats, tt.bwd_layouts))
    assert [t.data_ptr() for t in now] == ptrs
    for (nb, w), (got_nb, got_w) in zip(new, tt.nbr_tables):
        assert torch.equal(got_nb, nb) and torch.equal(got_w, w)
    limit = min(tt.valid_limit, tt.table_rows)
    ref = segment_layout(new[0][0], limit)
    assert all(torch.equal(a, b) for a, b in zip(graphs.tensors(tt.bwd_layouts[0]),
                                                 graphs.tensors(ref)))
    # The new tables' own storages are not kept: a caller's later edit of
    # them does not reach the trainer.
    new[0][0].zero_()
    assert not torch.equal(tt.nbr_tables[0][0], new[0][0])


def test_copy_into_needs_one_structure():
    a = {"x": torch.zeros(3), "y": [torch.ones(2, dtype=torch.int32)]}
    assert not graphs.copy_into(a, {"x": torch.ones(4), "y": [torch.zeros(2)]})
    assert not graphs.copy_into(a, {"x": torch.ones(3)})
    assert torch.equal(a["x"], torch.zeros(3))           # nothing copied
    assert graphs.copy_into(a, {"x": torch.ones(3), "y": [torch.zeros(2, dtype=torch.int32)]})
    assert torch.equal(a["x"], torch.ones(3)) and int(a["y"][0].sum()) == 0
    assert not graphs.copy_into(None, a)


def test_rung_names_each_layer():
    tt = _gather_trainer()
    assert rung(tt.pool_mats) == "gather"
    dense = TTrainer(t_small_config(), t_dataset.load(t_small_config()), device="cpu")
    dense.refresh_neighborhoods()
    assert rung(dense.pool_mats) == "dense,dense"


def test_a_replay_counts_the_launches_its_capture_recorded():
    tt = _gather_trainer()
    tt.graphed = True
    _fake_capture(tt.graphs)
    q, p, *args = _block(tt, 4)
    q, p = (x[torch.arange(4) % x.shape[0]] for x in (q, p))   # four steps
    tt.train_steps(q[:1], p[:1], 1e-3, *args)              # eager: warms the key
    counts0 = graphs.read_counts()
    losses = tt.train_steps(q[1:], p[1:], 1e-3, *args)     # captured, then replayed
    (g,) = tt.graphs.graphs.values()
    assert g.graph.replays == 3
    assert torch.equal(losses, torch.full((3,), 1.5))
    assert torch.equal(g.inputs[0], q[3]) and torch.equal(g.inputs[1], p[3])
    assert graphs.read_counts() == tuple(c + 3 * d for c, d in zip(counts0, g.counts))
    assert t_pool.LAUNCHES == counts0[0] + 6


@pytest.mark.parametrize("arch", sorted(TRAINERS))
def test_the_first_step_under_a_new_key_runs_eager(arch):
    tr, twin = TRAINERS[arch](), TRAINERS[arch]()
    tr.graphed = True
    _fake_capture(tr.graphs)
    a, b, *args = _block(tr, 1)
    out = tr.train_steps(a, b, 1e-3, *args)
    assert torch.equal(out, twin.train_steps(a, b, 1e-3, *args))   # the twin: eager on the CPU
    (key,) = tr.graphs.warm
    assert key[0] == {"pinsage": "step", "hstu": "seq_step"}[arch] and not tr.graphs.graphs


@pytest.mark.parametrize("arch", sorted(TRAINERS))
def test_steps_run_eager_by_rule_on_the_cpu_and_with_draws(arch):
    tr = TRAINERS[arch]()
    assert tr.graphed is False          # the CPU: eager by rule
    tr.graphed = True                   # draws given: eager all the same
    _fake_capture(tr.graphs)
    a, b, *args = _block(tr, 2)
    out = tr.train_steps(a, b, 1e-3, *args, draws=[_draws(tr, a[s], args) for s in range(2)])
    assert out.shape == (2,) and torch.isfinite(out).all()
    assert not tr.graphs.graphs and not tr.graphs.warm
