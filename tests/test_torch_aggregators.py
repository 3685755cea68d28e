"""PyTorch port, the aggregator zoo, ``layers.py``, batch norm and the edge
forward against the JAX package.

Inputs are made with numpy from a seed; parameters are JAX's, carried over
by ``params_from_jax`` (or by their flattened key paths). Tolerances, each
with its reason:

- float32: 1e-5 absolute on outputs, and on gradients scaled by the largest
  gradient of the call (the two frameworks sum in other orders);
- bfloat16: 2e-2 absolute on outputs (values of order 1; bf16 keeps 8
  bits) and gradients within 0.1 of the largest: bf16 rounds at other places
  in the two (softmax, the [B, K, D] casts), as ``test_torch_model``'s
  bf16 tolerance allows;
- the edge forward: unit-norm embeddings within 2e-5 (f32) and 2e-2 (bf16),
  as ``test_torch_model``.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu import small_test_config
from movie_recommendation_engine_tpu.core.checkpoint import _flatten
from movie_recommendation_engine_tpu.graph import dataset as j_dataset
from movie_recommendation_engine_tpu.models import aggregators as j_agg
from movie_recommendation_engine_tpu.models import layers as j_layers
from movie_recommendation_engine_tpu.models import pinsage as j_ps
from movie_recommendation_engine_tpu.train.trainer import Trainer as JTrainer
from movie_recommendation_engine_tpu_torch.config import Config as TConfig
from movie_recommendation_engine_tpu_torch.core import tree
from movie_recommendation_engine_tpu_torch.core.checkpoint import params_from_jax
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
from movie_recommendation_engine_tpu_torch.graph import dataset as t_dataset
from movie_recommendation_engine_tpu_torch.models import aggregators as t_agg
from movie_recommendation_engine_tpu_torch.models import layers as t_layers
from movie_recommendation_engine_tpu_torch.models import pinsage as t_ps
from movie_recommendation_engine_tpu_torch.ops import pool as t_pool
from movie_recommendation_engine_tpu_torch.train.trainer import Trainer as TTrainer

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
N, D, B, K, LIMIT = 14, 8, 6, 5, 11


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _tree_to_torch(jtree):
    return tree.unflatten({k: _t(v) for k, v in _flatten(jtree).items()})


def _inputs(seed=0):
    """Table, ids (some >= LIMIT; row 1 all masked), weights (row 2 all
    zero: the mean fallback), self rows and an output cotangent."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((N, D)).astype(np.float32)
    nbrs = rng.integers(0, N, (B, K)).astype(np.int32)
    nbrs[1] = LIMIT + 1
    nbrs[3, 0] = nbrs[3, 1]          # a repeated id
    w = rng.random((B, K)).astype(np.float32)
    w[2] = 0.0
    self_feats = rng.standard_normal((B, D)).astype(np.float32)
    cot = rng.standard_normal((B, D)).astype(np.float32)
    return table, nbrs, w, self_feats, cot


def _close(got, ref, dtype, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), what
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=what)


def _grad_scale(ref_grads) -> float:
    """The largest reference gradient: a leaf whose true gradient is 0 (a
    bias that softmax cancels) holds only rounding noise, so each is held
    to the largest gradient of the call."""
    return max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(ref_grads))


def _close_grad(got, ref, dtype, what, scale):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), what
    tol = 1e-5 if dtype == "float32" else 0.1
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", t_agg.KINDS)
def test_aggregate_value_and_grads_match_jax(kind, dtype):
    jd, td = DTYPES[dtype]
    table, nbrs, w, self_feats, cot = _inputs(len(kind))
    jp = j_agg.init_aggregator_params(jax.random.PRNGKey(3), kind, D, D)

    def jfn(params, table, w, self_feats):
        out = j_agg.aggregate(kind, params, table, jnp.asarray(nbrs), w, self_feats=self_feats,
                              valid_limit=LIMIT, dtype=jd, gather_impl="xla")
        return out, jnp.sum(out.astype(jnp.float32) * cot)

    args = (jp, jnp.asarray(table), jnp.asarray(w), jnp.asarray(self_feats))
    ref_g, ref = jax.jit(jax.grad(lambda *a: jfn(*a)[::-1], argnums=(0, 1, 2, 3),
                                  has_aux=True))(*args)
    tp = None if jp is None else _tree_to_torch(jp)
    leaves = [] if tp is None else [x.requires_grad_() for x in tree.leaves(tp)]
    tt, tw, ts = (_t(x).requires_grad_() for x in (table, w, self_feats))
    got = t_agg.aggregate(kind, tp, tt, _t(nbrs), tw, self_feats=ts, valid_limit=LIMIT,
                          dtype=td)
    assert got.dtype == (td if kind in ("max", "importance") else torch.float32)
    _close(got.float().detach().numpy(), np.asarray(ref, np.float32), dtype, kind)
    assert (got[1] == 0).all()       # no valid neighbor: zero
    (got.float() * _t(cot)).sum().backward()
    scale = _grad_scale(ref_g)
    for name, x, rg in (("table", tt, ref_g[1]), ("weights", tw, ref_g[2]),
                        ("self", ts, ref_g[3])):
        g = torch.zeros_like(x) if x.grad is None else x.grad      # an input it does not read
        _close_grad(g.numpy(), np.asarray(rg), dtype, f"{kind} d_{name}", scale)
    if jp is not None:
        ref_leaves = _flatten(ref_g[0])
        for (key, _), leaf in zip(tree.flatten(tp).items(), leaves):
            _close_grad(leaf.grad.numpy(), ref_leaves[key], dtype, f"{kind} d_{key}", scale)


def test_attention_gradients_on_an_all_masked_row_are_finite_in_both():
    """The forward gives 0 on a row with no valid neighbor; its softmax is
    NaN in both packages, and neither lets the NaN into a gradient."""
    table, nbrs, w, self_feats, cot = _inputs(9)
    nbrs[:] = LIMIT + 1                      # every row masked
    jp = j_agg.init_aggregator_params(jax.random.PRNGKey(1), "attention", D, D)
    ref_g = jax.grad(lambda p, t: jnp.sum(j_agg.attention_aggregate(
        p, t, jnp.asarray(nbrs), jnp.asarray(self_feats), LIMIT, jnp.float32) * cot),
        argnums=(0, 1))(jp, jnp.asarray(table))
    tp = _tree_to_torch(jp)
    leaves = [x.requires_grad_() for x in tree.leaves(tp)]
    tt = _t(table).requires_grad_()
    out = t_agg.attention_aggregate(tp, tt, _t(nbrs), _t(self_feats), LIMIT, torch.float32)
    assert (out == 0).all()
    (out * _t(cot)).sum().backward()
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(ref_g))
    assert torch.isfinite(tt.grad).all() and (tt.grad == 0).all()
    assert all(torch.isfinite(x.grad).all() for x in leaves)


@pytest.mark.parametrize("kind", t_agg.KINDS)
def test_init_params_agg_leaves_carry_over(kind):
    jp = j_ps.init_params(jax.random.PRNGKey(0), 12, 16, 8, 2, aggregator=kind,
                          use_batch_norm=True)
    flat = _flatten(jp)
    tp = params_from_jax(flat, "cpu")
    assert sorted(tree.flatten(tp)) == sorted(flat)
    gen = torch.Generator().manual_seed(0)
    own = t_ps.init_params(gen, 12, 16, 8, 2, aggregator=kind, use_batch_norm=True)
    shapes = {k: tuple(v.shape) for k, v in tree.flatten(own).items()}
    assert shapes == {k: v.shape for k, v in flat.items()}
    assert ("agg" in own["convs"][0]) == (kind in ("attention", "max", "importance_transform"))


def _pooled_setup(kind, use_bn, seed=0):
    rng = np.random.default_rng(seed)
    m, f, hid, emb = 20, 12, 16, 8
    x = rng.standard_normal((m, f)).astype(np.float32)
    tables = []
    for _ in range(2):
        nb = rng.integers(0, m + 3, (m, 6)).astype(np.int32)
        tables.append((nb, rng.random((m, 6)).astype(np.float32)))
    jp = j_ps.init_params(jax.random.PRNGKey(seed), f, hid, emb, 2, aggregator=kind,
                          use_batch_norm=use_bn)
    return x, tables, jp, m


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind,use_bn", [(k, False) for k in t_agg.KINDS]
                         + [("importance", True), ("attention", True)])
def test_pooled_forward_batch_matches_jax(kind, use_bn, dtype):
    """The training forward (full-graph layer 0, batch layer) through each
    aggregator, with and without batch norm, and its parameter gradients."""
    jd, td = DTYPES[dtype]
    x, tables, jp, m = _pooled_setup(kind, use_bn)
    batch = np.array([0, 3, 3, 7, 19, 11], np.int32)

    def jfn(params):
        e = j_ps.pooled_forward_batch(params, jnp.asarray(x), [jnp.asarray(t[0]) for t in tables],
                                      [jnp.asarray(t[1]) for t in tables], jnp.asarray(batch),
                                      valid_limit=m, dtype=jd, aggregator=kind)
        return jnp.sum(e[:, 0] - e[:, 1]), e

    (_, ref), ref_g = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jp)
    tp = params_from_jax(_flatten(jp), "cpu")
    flat = tree.flatten(tp)
    leaves = [v.requires_grad_() for v in flat.values()]
    tp = tree.unflatten(dict(zip(flat, leaves)))
    got = t_ps.pooled_forward_batch(tp, _t(x), [_t(t[0]) for t in tables],
                                    [_t(t[1]) for t in tables], _t(batch), valid_limit=m,
                                    dtype=td, aggregator=kind)
    _close(got.detach().numpy(), np.asarray(ref), dtype, kind)
    (got[:, 0] - got[:, 1]).sum().backward()
    scale = _grad_scale(ref_g)
    for (key, r), leaf in zip(_flatten(ref_g).items(), leaves):
        g = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        _close_grad(g.numpy(), r, dtype, f"{kind} d_{key}", scale)


@pytest.mark.parametrize("kind", ["mean", "attention", "max", "importance_transform"])
def test_pooled_forward_full_graph_matches_jax(kind):
    x, tables, jp, m = _pooled_setup(kind, False, seed=2)
    ref = j_ps.pooled_forward(jp, jnp.asarray(x), [jnp.asarray(t[0]) for t in tables],
                              [jnp.asarray(t[1]) for t in tables], valid_limit=m,
                              dtype=jnp.float32, aggregator=kind)
    got = t_ps.pooled_forward(params_from_jax(_flatten(jp), "cpu"), _t(x),
                              [_t(t[0]) for t in tables], [_t(t[1]) for t in tables],
                              valid_limit=m, dtype=torch.float32, aggregator=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def _small(tmp_path, **over):
    cfg = small_test_config().override({"paths.checkpoint_dir": str(tmp_path / "ck"),
                                        "train.epochs": 1, **over})
    return cfg, TConfig.from_dict(cfg.to_dict())


@pytest.mark.parametrize("kind", [k for k in t_agg.KINDS if k != "importance"])
def test_every_aggregator_trains_and_its_checkpoint_round_trips(tmp_path, kind):
    """``fit`` on the CPU takes the gather layers for every kind (no pool
    operators, as JAX), and the checkpoint, ``agg`` leaves included, loads in
    JAX's trainer and back in the port's."""
    jcfg, tcfg = _small(tmp_path, **{"model.aggregator_type": kind})
    tt = TTrainer(tcfg, t_dataset.load(tcfg), MetricsLogger(stream=io.StringIO()),
                  device="cpu")
    out = tt.fit()
    assert tt.pool_mats == () and np.isfinite(out["history"][0]["loss"])
    path = str(tmp_path / "ck" / "last_model")
    jt = JTrainer(jcfg, j_dataset.load(jcfg))
    jt.load_checkpoint(path)
    mine = tree.flatten(tt.params)
    theirs = _flatten(jt.params)
    assert sorted(mine) == sorted(theirs) and any("/agg/" in k for k in mine) == (
        kind in ("attention", "max", "importance_transform"))
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(v))
    jt.save_checkpoint(str(tmp_path / "from_jax"))
    again = TTrainer(tcfg, tt.data, MetricsLogger(stream=io.StringIO()), device="cpu")
    again.load_checkpoint(str(tmp_path / "from_jax"))
    for k, v in tree.flatten(again.params).items():
        assert torch.equal(v, mine[k]), k


def test_batch_norm_trains_on_the_dense_rung(tmp_path):
    _, tcfg = _small(tmp_path, **{"model.use_batch_norm": True})
    tt = TTrainer(tcfg, t_dataset.load(tcfg), MetricsLogger(stream=io.StringIO()),
                  device="cpu")
    out = tt.fit()
    assert "bn" in tt.params["convs"][0] and np.isfinite(out["history"][0]["loss"])
    assert len(tt.pool_mats) == 2                   # dense matrices, as JAX picks
    assert not torch.equal(tt.params["convs"][0]["bn"]["scale"], torch.ones(64))


# ---------------------------------------------------------------------------
# layers.py
# ---------------------------------------------------------------------------

def test_xavier_uniform_and_graph_conv_init():
    gen = torch.Generator().manual_seed(0)
    w = t_layers.xavier_uniform(gen, 40, 60)
    bound = (6 / 100) ** 0.5
    assert w.shape == (40, 60) and float(w.abs().max()) <= bound
    assert abs(float(w.std()) - bound / 3 ** 0.5) < 0.02       # U(-b, b) has std b / sqrt 3
    mine = tree.flatten(t_layers.init_graph_conv_layer(gen, 12, 8))
    ref = _flatten(j_layers.init_graph_conv_layer(jax.random.PRNGKey(0), 12, 8))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in ref.items()}


@pytest.mark.parametrize("rows", [1, 7])
def test_batch_norm_and_graph_conv_layer_match_jax(rows):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 12)).astype(np.float32)
    nx = rng.standard_normal((rows, 12)).astype(np.float32)
    jp = j_layers.init_graph_conv_layer(jax.random.PRNGKey(1), 12, 8)
    jp["bn"]["scale"] = jnp.asarray(rng.random(8).astype(np.float32) + 0.5)
    jp["bn"]["bias"] = jnp.asarray(rng.standard_normal(8).astype(np.float32))
    tp = _tree_to_torch(jp)
    ref = j_layers.graph_conv_layer(jp, jnp.asarray(x), jnp.asarray(nx))
    got = t_layers.graph_conv_layer(tp, _t(x), _t(nx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    y = rng.standard_normal((rows, 8)).astype(np.float32)
    bn_ref = j_layers.batch_norm(jnp.asarray(y), jp["bn"]["scale"], jp["bn"]["bias"])
    bn = t_layers.batch_norm(_t(y), tp["bn"]["scale"], tp["bn"]["bias"])
    np.testing.assert_allclose(bn.numpy(), np.asarray(bn_ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("layer", ["importance", "weighted", "weighted_none", "max"])
def test_pooling_layers_match_jax(layer):
    table, nbrs, w, _, _ = _inputs(4)
    jt_, jn, jw = jnp.asarray(table), jnp.asarray(nbrs), jnp.asarray(w)
    tt_, tn, tw = _t(table), _t(nbrs), _t(w)
    if layer == "importance":
        ref = j_layers.importance_pooling_layer(jt_, jn, jw, LIMIT)
        got = t_layers.importance_pooling_layer(tt_, tn, tw, LIMIT)
    elif layer == "max":
        ref = j_layers.max_pooling_layer(jt_, jn, LIMIT)
        got = t_layers.max_pooling_layer(tt_, tn, LIMIT)
    else:
        weights = (jw, tw) if layer == "weighted" else (None, None)
        ref = j_layers.weighted_mean_pooling_layer(jt_, jn, weights[0], LIMIT)
        got = t_layers.weighted_mean_pooling_layer(tt_, tn, weights[1], LIMIT)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# edge_forward / forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def edge_setup():
    rng = np.random.default_rng(7)
    n, e, f = 30, 160, 12
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n - 4, e).astype(np.int32)     # the last 4 nodes get no message
    w = (rng.random(e) * 4).astype(np.float32)
    x = rng.standard_normal((n, f)).astype(np.float32)
    jp = j_ps.init_params(jax.random.PRNGKey(5), f, 16, 8, 2)
    return x, src, dst, w, jp


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("weighted", [True, False])
def test_edge_forward_matches_jax(edge_setup, weighted, dtype):
    jd, td = DTYPES[dtype]
    x, src, dst, w, jp = edge_setup
    ref = j_ps.edge_forward(jp, jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(w) if weighted else None, dtype=jd)
    tp = params_from_jax(_flatten(jp), "cpu")
    got = t_ps.edge_forward(tp, _t(x), _t(src), _t(dst), _t(w) if weighted else None,
                            dtype=td)
    _close(got.numpy(), np.asarray(ref), dtype, "edge_forward")
    again = t_ps.edge_forward(tp, _t(x), _t(src), _t(dst), _t(w) if weighted else None,
                              dtype=td)
    assert torch.equal(got, again)


def test_slice_sum_matches_its_plain_version(edge_setup):
    x, src, dst, w, _ = edge_setup
    es = t_pool.edge_slices(_t(src), _t(dst), _t(w), x.shape[0], width=4)
    assert (es.slices >= 1).all() and es.nbrs.shape[1] == 4
    got = t_pool.slice_sum(_t(x), es)
    ref = t_pool.slice_sum_plain(_t(x), _t(src), _t(dst), _t(w), x.shape[0])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    assert (got[-4:] == 0).all()


def test_forward_dispatches_as_jax(edge_setup):
    x, src, dst, w, jp = edge_setup
    tp = params_from_jax(_flatten(jp), "cpu")
    rng = np.random.default_rng(1)
    nbrs = [rng.integers(0, 30, (30, 5)).astype(np.int32) for _ in range(2)]
    wts = [rng.random((30, 5)).astype(np.float32) for _ in range(2)]
    cases = {
        "mlp": ({}, {}),
        "pooled": ({"sampled_neighbors": [jnp.asarray(a) for a in nbrs],
                    "importance_weights": [jnp.asarray(a) for a in wts],
                    "edge_weight": jnp.asarray(w)},
                   {"sampled_neighbors": [_t(a) for a in nbrs],
                    "importance_weights": [_t(a) for a in wts], "edge_weight": _t(w)}),
        "edge": ({"edge_index": (jnp.asarray(src), jnp.asarray(dst)),
                  "edge_weight": jnp.asarray(w)},
                 {"edge_index": (_t(src), _t(dst)), "edge_weight": _t(w)}),
    }
    for name, (jkw, tkw) in cases.items():
        ref = j_ps.forward(jp, jnp.asarray(x), dtype=jnp.float32, **jkw)
        got = t_ps.forward(tp, _t(x), dtype=torch.float32, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0,
                                   err_msg=name)
