"""PyTorch port, the at-scale pooling rungs against the JAX package:
``ops/hub_pool.py``, ``ops/block_sparse.py``, their dispatch in
``models/pinsage.py`` and the rung choice in ``train/trainer.py``.

Inputs are made with numpy from a seed at small sizes; JAX runs on the CPU,
its ``gather_impl="pallas"`` residual through ``gather_pool_ad`` in
interpret mode. Tolerances, each with its reason:

- builder stats (``dropped_mass``, ``head_mass``) 1e-5 and pooled outputs
  2e-5 in f32: sums in another order;
- operators fed JAX's own operators (so that ties cannot differ): f32 2e-5,
  bf16 within one bf16 step (both round one f32 sum once), gradients 2e-4
  (f32, relative to the largest);
- float8 and bf16 slabs: bitwise where a row's ids are distinct (each cell
  is rounded once from f32 in both packages); where a row repeats an id,
  JAX rounds each entry before adding, the port rounds the f32 sum once, so
  a repeated cell may lie one step away;
- ``mass_permutation`` and the block builder's index math: exact (the same
  numpy code);
- ``train_steps`` on the ``hubf`` rung against JAX's ``_run_steps``, f32:
  losses 1e-5 relative, params 1e-5 absolute (as ``test_torch_train``).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu import small_test_config
from movie_recommendation_engine_tpu.core.checkpoint import _flatten
from movie_recommendation_engine_tpu.core.logging import MetricsLogger as JLogger
from movie_recommendation_engine_tpu.graph import dataset as j_dataset
from movie_recommendation_engine_tpu.models import pinsage as j_ps
from movie_recommendation_engine_tpu.ops import block_sparse as j_bsp
from movie_recommendation_engine_tpu.ops import hub_pool as j_hub
from movie_recommendation_engine_tpu.train.trainer import Trainer as JTrainer
from movie_recommendation_engine_tpu_torch.config import Config as TConfig
from movie_recommendation_engine_tpu_torch.core import tree
from movie_recommendation_engine_tpu_torch.core.checkpoint import params_from_jax
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger as TLogger
from movie_recommendation_engine_tpu_torch.graph import dataset as t_dataset
from movie_recommendation_engine_tpu_torch.models import pinsage as t_ps
from movie_recommendation_engine_tpu_torch.ops import block_sparse as t_bsp
from movie_recommendation_engine_tpu_torch.ops import hub_pool as t_hub
from movie_recommendation_engine_tpu_torch.ops import pool as t_pool
from movie_recommendation_engine_tpu_torch.train import optim as t_optim
from movie_recommendation_engine_tpu_torch.train.trainer import Trainer as TTrainer

from tests.test_torch_train import _jax_draws

_T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float8_e4m3fn": torch.float8_e4m3fn}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _to_torch(x) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype (bf16 and f8 through
    f32, which holds their values exactly)."""
    name = jnp.dtype(x.dtype).name
    if name in _T_DTYPES and name != "float32":
        return _t(np.asarray(x.astype(jnp.float32))).to(_T_DTYPES[name])
    return _t(x)


def _port_hub(jhp) -> t_hub.HubPool:
    return t_hub.HubPool(_to_torch(jhp.a_head), _t(jhp.head_ids).long(),
                         _t(jhp.res_nbrs), _t(jhp.res_w))


def _port_block(jbp) -> t_bsp.BlockPool:
    return t_bsp.BlockPool(_to_torch(jbp.a_blocks), _t(jbp.col_idx).long(),
                           _t(jbp.perm).long(), _t(jbp.inv).long())


def _tables(n=300, k=7, d=16, seed=0, distinct=False):
    """Ids in [0, n + 5) (some past the limit), random weights and features;
    ``distinct`` draws each row's ids without repeats, as walk tables are."""
    rng = np.random.default_rng(seed)
    if distinct:
        nbrs = np.stack([rng.choice(n + 5, size=k, replace=False) for _ in range(n)])
    else:
        nbrs = rng.integers(0, n + 5, (n, k))
    w = rng.random((n, k)).astype(np.float32)
    h = rng.standard_normal((n, d)).astype(np.float32)
    return nbrs.astype(np.int32), w, h


def _within_bf16_step(got: torch.Tensor, ref: np.ndarray) -> None:
    ref32 = torch.from_numpy(np.array(ref, np.float32))
    step = torch.ldexp(torch.ones_like(ref32), torch.frexp(ref32).exponent - 8)
    err = (got.float() - ref32).abs()
    assert bool((err <= step).all()), float((err - step).max())


# ---------------------------------------------------------------------------
# Sizing: auto_head, resolve_pool_matrix_dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 16_000, 59_392, 131_072, 262_144])
@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn"])
def test_auto_head_matches_jax(n, dtype):
    assert t_hub.auto_head(n, _T_DTYPES[dtype]) == j_hub.auto_head(n, getattr(jnp, dtype))


@pytest.mark.parametrize("choice,n,rung,head_cfg", [
    ("auto", 59_392, "hub", 0), ("auto", 131_072, "hub", 0), ("auto", 262_144, "hub", 0),
    ("auto", 262_144, "hub", 16384), ("auto", 262_144, "dense", 0),
    ("auto", 262_144, "block", 0), ("bfloat16", 262_144, "hub", 0),
    ("float8_e4m3fn", 59_392, "hub", 0)])
def test_resolve_pool_matrix_dtype_matches_jax(choice, n, rung, head_cfg):
    got = t_hub.resolve_pool_matrix_dtype(choice, n, rung, head_cfg=head_cfg)
    ref = j_hub.resolve_pool_matrix_dtype(choice, n, rung, head_cfg=head_cfg)
    assert got == _T_DTYPES[jnp.dtype(ref).name]


def test_resolve_pool_matrix_dtype_rejects_unknown():
    with pytest.raises(KeyError):
        t_hub.resolve_pool_matrix_dtype("float16", 1000, "hub")


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head,res,limit", [(64, 3, 400), (0, 8, 400), (400, 9, 400),
                                            (32, 4, 300), (1, 9, 400)])
@pytest.mark.parametrize("where", ["host", "device"])
def test_hub_builders_match_jax(where, head, res, limit):
    """Each builder against JAX's of the same kind: stats 1e-5, the pooled
    output of the port's operator against JAX's operator's 2e-5 (f32)."""
    n, k, d = 400, 9, 12
    nbrs, w, h = _tables(n=n, k=k, d=d, seed=7)
    if where == "host":
        got, st = t_hub.build_hub_pool(nbrs, w, valid_limit=limit, head=head, residual=res,
                                       dtype=torch.float32)
        jhp, jst = j_hub.build_hub_pool(nbrs, w, valid_limit=limit, head=head, residual=res,
                                        dtype=jnp.float32)
    else:
        got, st = t_hub.build_hub_pool_device(_t(nbrs), _t(w), valid_limit=limit, head=head,
                                              residual=res, dtype=torch.float32)
        jhp, jst = j_hub.build_hub_pool_device(jnp.asarray(nbrs), jnp.asarray(w),
                                               valid_limit=limit, head=head, residual=res,
                                               dtype=jnp.float32)
    assert st["head_cols"] == jst["head_cols"]
    assert st["residual_per_row"] == jst["residual_per_row"]
    assert st["a_bytes_built"] == jst["a_bytes_built"]
    for key in ("dropped_mass", "head_mass"):
        assert st[key] == pytest.approx(jst[key], abs=1e-5), key
    assert got.a_head.dtype == torch.float32 and got.res_nbrs.dtype == torch.int32
    out = t_hub.hub_pool_matmul(got, _t(h), dtype=torch.float32)
    ref = j_hub.hub_pool_matmul(jhp, jnp.asarray(h), dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_hub_builders_break_ties_toward_the_lower_id():
    """Visit-count weights tie often: both builders pick the head and each
    row's residual with the lower id first, as JAX's stable argsort and
    ``lax.top_k`` do, so the operators are equal to JAX's exactly."""
    n, k = 200, 8
    rng = np.random.default_rng(3)
    nbrs = np.stack([rng.choice(n, size=k, replace=False) for _ in range(n)]).astype(np.int32)
    w = rng.integers(1, 4, (n, k)).astype(np.float32)         # many ties
    for build, jbuild, arr in ((t_hub.build_hub_pool, j_hub.build_hub_pool, np.asarray),
                               (t_hub.build_hub_pool_device, j_hub.build_hub_pool_device,
                                jnp.asarray)):
        got, _ = build(_t(nbrs), _t(w), valid_limit=n, head=24, residual=3,
                       dtype=torch.float32)
        ref, _ = jbuild(arr(nbrs), arr(w), valid_limit=n, head=24, residual=3,
                        dtype=jnp.float32)
        assert torch.equal(got.head_ids, _t(ref.head_ids).long())
        assert torch.equal(got.res_nbrs, _t(ref.res_nbrs))
        np.testing.assert_allclose(got.res_w.numpy(), np.asarray(ref.res_w), atol=1e-7)
        np.testing.assert_allclose(got.a_head.numpy(), np.asarray(ref.a_head), atol=1e-7)


def test_hub_device_build_zero_residual_delegates():
    nbrs, w, _ = _tables(n=120, k=5, seed=9)
    hp, st = t_hub.build_hub_pool_device(_t(nbrs), _t(w), valid_limit=120, head=32,
                                         residual=0, dtype=torch.float32)
    assert float(hp.res_w.sum()) == 0.0 and st["head_cols"] == 32


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("where", ["host", "device"])
def test_hub_slab_bitwise_equal_to_jax_with_distinct_ids(where, dtype):
    """With distinct ids a row, every slab cell is written once and rounded
    once from f32 in both packages: the slabs are equal bit for bit."""
    n, k = 96, 8
    nbrs, w, _ = _tables(n=n, k=k, seed=7, distinct=True)
    td, jd = _T_DTYPES[dtype], getattr(jnp, dtype)
    if where == "host":
        got, _ = t_hub.build_hub_pool(nbrs, w, valid_limit=n, head=16, residual=4, dtype=td)
        ref, _ = j_hub.build_hub_pool(nbrs, w, valid_limit=n, head=16, residual=4, dtype=jd)
    else:
        got, _ = t_hub.build_hub_pool_device(_t(nbrs), _t(w), valid_limit=n, head=16,
                                             residual=4, dtype=td)
        ref, _ = j_hub.build_hub_pool_device(jnp.asarray(nbrs), jnp.asarray(w), valid_limit=n,
                                             head=16, residual=4, dtype=jd)
    assert got.a_head.dtype == td
    bits = torch.uint8 if td.itemsize == 1 else torch.int16
    assert torch.equal(got.a_head.view(bits), _to_torch(ref.a_head).view(bits))


def test_hub_slab_with_repeated_ids_rounds_each_cell_once():
    """Where a row repeats an id, the port sums the cell's entries in f32
    and rounds once (equal to the f32 slab cast once); JAX rounds each entry
    to float8 and adds, so a repeated cell may be one float8 step away."""
    n, k = 96, 8
    nbrs, w, _ = _tables(n=n, k=k, seed=4)
    nbrs[:, 1] = nbrs[:, 0]                                   # every row repeats an id
    got, _ = t_hub.build_hub_pool_device(_t(nbrs), _t(w), valid_limit=n, head=16, residual=4,
                                         dtype=torch.float8_e4m3fn)
    f32, _ = t_hub.build_hub_pool_device(_t(nbrs), _t(w), valid_limit=n, head=16, residual=4,
                                         dtype=torch.float32)
    assert torch.equal(got.a_head.view(torch.uint8),
                       f32.a_head.to(torch.float8_e4m3fn).view(torch.uint8))
    ref, _ = j_hub.build_hub_pool_device(jnp.asarray(nbrs), jnp.asarray(w), valid_limit=n,
                                         head=16, residual=4, dtype=jnp.float8_e4m3fn)
    a, b = got.a_head.float(), _to_torch(ref.a_head).float()
    step = torch.ldexp(torch.ones_like(b), torch.frexp(b).exponent - 4)   # e4m3: 3 bits
    assert bool(((a - b).abs() <= step).all())


def test_scatter_cells_sums_repeats_once_per_cell():
    rows, cols = torch.tensor([0, 2, 0, 1, 0]), torch.tensor([1, 0, 1, 2, 1])
    vals = torch.tensor([0.1, 0.2, 0.3, 0.4, 0.5])
    got = t_hub.scatter_cells((3, 3), rows, cols, vals, torch.bfloat16)
    ref = torch.zeros(3, 3)
    ref[0, 1], ref[2, 0], ref[1, 2] = 0.1 + 0.3 + 0.5, 0.2, 0.4
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref.bfloat16())


def test_mass_permutation_equals_jax():
    for seed in range(3):
        nbrs, w, _ = _tables(n=257, k=11, seed=seed)
        got = t_bsp.mass_permutation(nbrs, w, valid_limit=250)
        ref = j_bsp.mass_permutation(nbrs, w, valid_limit=250)
        assert got.dtype == np.int32 and np.array_equal(got, ref)


@pytest.mark.parametrize("block_size,max_blocks,limit", [(64, 10_000, 300), (32, 2, 300),
                                                         (16, 3, 250)])
def test_block_builder_matches_jax(block_size, max_blocks, limit):
    """The same index math and one rounding a cell: stats equal, slab and
    indices equal (f32 and bf16, distinct ids)."""
    n = 300
    nbrs, w, _ = _tables(n=n, k=7, seed=2, distinct=True)
    perm = np.random.default_rng(1).permutation(n).astype(np.int32)
    for td, jd in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got, st = t_bsp.build_block_pool(nbrs, w, perm, valid_limit=limit,
                                         block_size=block_size, max_blocks=max_blocks, dtype=td)
        ref, jst = j_bsp.build_block_pool(nbrs, w, perm, valid_limit=limit,
                                          block_size=block_size, max_blocks=max_blocks, dtype=jd)
        assert st == pytest.approx(jst)
        assert torch.equal(got.a_blocks, _to_torch(ref.a_blocks))
        for a, b in zip(got[1:], ref[1:]):
            assert torch.equal(a, _t(b).long())


def test_cluster_permutation_is_not_ported():
    """The feature order no longer raises (its parity with JAX is in
    ``test_torch_ivf``): all-equal rows give a permutation, in row order."""
    perm = t_bsp.cluster_permutation(np.zeros((8, 4), np.float32))
    assert perm.dtype == np.int32 and perm.tolist() == list(range(8))


# ---------------------------------------------------------------------------
# Operators fed JAX's own operators: values and gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hub_ops():
    n, k, d = 160, 9, 16
    nbrs, w, h = _tables(n=n, k=k, d=d, seed=5)
    ops = {}
    for dtype in ("float32", "bfloat16", "float8_e4m3fn"):
        jhp, _ = j_hub.build_hub_pool(nbrs, w, valid_limit=n - 10, head=32, residual=3,
                                      dtype=getattr(jnp, dtype))
        ops[dtype] = (jhp, _port_hub(jhp))
    batch = np.array([0, 3, 7, n - 1, 128, 3, n + 4], np.int32)   # repeat, clamped
    return h, batch, ops


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("slab,compute", [("float32", "float32"), ("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16"),
                                          ("float8_e4m3fn", "bfloat16"),
                                          ("float8_e4m3fn", "float32")])
def test_hub_pool_matmul_matches_jax(hub_ops, impl, slab, compute, monkeypatch):
    """Full and batch forms; row chunks of the slab product forced small,
    so the chunked conversion is what runs."""
    h, batch, ops = hub_ops
    jhp, thp = ops[slab]
    monkeypatch.setattr(t_hub, "_CHUNK_BYTES", 4 * 32 * 4)
    td, jd = _T_DTYPES[compute], getattr(jnp, compute)
    hj = jnp.asarray(h).astype(jd)
    full = t_hub.hub_pool_matmul(thp, _t(h).to(td), dtype=td, gather_impl=impl)
    rows = t_hub.hub_pool_matmul_batch(thp, _t(h).to(td), _t(batch), dtype=td,
                                       gather_impl=impl)
    ref_full = j_hub.hub_pool_matmul(jhp, hj, dtype=jd, gather_impl=impl)
    ref_rows = j_hub.hub_pool_matmul_batch(jhp, hj, jnp.asarray(batch), dtype=jd,
                                           gather_impl=impl)
    assert full.dtype == rows.dtype == td and rows.shape == (batch.size, h.shape[1])
    for got, ref in ((full, ref_full), (rows, ref_rows)):
        ref = np.asarray(ref.astype(jnp.float32))
        if compute == "float32":
            np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
        else:
            _within_bf16_step(got, ref)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("slab", ["float32", "bfloat16", "float8_e4m3fn"])
def test_hub_pool_gradients_match_jax(hub_ops, impl, slab):
    h, batch, ops = hub_ops
    jhp, thp = ops[slab]
    r = np.random.default_rng(8).standard_normal(h.shape).astype(np.float32)
    rb = r[:batch.size]

    def j_loss(x):
        return (jnp.sum(j_hub.hub_pool_matmul(jhp, x, jnp.float32, impl) * r)
                + jnp.sum(j_hub.hub_pool_matmul_batch(jhp, x, jnp.asarray(batch), jnp.float32,
                                                      impl) * rb))

    ref = np.asarray(jax.grad(j_loss)(jnp.asarray(h)))
    x = _t(h).requires_grad_()
    loss = ((t_hub.hub_pool_matmul(thp, x, torch.float32, impl) * _t(r)).sum()
            + (t_hub.hub_pool_matmul_batch(thp, x, _t(batch), torch.float32, impl)
               * _t(rb)).sum())
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), ref, atol=2e-4 * np.abs(ref).max(), rtol=0)


def test_hub_pool_matmul_takes_a_residual_layout(hub_ops):
    """The residual's backward layout (limit N), built with or without the
    residual's weights, gives the gradient that no layout gives; the
    segment sum on the layout that leaves the padding out matches it too;
    with the torch gather a layout is refused."""
    h, _, ops = hub_ops
    thp = ops["float32"][1]
    lay = t_pool.segment_layout(thp.res_nbrs, h.shape[0])
    masked = t_pool.segment_layout(thp.res_nbrs, h.shape[0], weights=thp.res_w)
    assert int(masked.row_ptr[-1]) == int((thp.res_w != 0).sum()) < int(lay.row_ptr[-1])

    def grad(layout, impl="pallas"):
        x = _t(h).requires_grad_()
        t_hub.hub_pool_matmul(thp, x, torch.float32, impl, bwd_layout=layout).sum().backward()
        return x.grad

    assert torch.equal(grad(lay), grad(None)) and torch.equal(grad(masked), grad(None))
    g = torch.ones((h.shape[0], h.shape[1]))
    args = (_t(h), thp.res_nbrs, thp.res_w, h.shape[0], g)
    ref, _ = t_pool.gather_pool_bwd_plain(*args, need_weights=False)
    torch.testing.assert_close(t_pool.gather_pool_bwd_segment_plain(*args, masked), ref,
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="bwd_layout"):
        grad(lay, "xla")


@pytest.fixture(scope="module")
def block_ops():
    n, d = 300, 16
    nbrs, w, h = _tables(n=n, k=7, d=d, seed=11)
    perm = j_bsp.mass_permutation(nbrs, w, valid_limit=n)
    ops = {}
    for dtype in ("float32", "bfloat16", "float8_e4m3fn"):
        jbp, _ = j_bsp.build_block_pool(nbrs, w, perm, valid_limit=n, block_size=64,
                                        max_blocks=3)
        if dtype != "bfloat16":      # the trainer's cast after the bf16 build
            jbp = jbp._replace(a_blocks=jbp.a_blocks.astype(getattr(jnp, dtype)))
        ops[dtype] = (jbp, _port_block(jbp))
    return h, ops


@pytest.mark.parametrize("slab,compute", [("float32", "float32"), ("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16"),
                                          ("float8_e4m3fn", "bfloat16")])
def test_block_pool_matmul_matches_jax(block_ops, slab, compute):
    h, ops = block_ops
    jbp, tbp = ops[slab]
    td, jd = _T_DTYPES[compute], getattr(jnp, compute)
    got = t_bsp.block_pool_matmul(tbp, _t(h).to(td), dtype=td)
    ref = np.asarray(j_bsp.block_pool_matmul(jbp, jnp.asarray(h).astype(jd),
                                             dtype=jd).astype(jnp.float32))
    assert got.dtype == td and got.shape == h.shape
    if compute == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    else:
        _within_bf16_step(got, ref)


@pytest.mark.parametrize("slab", ["float32", "bfloat16"])
def test_block_pool_gradients_match_jax(block_ops, slab):
    h, ops = block_ops
    jbp, tbp = ops[slab]
    r = np.random.default_rng(9).standard_normal(h.shape).astype(np.float32)
    ref = np.asarray(jax.grad(lambda x: jnp.sum(
        j_bsp.block_pool_matmul(jbp, x, jnp.float32) * r))(jnp.asarray(h)))
    x = _t(h).requires_grad_()
    (t_bsp.block_pool_matmul(tbp, x, torch.float32) * _t(r)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), ref, atol=2e-4 * np.abs(ref).max(), rtol=0)


# ---------------------------------------------------------------------------
# Forwards with structured operators
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def forward_setup(tiny_data):
    cfg, data = tiny_data
    m = data.num_movies
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, cfg.features.feature_dim)).astype(np.float32)
    params = j_ps.init_params(jax.random.PRNGKey(1), cfg.features.feature_dim,
                              cfg.model.hidden_dim, cfg.model.embed_dim, 2)
    tables = [_tables(n=m, k=10, seed=20 + i)[:2] for i in range(2)]
    batch = rng.integers(0, m + 3, 40).astype(np.int32)
    return x, params, tables, m, batch


def _j_operators(form, tables, m):
    if form == "block":
        perm = j_bsp.mass_permutation(*tables[0], valid_limit=m)
        return [j_bsp.build_block_pool(nb, w, perm, valid_limit=m, block_size=32,
                                       max_blocks=4)[0] for nb, w in tables]
    return [j_hub.build_hub_pool(nb, w, valid_limit=m, head=48, residual=4)[0]
            for nb, w in tables[:2 if form == "hubf" else 1]]


@pytest.mark.parametrize("form", ["hub", "hubf", "block"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_pooled_forwards_with_operators_match_jax(forward_setup, form, impl):
    """``pooled_forward`` and ``pooled_forward_batch`` (f32) with hub
    operators for layer 0 (``hub``) or both layers (``hubf``, the batch
    layer through ``hub_pool_matmul_batch``), or block operators for both
    (the batch layer pools the whole graph and takes its rows): embeddings
    2e-5, parameter gradients 1e-4 of the largest."""
    x, params, tables, m, batch = forward_setup
    j_mats = _j_operators(form, tables, m)
    t_mats = tuple(_port_block(o) if form == "block" else _port_hub(o) for o in j_mats)
    r = np.random.default_rng(5).standard_normal((batch.size, 32)).astype(np.float32)
    j_nb, j_w = [jnp.asarray(nb) for nb, _ in tables], [jnp.asarray(w) for _, w in tables]
    t_nb, t_w = [_t(nb) for nb, _ in tables], [_t(w) for _, w in tables]

    def j_loss(p):
        emb = j_ps.pooled_forward_batch(p, jnp.asarray(x), j_nb, j_w, jnp.asarray(batch),
                                        valid_limit=m, dtype=jnp.float32,
                                        pool_mats=tuple(j_mats), gather_impl=impl)
        return jnp.sum(emb * r), emb

    (_, ref), ref_g = jax.value_and_grad(j_loss, has_aux=True)(params)
    flat = {k: _t(v).requires_grad_() for k, v in _flatten(params).items()}
    emb = t_ps.pooled_forward_batch(tree.unflatten(flat), _t(x), t_nb, t_w, _t(batch),
                                    valid_limit=m, dtype=torch.float32, pool_mats=t_mats,
                                    gather_impl=impl)
    (emb * _t(r)).sum().backward()
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    ref_g = _flatten(ref_g)
    for k, v in flat.items():
        g = torch.zeros_like(v) if v.grad is None else v.grad
        scale = max(float(np.abs(ref_g[k]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_g[k]), atol=1e-4 * scale,
                                   rtol=0, err_msg=k)

    full = t_ps.pooled_forward(tree.unflatten({k: v.detach() for k, v in flat.items()}),
                               _t(x), t_nb, t_w, valid_limit=m, dtype=torch.float32,
                               pool_mats=t_mats, gather_impl=impl)
    ref_full = j_ps.pooled_forward(params, jnp.asarray(x), j_nb, j_w, valid_limit=m,
                                   dtype=jnp.float32, pool_mats=tuple(j_mats),
                                   gather_impl=impl)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref_full), atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# The trainer: rung choice, gates, fallbacks, float8
# ---------------------------------------------------------------------------

def _both_trainers(tmp_path, over: dict):
    """The JAX trainer and the port's (CPU) on one config, the port given
    JAX's tables; returns them with each one's logged event names."""
    cfg = small_test_config().override({"paths.checkpoint_dir": str(tmp_path), **over})
    jlog, tlog = io.StringIO(), io.StringIO()
    jt = JTrainer(cfg, j_dataset.load(cfg), JLogger(stream=jlog))
    jt.refresh_neighborhoods()
    tcfg = TConfig.from_dict(cfg.to_dict())
    tt = TTrainer(tcfg, t_dataset.load(tcfg), TLogger(stream=tlog), device="cpu")
    tt.set_neighborhood_tables([(np.asarray(a), np.asarray(b)) for a, b in jt.nbr_tables])
    return jt, tt, _events(jlog), _events(tlog)


def _events(log: io.StringIO) -> list[str]:
    import json

    pool_events = ("hub_pool", "hub_pool_residual_escalated", "hub_pool_fallback",
                   "block_cluster", "block_pool", "block_pool_fallback")
    return [e["event"] for e in map(json.loads, log.getvalue().splitlines())
            if e["event"] in pool_events]


def _kinds(mats) -> list[str]:
    return ["hub" if isinstance(m, (j_hub.HubPool, t_hub.HubPool)) else
            "block" if isinstance(m, (j_bsp.BlockPool, t_bsp.BlockPool)) else "dense"
            for m in mats]


_AUTO_AT_SCALE = {"model.pool_impl": "auto", "model.dense_pool_max_rows": 16,
                  "model.dense_pool_hybrid_max_rows": 16}


@pytest.mark.parametrize("name,over", [
    ("hubf_by_capacity", {**_AUTO_AT_SCALE, "model.hub_pool_max_dropped_mass": 1.0}),
    ("hub_budget_zero", {**_AUTO_AT_SCALE, "model.hub_pool_max_dropped_mass": 1.0,
                         "model.auto_hub_final_max_bytes": 0}),
    ("hub_auto_final_off", {**_AUTO_AT_SCALE, "model.hub_pool_max_dropped_mass": 1.0,
                            "model.auto_hub_final": False}),
    ("hub_final_explicit", {**_AUTO_AT_SCALE, "model.hub_pool_max_dropped_mass": 1.0,
                            "model.auto_hub_final": False,
                            "model.hub_pool_final_layer": True}),
    ("hub_dedicated_cap", {"model.pool_impl": "hub", "model.hub_pool_head": 1,
                           "model.hub_pool_residual": 0,
                           "model.block_pool_max_dropped_mass": 0.01,
                           "model.hub_pool_max_dropped_mass": 1.0}),
    ("hub_to_gather", {"model.pool_impl": "hub", "model.hub_pool_head": 1,
                       "model.hub_pool_residual": 0,
                       "model.block_pool_max_dropped_mass": 0.01}),
    ("auto_hub_block_gather", {"model.pool_impl": "auto", "model.dense_pool_max_rows": 1,
                               "model.dense_pool_hybrid_max_rows": 1,
                               "model.hub_pool_head": 1, "model.hub_pool_residual": 0,
                               "model.block_pool_block_size": 16,
                               "model.block_pool_max_blocks": 1,
                               "model.block_pool_max_dropped_mass": 0.0001}),
    ("auto_hub_to_block", {**_AUTO_AT_SCALE, "model.hub_pool_head": 1,
                           "model.hub_pool_residual": 1,
                           "model.block_pool_block_size": 64,
                           "model.block_pool_max_blocks": 10_000}),
    ("residual_doubled", {"model.pool_impl": "hub", "model.hub_pool_head": 1,
                          "model.hub_pool_residual": 4}),
    ("block", {"model.pool_impl": "block", "model.block_pool_block_size": 64,
               "model.block_pool_max_blocks": 10_000}),
    ("block_to_gather", {"model.pool_impl": "block", "model.block_pool_block_size": 16,
                         "model.block_pool_max_blocks": 1}),
    ("hybrid", {"model.pool_impl": "hybrid"}),
    ("dense", {}),
])
def test_trainer_rung_choice_matches_jax(tmp_path, name, over):
    """On the same tables the port builds the operators JAX's trainer builds
    (kind, count, residual width, head width) and logs the same chain of
    build and fallback events."""
    jt, tt, jev, tev = _both_trainers(tmp_path, over)
    assert _kinds(tt.pool_mats) == _kinds(jt.pool_mats), name
    assert tev == jev, name
    for a, b in zip(tt.pool_mats, jt.pool_mats):
        if isinstance(a, t_hub.HubPool):
            assert a.a_head.shape == b.a_head.shape and a.res_w.shape == b.res_w.shape
    if name == "residual_doubled":
        assert tt.pool_mats[0].res_w.shape[1] == 8 and "hub_pool_residual_escalated" in tev
    if name == "auto_hub_block_gather":
        assert tt.pool_mats == () and "block_pool_fallback" in tev


def test_trainer_fallback_frees_the_failed_slab(tmp_path, monkeypatch):
    """The gate-failing slab is dropped before the wider build and before
    the block rung: no two hub slabs of one layer are alive at once."""
    import gc
    import weakref

    built, alive_at_build = [], []
    real = t_hub.build_hub_pool_device

    def tracking(*args, **kwargs):
        gc.collect()
        alive_at_build.append(sum(r() is not None for r in built))
        hp, st = real(*args, **kwargs)
        built.append(weakref.ref(hp.a_head))
        return hp, st

    monkeypatch.setattr(t_hub, "build_hub_pool_device", tracking)
    _, tt, _, tev = _both_trainers(tmp_path, {
        **_AUTO_AT_SCALE, "model.hub_pool_head": 1, "model.hub_pool_residual": 1,
        "model.block_pool_block_size": 64, "model.block_pool_max_blocks": 10_000})
    assert tev[:3] == ["hub_pool", "hub_pool_residual_escalated", "hub_pool_fallback"]
    assert alive_at_build == [0, 0]
    gc.collect()
    assert all(r() is None for r in built) and _kinds(tt.pool_mats) == ["block", "block"]


@pytest.mark.parametrize("impl", ["dense", "hybrid", "hub", "block"])
def test_trainer_float8_pool_matrices_on_every_rung(tmp_path, impl):
    """``pool_matrix_dtype=float8_e4m3fn`` builds float8 operators on every
    rung, equal to JAX's bit for bit (dense and block: bf16 build, then a
    cast; hub: built in float8), and a step trains on them. A dense matrix
    is JAX's in its first N columns, its row stride's further columns zero."""
    over = {"model.pool_impl": impl, "model.pool_matrix_dtype": "float8_e4m3fn",
            "model.hub_pool_max_dropped_mass": 1.0, "model.block_pool_block_size": 64,
            "model.block_pool_max_blocks": 10_000}
    jt, tt, _, _ = _both_trainers(tmp_path, over)
    assert tt.pool_mats and len(tt.pool_mats) == len(jt.pool_mats)
    for a, b in zip(tt.pool_mats, jt.pool_mats):
        ta = a.a_head if impl == "hub" else a.a_blocks if impl == "block" else a
        tb = b.a_head if impl == "hub" else b.a_blocks if impl == "block" else b
        assert ta.dtype == torch.float8_e4m3fn
        if impl == "hub":    # ties in the walk weights: compare one-rounding values
            continue
        if impl in ("dense", "hybrid"):
            assert ta.shape[1] % 64 == 0 and not ta[:, tb.shape[1]:].view(torch.uint8).any()
            ta = ta[:, :tb.shape[1]]
        assert torch.equal(ta.view(torch.uint8), _to_torch(tb).view(torch.uint8))
    pairs = tt._epoch_pairs(np.random.default_rng(0))
    losses = tt.train_steps(pairs[:1, :, 0], pairs[:1, :, 1], 1e-3, 0.0, 0)
    assert bool(torch.isfinite(losses).all())


def test_trainer_hub_layouts_for_the_kernel(tmp_path):
    """With ``gather_impl=pallas`` a full-graph hub layer's layout is its
    residual table's (limit N), built with the residual's weights so that
    the padding (id 0, weight 0) is left out: exactly ``res_w == 0`` slots,
    which is the share the trainer keeps for the ``neighborhoods`` event."""
    over = {**_AUTO_AT_SCALE, "model.hub_pool_max_dropped_mass": 1.0,
            "model.gather_impl": "pallas"}
    _, tt, _, _ = _both_trainers(tmp_path, over)
    assert _kinds(tt.pool_mats) == ["hub", "hub"] and len(tt.bwd_layouts) == 1
    hp = tt.pool_mats[0]
    ref = t_pool.segment_layout(hp.res_nbrs, tt.table_rows, weights=hp.res_w)
    for a, b in zip(tt.bwd_layouts[0], ref):
        assert torch.equal(a, b) if torch.is_tensor(b) else a == b
    pad = int((hp.res_w == 0).sum())
    assert pad > 0
    assert int(tt.bwd_layouts[0].row_ptr[-1]) == hp.res_nbrs.numel() - pad
    assert tt.bwd_zero_weight_share.tolist() == pytest.approx([pad / hp.res_w.numel()])


def test_trainer_logs_the_zero_weight_share(tmp_path):
    """An epoch on the hub rung with the kernels logs, in its
    ``neighborhoods`` event, the share of the residual's slots that the
    refreshed layout leaves out for a weight of 0; on the torch gather (no
    layouts) the event has no such field. On both, each layer's
    ``hub_pool`` event gives ``mass_slots_skipped``, the share of its walk
    table's slots that the column mass left out: the sentinels past the
    valid limit and the other slots of weight 0."""
    over = {**_AUTO_AT_SCALE, "model.hub_pool_max_dropped_mass": 1.0,
            "train.max_pairs_per_epoch": 64}
    for impl in ("pallas", "xla"):
        _, tt, _, _ = _both_trainers(tmp_path, {**over, "model.gather_impl": impl})
        tt.train_epoch(0)
        (event,) = [e for e in tt.log.history if e["event"] == "neighborhoods"]
        builds = [e for e in tt.log.history if e["event"] == "hub_pool"][-2:]
        assert [type(m).__name__ for m in tt.pool_mats] == ["HubPool", "HubPool"]
        for build, (nbrs, w) in zip(builds, tt.nbr_tables):
            kept = torch.where(nbrs < tt.valid_limit, w, 0.0)
            zero = (kept == 0) | (kept.sum(dim=1, keepdim=True) == 0)
            assert build["mass_slots_skipped"] == pytest.approx(float(zero.float().mean()),
                                                                abs=1e-7)
        assert any(e["mass_slots_skipped"] > 0 for e in builds)
        if impl == "xla":
            assert "bwd_zero_weight_share" not in event
            continue
        res_w = tt.pool_mats[0].res_w
        share = float((res_w == 0).sum()) / res_w.numel()
        assert share > 0 and event["bwd_zero_weight_share"] == pytest.approx([share])


# ---------------------------------------------------------------------------
# The slice as a whole: train_steps on the hubf rung against JAX's _run_steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["xla", "pallas"])
def hubf_run(request, tmp_path_factory):
    """One block of 3 steps at epoch 1 (one hard negative per query, NCE,
    dropout 0.2, f32) on the ``hubf`` rung chosen by ``pool_impl=auto``,
    through JAX's real ``_run_steps`` and the port's ``train_steps``, from
    the same params, tables, hub operators and draws."""
    cfg = small_test_config().override({
        **_AUTO_AT_SCALE, "model.hub_pool_max_dropped_mass": 1.0,
        "model.hub_pool_head": 64, "model.gather_impl": request.param,
        "train.compute_dtype": "float32",
        "paths.checkpoint_dir": str(tmp_path_factory.mktemp("hubf"))})
    jt = JTrainer(cfg, j_dataset.load(cfg), JLogger(stream=io.StringIO()))
    jt.refresh_neighborhoods()
    assert _kinds(jt.pool_mats) == ["hub", "hub"]
    tcfg = TConfig.from_dict(cfg.to_dict())
    tt = TTrainer(tcfg, t_dataset.load(tcfg), TLogger(stream=io.StringIO()), device="cpu")
    tt.x_table = _t(jt.x_table)
    tt.set_neighborhood_tables([(np.asarray(a), np.asarray(b)) for a, b in jt.nbr_tables])
    assert _kinds(tt.pool_mats) == ["hub", "hub"]
    tt.pool_mats = tuple(_port_hub(o) for o in jt.pool_mats)
    if request.param == "pallas":
        tt.bwd_layouts = tt.full_graph_layouts()
    tt.params = params_from_jax(_flatten(jt.params), "cpu")
    tt.opt_state = t_optim.state_from_jax(
        {f"opt/{k}": np.asarray(v) for k, v in _flatten(jt.opt_state._asdict()).items()}, "cpu")
    batches = jt._epoch_pairs(np.random.default_rng(5))[:3]
    q_blk, p_blk = batches[:, :, 0].astype(np.int32), batches[:, :, 1].astype(np.int32)
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(jt, key, q_blk, 1)
    jt.params, jt.opt_state, j_losses_ = jt._run_steps(
        jt.params, jt.opt_state, jt.x_table, tuple(t[0] for t in jt.nbr_tables),
        tuple(t[1] for t in jt.nbr_tables), jt.pool_mats, jt.graph, jnp.asarray(q_blk),
        jnp.asarray(p_blk), key, jnp.float32(1e-3), jnp.float32(1.0), num_hard=1)
    t_losses_ = tt.train_steps(q_blk, p_blk, 1e-3, 1.0, 1, draws=draws)
    return jt, tt, np.asarray(j_losses_), t_losses_.numpy()


def test_hubf_train_steps_losses_match_jax(hubf_run):
    _, _, ref, got = hubf_run
    assert got.shape == ref.shape == (3,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_hubf_train_steps_params_match_jax(hubf_run):
    jt, tt, _, _ = hubf_run
    ref = _flatten(jt.params)
    got = {k: v.numpy() for k, v in tree.flatten(tt.params).items()}
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], np.asarray(r), atol=1e-5, rtol=0, err_msg=k)


def test_hubf_embeddings_match_jax(hubf_run):
    """The serving pass on the hub rung (both layers through
    ``hub_pool_matmul``) after the steps."""
    jt, tt, _, _ = hubf_run
    np.testing.assert_allclose(tt.movie_embeddings().numpy(),
                               np.asarray(jt.movie_embeddings()), atol=2e-5, rtol=0)
