"""PyTorch port, the training slice against the JAX package.

Inputs come from numpy seeds or from JAX's own draws, fed to the port through
its seams (walk uniforms, selection noise, fallback ids, keep masks,
``StepDraws``). Tolerances, each with its reason:

- losses and their gradients, Adam: f32 sums in another order, 1e-6 relative
  (the moments 1e-5: ``0.9 m + 0.1 g`` cancels where m and g differ in sign);
- negatives and dropout given JAX's draws: exact (integer ids, masks);
- batch forwards: f32 2e-5 on the unit-norm embeddings and 1e-4 of the
  largest gradient on the parameter gradients; bf16 as ``test_torch_model``
  (2e-2, row cosine 0.999) and gradients within 0.15 relative norm: bf16
  rounds at other places in the two frameworks, and JAX's own bf16 gradients
  lie 6-12% (relative norm) from its f32 ones at this size;
- ``train_steps`` against JAX's ``_run_steps``: f32 losses 1e-5 relative and
  params within 1e-5 absolute (1% of one Adam step at lr 1e-3; Adam divides
  each gradient element by its own size, so an element whose gradient is
  within rounding of zero could step apart by up to 2 lr: none does here);
  bf16 losses 1e-3 relative and the params' updates within 0.25 relative norm
  (the gradients' bf16 noise, see above, turns into Adam steps of +-lr).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu import small_test_config
from movie_recommendation_engine_tpu.core.checkpoint import _flatten
from movie_recommendation_engine_tpu.graph import csr as j_csr
from movie_recommendation_engine_tpu.graph import dataset as j_dataset
from movie_recommendation_engine_tpu.models import losses as j_losses
from movie_recommendation_engine_tpu.models import pinsage as j_ps
from movie_recommendation_engine_tpu.sampling import negative as j_neg
from movie_recommendation_engine_tpu.sampling import random_walk as j_rw
from movie_recommendation_engine_tpu.train import optim as j_optim
from movie_recommendation_engine_tpu.train.trainer import Trainer as JTrainer
from movie_recommendation_engine_tpu_torch import api as t_api
from movie_recommendation_engine_tpu_torch.config import Config as TConfig
from movie_recommendation_engine_tpu_torch.core import tree
from movie_recommendation_engine_tpu_torch.core.checkpoint import params_from_jax
from movie_recommendation_engine_tpu_torch.graph import csr as t_csr
from movie_recommendation_engine_tpu_torch.graph import dataset as t_dataset
from movie_recommendation_engine_tpu_torch.models import losses as t_losses
from movie_recommendation_engine_tpu_torch.models import pinsage as t_ps
from movie_recommendation_engine_tpu_torch.ops import pool as t_pool
from movie_recommendation_engine_tpu_torch.sampling import negative as t_neg
from movie_recommendation_engine_tpu_torch.sampling import random_walk as t_rw
from movie_recommendation_engine_tpu_torch.train import optim as t_optim
from movie_recommendation_engine_tpu_torch.train.trainer import StepDraws
from movie_recommendation_engine_tpu_torch.train.trainer import Trainer as TTrainer

ROOT = Path(__file__).resolve().parents[1]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Losses: value and gradient in every input
# ---------------------------------------------------------------------------

def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _loss_cases():
    b, n, h, d = 6, 9, 3, 8
    return {
        "max_margin_3d": (lambda m, q, p, r: m.max_margin_loss(q, p, r, 0.3), (b, n, d)),
        "max_margin_shared": (lambda m, q, p, r: m.max_margin_loss(q, p, r, 0.3), (n, d)),
        "max_margin_paired": (lambda m, q, p, r: m.max_margin_loss(q, p, r, 0.3), (b, d)),
        "shared_pool": (lambda m, q, p, r: m.shared_pool_max_margin_loss(q, p, r, 0.2), (n, d)),
        "batch_hard": (lambda m, q, p, r: m.batch_hard_triplet_loss(q, p + 0 * r.sum(), 0.5),
                       (n, d)),
        "curriculum": (lambda m, q, p, r: m.curriculum_loss(q, p, r[:n], r[n:].reshape(b, h, d),
                                                            1.5, margin=0.3, max_epochs=4),
                       (n + b * h, d)),
        "curriculum_3d_no_hard": (lambda m, q, p, r: m.curriculum_loss(q, p, r, None, 2.0),
                                  (b, n, d)),
        "cosine": (lambda m, q, p, r: m.cosine_objective(q, p + 0 * r.sum()), (n, d)),
        "nce": (lambda m, q, p, r: m.nce_loss(q, p, r[:n], r[n:].reshape(b, h, d), 0.1),
                (n + b * h, d)),
        "nce_no_hard": (lambda m, q, p, r: m.nce_loss(q, p, r, None, 0.07), (n, d)),
    }


@pytest.mark.parametrize("case", sorted(_loss_cases()))
def test_loss_value_and_grads_match_jax(case):
    fn, neg_shape = _loss_cases()[case]
    rng = np.random.default_rng(len(case))
    q, p, r = _unit(rng, 6, 8), _unit(rng, 6, 8), _unit(rng, *neg_shape)
    ref, ref_g = jax.value_and_grad(lambda *a: fn(j_losses, *a), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(r))
    args = [_t(x).requires_grad_() for x in (q, p, r)]
    got = fn(t_losses, *args)
    got_g = torch.autograd.grad(got, args)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6, atol=1e-7)
    for g, rg in zip(got_g, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Adam, plateau, early stop
# ---------------------------------------------------------------------------

def test_adam_matches_jax_and_converts_to_its_layout():
    rng = np.random.default_rng(0)
    jp = j_ps.init_params(jax.random.PRNGKey(0), 6, 8, 4, 2)
    tp = params_from_jax(_flatten(jp), "cpu")
    js, ts = j_optim.adam_init(jp), t_optim.adam_init(tp)
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)), jp)
        tg = params_from_jax(_flatten(grads), "cpu")
        lr = 1e-3 * 0.5 ** (step // 2)
        jp, js = j_optim.adam_update(grads, js, jp, jnp.float32(lr))
        tp, ts = t_optim.adam_update(tg, ts, tp, lr)
    for k, v in _flatten(jp).items():
        np.testing.assert_allclose(tree.flatten(tp)[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-8)
    flat = t_optim.state_to_jax(ts)
    ref = {f"opt/{k}": np.asarray(v) for k, v in _flatten(js._asdict()).items()}
    assert sorted(flat) == sorted(ref)
    assert flat["opt/step"].dtype == np.int32 and int(flat["opt/step"]) == 5
    for k in ref:
        np.testing.assert_allclose(flat[k], ref[k], rtol=1e-5, atol=1e-10)
    back = t_optim.state_from_jax(flat, "cpu")
    assert back.step == 5
    for a, b in zip(tree.leaves(back.nu), tree.leaves(ts.nu)):
        assert torch.equal(a, b)


def test_plateau_and_early_stop_match_jax():
    metrics = [5.0, 4.0, 4.5, 4.2, 4.1, 3.0, 3.5, 3.6, 3.7, 3.8, 2.0]
    js, ts = j_optim.plateau_init(0.01), t_optim.plateau_init(0.01)
    for m in metrics:
        js = j_optim.plateau_step(js, m, factor=0.5, patience=2, min_lr=1e-3)
        ts = t_optim.plateau_step(ts, m, factor=0.5, patience=2, min_lr=1e-3)
        assert ts._asdict() == js._asdict()
    je, te = j_optim.EarlyStopping(3), t_optim.EarlyStopping(3)
    for m in [0.1, 0.2, 0.2, 0.15, 0.3, 0.3, 0.3, 0.3]:
        assert te.update(m) == je.update(m)
        assert (te.best, te.num_bad) == (je.best, je.num_bad)


# ---------------------------------------------------------------------------
# Negatives and dropout, given JAX's draws
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def walk_graphs():
    rng = np.random.default_rng(0)
    n, e = 60, 500
    src, dst = rng.integers(0, n - 5, e), rng.integers(0, n, e)
    w = rng.integers(1, 6, e).astype(np.float32)
    jc = j_csr.csr_from_edge_index(np.stack([src, dst]), w, num_nodes=n)
    tc = t_csr.csr_from_edge_index(np.stack([src, dst]), w, num_nodes=n)
    return jc, j_rw.device_graph(jc), t_rw.device_graph(tc, "cpu")


@pytest.mark.parametrize("num_walks,walk_length,min_rank,max_rank,num_hard", [
    (10, 4, 2, 30, 4),      # a window of ranks [2, 30): chosen nodes and fill
    (10, 4, 5, 12, 9),      # more hard negatives than the window holds
    (100, 2, 2000, 5000, 3),  # the default budget: the window is empty
])
def test_sample_hard_negatives_matches_jax(walk_graphs, num_walks, walk_length, min_rank,
                                           max_rank, num_hard):
    csr, jg, tg = walk_graphs
    num_movies = 40               # nodes 40..59 are not movies
    q = np.arange(0, 60, 2, dtype=np.int32)
    key = jax.random.PRNGKey(num_walks + min_rank)
    iters = j_rw.search_iters(csr)
    ref = np.asarray(j_neg.sample_hard_negatives(
        jg, jnp.asarray(q), key, num_hard, num_movies, num_walks=num_walks,
        walk_length=walk_length, min_rank=min_rank, max_rank=max_rank, n_iters=iters))
    # JAX's draws (negative.sample_hard_negatives, random_walk._random_walks_jit).
    k_walk, k_sel, k_rand = jax.random.split(key, 3)
    uniforms = np.stack([np.asarray(jax.random.uniform(k, (q.size * num_walks,)))
                         for k in jax.random.split(k_walk, walk_length)])
    hi = min(max_rank, num_walks * walk_length)
    noise = np.asarray(jax.random.uniform(k_sel, (q.size, max(hi - min_rank, 0))))
    fallback = np.asarray(jax.random.randint(k_rand, (q.size, num_hard), 0, num_movies,
                                             dtype=jnp.int32))
    got = t_neg.sample_hard_negatives(
        tg, _t(q), num_hard, num_movies, num_walks=num_walks, walk_length=walk_length,
        min_rank=min_rank, max_rank=max_rank, n_iters=iters, uniforms=_t(uniforms),
        noise=_t(noise), fallback=_t(fallback))
    assert got.dtype == torch.int32 and got.shape == (q.size, num_hard)
    np.testing.assert_array_equal(got.numpy(), ref)
    chosen = ref != fallback
    if min_rank < hi and num_hard <= 4:
        assert chosen.any()       # some ids came out of the window
    assert (ref < num_movies).all()


def test_sample_negatives_from_the_generator(walk_graphs):
    _, _, tg = walk_graphs
    gen = torch.Generator().manual_seed(3)
    r = t_neg.sample_random_negatives(50, 32, gen)
    assert r.dtype == torch.int32 and len(set(r.tolist())) == 32 and r.max() < 50
    h = t_neg.sample_hard_negatives(tg, torch.arange(10), 5, 40, num_walks=10,
                                    walk_length=4, min_rank=2, max_rank=30,
                                    n_iters=6, generator=gen)
    assert h.shape == (10, 5) and (h >= 0).all() and (h < 40).all()
    for epoch in range(9):
        assert t_neg.curriculum_num_hard(epoch, 6) == j_neg.curriculum_num_hard(epoch, 6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_jax_given_its_keep_mask(dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    h = np.random.default_rng(1).standard_normal((50, 24)).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    ref, _ = j_ps._dropout(jnp.asarray(h, jd), 0.3, rng)
    keep = np.asarray(jax.random.bernoulli(jax.random.split(rng)[1], 0.7, h.shape))
    got = t_ps._dropout(_t(h).to(td), 0.3, keep=_t(keep))
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    drawn = t_ps._dropout(torch.ones(200, 200), 0.3, torch.Generator().manual_seed(0))
    assert abs((drawn > 0).float().mean().item() - 0.7) < 0.01
    assert torch.equal(t_ps._dropout(_t(h), 0.3), _t(h))     # no mask, no generator


# ---------------------------------------------------------------------------
# Batch-restricted forwards: values and parameter gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def forward_setup(tiny_data):
    cfg, data = tiny_data
    m = data.num_movies
    x = np.random.default_rng(0).standard_normal((m, cfg.features.feature_dim)).astype(np.float32)
    params = j_ps.init_params(jax.random.PRNGKey(1), cfg.features.feature_dim,
                              cfg.model.hidden_dim, cfg.model.embed_dim, 2)
    csr = data.build_bipartite_graph()
    tables = j_rw.all_node_neighborhood_tables(
        j_rw.device_graph(csr), jax.random.PRNGKey(2), 2, cfg.walk.num_walks,
        cfg.walk.walk_length, cfg.walk.num_neighbors, j_rw.search_iters(csr),
        num_nodes=m, restrict_below=m)
    tables = [(np.array(nb), np.array(w)) for nb, w in tables]
    batch = np.random.default_rng(3).integers(0, m + 3, 40).astype(np.int32)  # some clamped
    return x, params, tables, m, batch


@pytest.mark.parametrize("form", ["gather_xla", "gather_pallas", "hybrid", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pooled_forward_batch_values_and_grads_match_jax(forward_setup, form, dtype):
    x, params, tables, m, batch = forward_setup
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    n_dense = {"gather_xla": 0, "gather_pallas": 0, "hybrid": 1, "dense": 2}[form]
    impl = "pallas" if form == "gather_pallas" else "xla"
    j_mats = [j_ps.build_pool_matrix(jnp.asarray(nb), jnp.asarray(w), m, m)
              for nb, w in tables[:n_dense]]
    t_mats = [_t(np.asarray(a, np.float32)).bfloat16() for a in j_mats]
    drop_rng = jax.random.PRNGKey(7)
    keep = [_t(np.asarray(jax.random.bernoulli(jax.random.split(drop_rng)[1], 0.8,
                                               (m, params["convs"][0]["self"]["w"].shape[0]))))]
    r = np.random.default_rng(5).standard_normal((batch.size, 32)).astype(np.float32)

    def j_loss(p):
        if form == "dense":
            emb = j_ps.pooled_forward_batch_dense(p, jnp.asarray(x), j_mats, jnp.asarray(batch),
                                                  dtype=jd, dropout_rate=0.2,
                                                  dropout_rng=drop_rng)
        else:
            emb = j_ps.pooled_forward_batch(
                p, jnp.asarray(x), [jnp.asarray(nb) for nb, _ in tables],
                [jnp.asarray(w) for _, w in tables], jnp.asarray(batch), valid_limit=m,
                dtype=jd, dropout_rate=0.2, dropout_rng=drop_rng, pool_mats=tuple(j_mats),
                gather_impl=impl)
        return jnp.sum(emb * r), emb

    (_, ref), ref_g = jax.value_and_grad(j_loss, has_aux=True)(params)
    flat = {k: _t(v).requires_grad_() for k, v in _flatten(params).items()}
    tp = tree.unflatten(flat)
    if form == "dense":
        emb = t_ps.pooled_forward_batch_dense(tp, _t(x), t_mats, _t(batch), dtype=td,
                                              dropout_rate=0.2, dropout_keep=keep)
    else:
        emb = t_ps.pooled_forward_batch(
            tp, _t(x), [_t(nb) for nb, _ in tables], [_t(w) for _, w in tables], _t(batch),
            valid_limit=m, dtype=td, dropout_rate=0.2, dropout_keep=keep,
            pool_mats=tuple(t_mats), gather_impl=impl)
    (emb * _t(r)).sum().backward()
    grads = {k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in flat.items()}
    assert emb.dtype == torch.float32 and emb.shape == (batch.size, 32)
    got, ref = emb.detach().numpy().astype(np.float64), np.asarray(ref, np.float64)
    ref_g = _flatten(ref_g)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
        for k, g in grads.items():
            scale = max(float(np.abs(ref_g[k]).max()), 1e-30)
            np.testing.assert_allclose(g.numpy(), np.asarray(ref_g[k]),
                                       atol=1e-4 * scale, rtol=0, err_msg=k)
        return
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)
    cos = (got * ref).sum(1) / np.maximum(np.linalg.norm(got, axis=1)
                                          * np.linalg.norm(ref, axis=1), 1e-12)
    assert cos.min() >= 0.999
    for k, g in grads.items():
        a, b = g.numpy(), np.asarray(ref_g[k], np.float32)
        assert np.linalg.norm(a - b) <= 0.15 * np.linalg.norm(b) + 1e-12, k


def test_pooled_forward_batch_takes_bwd_layouts(forward_setup, tmp_path):
    """The backward kernel's layout of the full-graph layer, built ahead,
    gives the gradients that no layout gives (on the CPU both take the plain
    backward, so this holds the plumbing: the layout reaches the pooling and
    is checked against its table; one built for another limit raises, and so
    does one with ``gather_impl="xla"``). A trainer on the kernel rung builds
    one per full-graph gather layer at each table refresh."""
    x, params, tables, m, batch = forward_setup

    def grads(layouts, impl="pallas"):
        flat = {k: _t(v).requires_grad_() for k, v in _flatten(params).items()}
        emb = t_ps.pooled_forward_batch(
            tree.unflatten(flat), _t(x), [_t(nb) for nb, _ in tables],
            [_t(w) for _, w in tables], _t(batch), valid_limit=m, dtype=torch.float32,
            gather_impl=impl, bwd_layouts=layouts)
        emb.sum().backward()
        return {k: v.grad for k, v in flat.items()}

    lay = t_pool.segment_layout(_t(tables[0][0]), m)
    with_layouts, without = grads([lay]), grads(None)
    assert sum(g is not None for g in without.values()) >= 8
    for k, g in without.items():
        assert (g is None and with_layouts[k] is None) or torch.equal(with_layouts[k], g), k
    with pytest.raises(ValueError, match="bwd_layout"):
        grads([lay], impl="xla")
    with pytest.raises(ValueError, match="layout was built for"):
        grads([t_pool.segment_layout(_t(tables[0][0]), m - 1)])

    cfg = _small(tmp_path, **{"model.pool_impl": "gather", "model.gather_impl": "pallas"})
    tr = TTrainer(cfg, t_dataset.load(cfg), device="cpu")
    tr.refresh_neighborhoods()
    assert len(tr.bwd_layouts) == cfg.model.num_layers - 1
    ref = t_pool.segment_layout(tr.nbr_tables[0][0], min(tr.valid_limit, tr.table_rows))
    for a, b in zip(tr.bwd_layouts[0], ref):
        assert torch.equal(a, b) if torch.is_tensor(b) else a == b
    xla = TTrainer(_small(tmp_path, **{"model.pool_impl": "gather"}), tr.data, device="cpu")
    xla.set_neighborhood_tables(tr.nbr_tables)
    assert xla.bwd_layouts is None


# ---------------------------------------------------------------------------
# The slice as a whole: train_steps against JAX's _run_steps
# ---------------------------------------------------------------------------

SLICE_RUNS = {"dense_f32": ("dense", "float32"), "gather_f32": ("gather", "float32"),
              "dense_bf16": ("dense", "bfloat16"), "mlp_f32": ("mlp", "float32")}


def _rung(rung: str, dtype: str):
    over = {"train.compute_dtype": dtype}
    if rung == "gather":
        over.update({"model.pool_impl": "gather", "model.gather_impl": "pallas"})
    if rung == "mlp":
        over["train.train_path"] = "mlp"      # no graph, the cosine objective
    return small_test_config().override(over)


def _port_trainer_like(jt, cfg) -> TTrainer:
    """A CPU port trainer with the JAX trainer's features, tables, pool
    matrices, params and optimizer state."""
    tcfg = TConfig.from_dict(cfg.to_dict())
    tt = TTrainer(tcfg, t_dataset.load(tcfg), device="cpu")
    tt.x_table = _t(jt.x_table)
    tt.set_neighborhood_tables([(np.asarray(a), np.asarray(b)) for a, b in jt.nbr_tables])
    if jt.pool_mats:
        tt.pool_mats = tuple(_t(np.asarray(a, np.float32)).bfloat16() for a in jt.pool_mats)
    tt.params = params_from_jax(_flatten(jt.params), "cpu")
    tt.opt_state = t_optim.state_from_jax(
        {f"opt/{k}": np.asarray(v) for k, v in _flatten(jt.opt_state._asdict()).items()}, "cpu")
    return tt


def _jax_draws(jt, key, q_blk, num_hard) -> list[StepDraws]:
    """The negatives and keep masks JAX's ``_run_steps`` draws from ``key``
    (``one_step``: split per step, then k_neg, k_hard, k_drop; ``_dropout``:
    one split per hidden conv)."""
    cfg = jt.cfg
    num_rand = min(cfg.train.num_negative_samples, jt.data.num_movies)
    draws = []
    for s, k in enumerate(jax.random.split(key, q_blk.shape[0])):
        k_neg, k_hard, k_drop = jax.random.split(k, 3)
        rand = j_neg.sample_random_negatives(k_neg, jt.data.num_movies, num_rand)
        hard = None
        if num_hard:
            hard = _t(j_neg.sample_hard_negatives(
                jt.graph, jnp.asarray(q_blk[s]), k_hard, num_hard, jt.data.num_movies,
                num_walks=100, walk_length=cfg.walk.walk_length,
                min_rank=cfg.train.hard_neg_min_rank, max_rank=cfg.train.hard_neg_max_rank,
                n_iters=jt.n_iters))
        keep = jax.random.bernoulli(jax.random.split(k_drop)[1], 1 - cfg.model.dropout,
                                    (jt.table_rows, cfg.model.hidden_dim))
        draws.append(StepDraws(_t(rand), hard, [_t(keep)]))
    return draws


@pytest.fixture(scope="module", params=sorted(SLICE_RUNS))
def slice_run(request):
    """One block of 3 steps at epoch 1 (one hard negative per query, NCE,
    dropout 0.2) through JAX's real ``_run_steps`` and the port's
    ``train_steps``, from the same params, tables and draws."""
    cfg = _rung(*SLICE_RUNS[request.param])
    jt = JTrainer(cfg, j_dataset.load(cfg))
    jt.refresh_neighborhoods()
    tt = _port_trainer_like(jt, cfg)
    p0 = {k: np.array(v) for k, v in _flatten(jt.params).items()}
    batches = jt._epoch_pairs(np.random.default_rng(5))[:3]
    q_blk, p_blk = batches[:, :, 0].astype(np.int32), batches[:, :, 1].astype(np.int32)
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(jt, key, q_blk, 1)
    jt.params, jt.opt_state, j_losses_ = jt._run_steps(
        jt.params, jt.opt_state, jt.x_table, tuple(t[0] for t in jt.nbr_tables),
        tuple(t[1] for t in jt.nbr_tables), jt.pool_mats, jt.graph, jnp.asarray(q_blk),
        jnp.asarray(p_blk), key, jnp.float32(1e-3), jnp.float32(1.0), num_hard=1)
    t_losses_ = tt.train_steps(q_blk, p_blk, 1e-3, 1.0, 1, draws=draws)
    return {"name": request.param, "dtype": cfg.train.compute_dtype, "jt": jt, "tt": tt,
            "p0": p0, "j_losses": np.asarray(j_losses_), "t_losses": t_losses_.numpy()}


def test_train_steps_losses_match_jax(slice_run):
    got, ref = slice_run["t_losses"], slice_run["j_losses"]
    assert got.shape == ref.shape == (3,) and np.isfinite(got).all()
    rtol = 1e-5 if slice_run["dtype"] == "float32" else 1e-3
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


def test_train_steps_params_match_jax(slice_run):
    ref = _flatten(slice_run["jt"].params)
    got = {k: v.numpy() for k, v in tree.flatten(slice_run["tt"].params).items()}
    assert sorted(got) == sorted(ref)
    moved = 0
    for k, r in ref.items():
        r, p0 = np.asarray(r), slice_run["p0"][k]
        if slice_run["dtype"] == "float32":
            np.testing.assert_allclose(got[k], r, atol=1e-5, rtol=0, err_msg=k)
        else:
            upd = np.linalg.norm(r - p0)
            assert np.linalg.norm(got[k] - r) <= 0.25 * upd + 1e-12, k
        moved += bool(np.any(r != p0))
    # Every leaf the loss reads took a step: the MLP path reads the input,
    # self and output projections only.
    assert moved >= (8 if slice_run["name"].startswith("mlp") else 10)


def test_train_steps_adam_state_matches_jax(slice_run):
    jt, tt = slice_run["jt"], slice_run["tt"]
    assert tt.opt_state.step == int(jt.opt_state.step) == 3
    if slice_run["dtype"] != "float32":
        return
    for name in ("mu", "nu"):
        ref = _flatten(getattr(jt.opt_state, name))
        got = tree.flatten(getattr(tt.opt_state, name))
        for k, r in ref.items():
            r = np.asarray(r)
            np.testing.assert_allclose(got[k].numpy(), r, rtol=0,
                                       atol=1e-5 * max(float(np.abs(r).max()), 1e-30))


# ---------------------------------------------------------------------------
# fit, checkpoints across the packages, the CLI
# ---------------------------------------------------------------------------

def _small(tmp_path, **over):
    cfg = small_test_config().override({"paths.checkpoint_dir": str(tmp_path / "ck"), **over})
    return TConfig.from_dict(cfg.to_dict())


def test_fit_on_the_cpu_lowers_the_loss(tmp_path):
    """Five epochs on the default (dense) rung, without hard negatives so
    that every epoch has the same objective; validation on a slice of the
    train pairs (the tiny corpus has no validation pairs)."""
    cfg = _small(tmp_path, **{"train.epochs": 5, "train.max_hard_negatives": 0,
                              "train.learning_rate": 3e-3})
    eng = t_api.Engine(cfg, device="cpu")
    eng.trainer.val_pairs = eng.trainer.train_pairs[:60]
    out = eng.fit()
    hist = [h["loss"] for h in out["history"]]
    assert len(hist) == 5 and np.isfinite(hist).all()
    assert hist[-1] < hist[0]
    assert out["best_path"] is not None and os.path.exists(out["best_path"] + ".npz")
    assert os.path.exists(tmp_path / "ck" / "last_model.npz")
    assert eng.trainer.epoch == 5 and eng.trainer.opt_state.step >= 5


def test_port_checkpoint_resumes_exactly(tmp_path):
    """Saving reseeds the generator from the rng words it writes, so a run
    that saves and goes on equals a run that resumes from what it saved."""
    cfg = _small(tmp_path, **{"model.pool_impl": "gather", "model.gather_impl": "pallas",
                              "train.epochs": 3})
    data = t_dataset.load(cfg)
    a = TTrainer(cfg, data, device="cpu")
    a.train_epoch(0)
    a.epoch = 1
    a.save_checkpoint(str(tmp_path / "mid"))
    a.train_epoch(1)
    b = TTrainer(cfg, data, device="cpu")
    b.load_checkpoint(str(tmp_path / "mid"))
    b.train_epoch(1)
    assert b.epoch == 1 and b.opt_state.step == a.opt_state.step
    for x, y in zip(tree.leaves(a.params), tree.leaves(b.params)):
        assert torch.equal(x, y)


def test_save_pytree_is_read_by_jax(tmp_path):
    """``core/checkpoint.save_pytree`` writes the JAX package's format: the
    same sidecar as JAX's own ``save_pytree`` of the same tree, and JAX's
    ``load_pytree`` restores the tree from it exactly."""
    from movie_recommendation_engine_tpu.core import checkpoint as j_ckpt
    from movie_recommendation_engine_tpu_torch.core import checkpoint as t_ckpt

    jp = {"params": j_ps.init_params(jax.random.PRNGKey(0), 6, 8, 4, 2),
          "rng": jax.random.PRNGKey(3)}
    tp = {"params": params_from_jax(_flatten(jp["params"]), "cpu"), "rng": np.asarray(jp["rng"])}
    t_ckpt.save_pytree(str(tmp_path / "t"), tp, {"epoch": 2})
    j_ckpt.save_pytree(str(tmp_path / "j"), jp, {"epoch": 2})
    assert (tmp_path / "t.meta.json").read_text() == (tmp_path / "j.meta.json").read_text()
    back = _flatten(j_ckpt.load_pytree(str(tmp_path / "t"), jp))
    for k, v in _flatten(jp).items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), err_msg=k)


@pytest.fixture(scope="module")
def ckpt_trainers(tmp_path_factory):
    """A JAX and a port trainer of the dense rung (f32), two epochs."""
    d = tmp_path_factory.mktemp("ck")
    cfg = _rung("dense", "float32").override({"paths.checkpoint_dir": str(d),
                                              "train.epochs": 2})
    tcfg = TConfig.from_dict(cfg.to_dict())
    return (JTrainer(cfg, j_dataset.load(cfg)),
            TTrainer(tcfg, t_dataset.load(tcfg), device="cpu"), d)


def test_port_checkpoint_resumes_in_jax(ckpt_trainers):
    """The port's checkpoint loads into the JAX Trainer (params, moments,
    step, plateau, epoch, a uint32[2] rng) and JAX trains on from it."""
    jt, tt, d = ckpt_trainers
    tt.train_epoch(0)
    tt.epoch, tt.best_metric = 1, 0.25
    tt.plateau = t_optim.PlateauState(lr=5e-4, best=3.5, num_bad=1)
    path = str(d / "from_port")
    tt.save_checkpoint(path)
    jt.load_checkpoint(path)
    assert jt.rng.dtype == jnp.uint32 and jt.rng.shape == (2,)
    assert (jt.epoch, jt.best_metric, jt.plateau._asdict()) == (
        1, 0.25, {"lr": 5e-4, "best": 3.5, "num_bad": 1})
    assert int(jt.opt_state.step) == tt.opt_state.step > 0
    for k, v in _flatten(jt.params).items():
        np.testing.assert_array_equal(np.asarray(v), tree.flatten(tt.params)[k].numpy())
    for k, v in _flatten(jt.opt_state.nu).items():
        np.testing.assert_array_equal(np.asarray(v), tree.flatten(tt.opt_state.nu)[k].numpy())
    out = jt.fit(resume_from=path)
    assert len(out["history"]) == 1 and np.isfinite(out["history"][0]["loss"])
    assert int(jt.opt_state.step) > tt.opt_state.step


def test_jax_checkpoint_resumes_in_the_port(ckpt_trainers):
    jt, _, d = ckpt_trainers
    if int(jt.opt_state.step) == 0:
        jt.train_epoch(0)
    jt.epoch, jt.plateau = 1, j_optim.PlateauState(lr=2.5e-4, best=3.0, num_bad=2)
    path = str(d / "from_jax")
    jt.save_checkpoint(path)
    tcfg = TConfig.from_dict(jt.cfg.to_dict())
    tt = TTrainer(tcfg, t_dataset.load(tcfg), device="cpu")
    tt.load_checkpoint(path)
    assert (tt.epoch, tt.plateau) == (1, t_optim.PlateauState(2.5e-4, 3.0, 2))
    assert tt.opt_state.step == int(jt.opt_state.step) > 0
    for k, v in _flatten(jt.opt_state.mu).items():
        np.testing.assert_array_equal(tree.flatten(tt.opt_state.mu)[k].numpy(), np.asarray(v))
    for k, v in _flatten(jt.params).items():
        np.testing.assert_array_equal(tree.flatten(tt.params)[k].numpy(), np.asarray(v))
    before = tt.opt_state.step
    out = tt.fit()
    assert len(out["history"]) == 1 and np.isfinite(out["history"][0]["loss"])
    assert tt.opt_state.step > before


def test_train_cli_on_the_cpu_and_resume(tmp_path):
    """``python -m movie_recommendation_engine_tpu_torch train --device cpu``
    on the small config, then ``--resume`` from its ``last_model``."""
    over = {"data.source": "synthetic", "data.synthetic_num_movies": 200,
            "data.synthetic_num_users": 400, "data.synthetic_num_ratings": 8000,
            "features.feature_dim": 32, "model.hidden_dim": 64, "model.embed_dim": 32,
            "walk.num_walks": 20, "walk.num_neighbors": 8, "train.batch_size": 64,
            "train.num_negative_samples": 32, "train.max_pairs_per_epoch": 256,
            "paths.checkpoint_dir": str(tmp_path / "ck")}
    cmd = [sys.executable, "-m", "movie_recommendation_engine_tpu_torch", "train",
           "--device", "cpu"] + [f"--set={k}={v}" for k, v in over.items()]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    first = subprocess.run(cmd + ["--set=train.epochs=1"], env=env, cwd=tmp_path,
                           capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert '"event": "epoch"' in first.stdout and (tmp_path / "ck" / "last_model.npz").exists()
    again = subprocess.run(cmd + ["--set=train.epochs=2", "--resume"], env=env, cwd=tmp_path,
                           capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stderr
    assert '"event": "resume"' in again.stdout and '"epoch": 1' in again.stdout


def test_train_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from movie_recommendation_engine_tpu_torch.cli.main import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train", "--set=data.source=synthetic",
              f"--set=paths.checkpoint_dir={tmp_path}"])
