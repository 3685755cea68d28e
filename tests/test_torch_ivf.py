"""PyTorch port, the IVF (Weak AND) index and the feature k-means order
against the JAX package: ``retrieval/ivf.py`` (``kmeans``,
``pairwise_sq_dists``, ``balance_assignments``, ``WeakANDIndex``) and
``ops/block_sparse.cluster_permutation``.

JAX draws k-means' initial rows with ``jax.random.choice``; the tests draw
the same rows with JAX and pass them to the port as ``init_idx``. Inputs are
made with numpy from a seed; both packages run on the CPU. Tolerances:

- centroids 1e-5: the port sums a cluster's rows in a one-hot product, JAX
  in a scatter, so the f32 sums round differently; assignments equal on
  clustered data (no row near a boundary);
- ``pairwise_sq_dists`` and ``balance_assignments``: bitwise (the same numpy
  code);
- search: ids equal, distances 1e-5 (the same candidates, each distance
  from one f32 dot product in another order).
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
from movie_recommendation_engine_tpu.ops import block_sparse as j_bsp
from movie_recommendation_engine_tpu.retrieval import exact as j_exact
from movie_recommendation_engine_tpu.retrieval import ivf as j_ivf
from movie_recommendation_engine_tpu.train.trainer import Trainer as JTrainer
from movie_recommendation_engine_tpu_torch.config import Config as TConfig
from movie_recommendation_engine_tpu_torch.core.checkpoint import params_from_jax
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger as TLogger
from movie_recommendation_engine_tpu_torch.graph import dataset as t_dataset
from movie_recommendation_engine_tpu_torch.ops import block_sparse as t_bsp
from movie_recommendation_engine_tpu_torch.retrieval import exact as t_exact
from movie_recommendation_engine_tpu_torch.retrieval import ivf as t_ivf
from movie_recommendation_engine_tpu_torch.train.trainer import Trainer as TTrainer


def _jax_init(seed: int, n: int, p: int) -> np.ndarray:
    """The initial rows JAX's ``kmeans`` draws with ``PRNGKey(seed)``."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, shape=(p,),
                                        replace=False))


def _blobs(seed, n, d, blobs, spread=0.05):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((blobs, d)) * 4
    x = centers[rng.integers(0, blobs, n)] + spread * rng.standard_normal((n, d))
    return x.astype(np.float32)


@pytest.mark.parametrize("n,d,p,iters,blobs", [(400, 8, 6, 15, 6), (600, 16, 12, 5, 12),
                                               (300, 4, 20, 15, 20)])
def test_kmeans_matches_jax(n, d, p, iters, blobs):
    x = _blobs(n, n, d, blobs)
    jc, ja = j_ivf.kmeans(jnp.asarray(x), jax.random.PRNGKey(3), p, iters)
    tc, ta = t_ivf.kmeans(torch.from_numpy(x), p, iters, init_idx=_jax_init(3, n, p))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_kmeans_default_init_is_seeded():
    x = _blobs(0, 200, 8, 5)
    a = t_ivf.kmeans(torch.from_numpy(x), 7, seed=4)
    b = t_ivf.kmeans(torch.from_numpy(x), 7, seed=4)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    init = t_ivf.init_indices(200, 7, seed=4)
    assert init.unique().numel() == 7 and int(init.max()) < 200


def test_pairwise_sq_dists_bitwise():
    rng = np.random.default_rng(1)
    x, c = rng.standard_normal((50, 6)).astype(np.float32), rng.standard_normal((7, 6)).astype(np.float32)
    c[2] = x[3]                                   # cancellation: clamped at 0
    got, ref = t_ivf.pairwise_sq_dists(x, c), j_ivf.pairwise_sq_dists(x, c)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("seed,n,p,cap", [(4, 500, 10, 60),    # overflow spilled
                                          (6, 503, 10, 10),    # infeasible: raised to ceil(N/P)
                                          (2, 300, 5, 1000)])  # already under the cap
def test_balance_assignments_bitwise(seed, n, p, cap):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    cent = rng.standard_normal((p, 8)).astype(np.float32)
    assign = ((x[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1)
    got = t_ivf.balance_assignments(x, cent, assign, cap)
    ref = j_ivf.balance_assignments(x, cent, assign, cap)
    assert np.array_equal(got, ref)
    assert np.bincount(got, minlength=p).max() <= max(cap, -(-n // p))


# ---------------------------------------------------------------------------
# WeakANDIndex
# ---------------------------------------------------------------------------

def _skewed(seed=5, n=900, d=12):
    """A blob of 300 rows beside uniform ones, scaled into the unit ball as
    embeddings are: k-means leaves one list far above the mean, so
    balancing has work to do."""
    rng = np.random.default_rng(seed)
    blob = 0.3 * rng.standard_normal((300, d)) + 3.0
    rest = rng.standard_normal((n - 300, d)) * 2.0
    x = np.concatenate([blob, rest])
    x /= np.linalg.norm(x, axis=1).max()
    return x[rng.permutation(n)].astype(np.float32)


def _pair(x, **kw):
    p = kw.get("num_partitions", 100)
    j = j_ivf.WeakANDIndex(x.shape[1], seed=1, **kw)
    j.build(jnp.asarray(x))
    t = t_ivf.WeakANDIndex(x.shape[1], seed=1, device="cpu",
                           init_idx=_jax_init(1, x.shape[0], min(p, x.shape[0])), **kw)
    t.build(x)
    return j, t


CASES = {
    "balanced": dict(num_partitions=12, nprobe=4, balance_factor=1.5),
    "unbalanced": dict(num_partitions=12, nprobe=4, balance_factor=0.0),
    "candidates_factor": dict(num_partitions=12, nprobe=3, candidates_factor=2),
    "one_probe_short": dict(num_partitions=40, nprobe=1, balance_factor=1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_weak_and_index_matches_jax(case):
    x = _skewed()
    j, t = _pair(x, **CASES[case])
    for name in ("_perm", "_offsets"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t._max_list == j._max_list and t.ntotal == j.ntotal == x.shape[0]
    np.testing.assert_allclose(t._emb.numpy(), np.asarray(j._emb), atol=0)
    bf = CASES[case].get("balance_factor", 4.0)
    if bf:
        assert t._max_list <= int(np.ceil(bf * x.shape[0] / t.num_partitions))
    q = x[::37] + 0.001
    k = 50 if case == "one_probe_short" else 10   # k above one probe's list: padded
    jd, ji = map(np.asarray, j.search(jnp.asarray(q), k))
    td, ti = t.search(q, k)
    assert td.shape == ti.shape == (q.shape[0], k) and ti.dtype == torch.int64
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-5)
    if case == "one_probe_short":
        assert (ti.numpy() == -1).any() and np.isinf(td.numpy()[ti.numpy() == -1]).all()


def test_full_probe_equals_exact():
    """nprobe = partitions and the full list as budget scan every row."""
    x = _skewed(seed=7)
    _, t = _pair(x, num_partitions=10, nprobe=10)
    q = x[:40] + 0.002
    td, ti = t.search(q, 10)
    ex = t_exact.ExactIndex(x.shape[1], device="cpu")
    ex.build(x)
    ed, ei = ex.search(q, 10)
    np.testing.assert_array_equal(ti.numpy(), ei.numpy())
    np.testing.assert_allclose(td.numpy(), ed.numpy(), atol=1e-5)
    je = j_exact.ExactIndex(x.shape[1])
    je.build(jnp.asarray(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(je.search(jnp.asarray(q), 10)[1]))


# ---------------------------------------------------------------------------
# The feature order of the block rung
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,num_clusters", [(500, 8), (1024, 0), (90, 0)])
def test_cluster_permutation_matches_jax(n, num_clusters):
    x = _blobs(n + 1, n, 16, 8, spread=0.3)
    p = min(num_clusters or max(min(n // 256, 4096), 64), n)
    ref = j_bsp.cluster_permutation(x, num_clusters=num_clusters, seed=2)
    got = t_bsp.cluster_permutation(x, num_clusters=num_clusters, seed=2,
                                    init_idx=_jax_init(2, n, p))
    assert got.dtype == np.int32 and np.array_equal(got, ref)


def test_block_rung_feature_order_matches_jax(tmp_path, monkeypatch):
    """The trainer's ``block_pool_order="feature"`` takes JAX's node order
    (k-means from JAX's initial rows) and pools as JAX's block rung does."""
    cfg = small_test_config().override({
        "model.pool_impl": "block", "model.block_pool_order": "feature",
        "model.block_pool_block_size": 32, "model.block_pool_max_dropped_mass": 1.0,
        "train.compute_dtype": "float32", "paths.checkpoint_dir": str(tmp_path)})
    tcfg = TConfig.from_dict(cfg.to_dict())
    jt = JTrainer(cfg, j_dataset.load(cfg), JLogger(stream=io.StringIO()))
    jt.refresh_neighborhoods()
    n = int(jt.x_table.shape[0])
    p = min(max(min(n // 256, 4096), 64), n)
    monkeypatch.setattr(t_ivf, "init_indices", lambda *a, **k: _jax_init(cfg.train.seed, n, p))
    tt = TTrainer(tcfg, t_dataset.load(tcfg), TLogger(stream=io.StringIO()), device="cpu")
    tt.params = params_from_jax(_flatten(jt.params), "cpu")
    tt.set_neighborhood_tables([(np.asarray(nb), np.asarray(w)) for nb, w in jt.nbr_tables])
    assert isinstance(tt.pool_mats[0], t_bsp.BlockPool)
    np.testing.assert_array_equal(tt._block_perm, jt._block_perm)
    np.testing.assert_allclose(tt.movie_embeddings().numpy(),
                               np.asarray(jt.movie_embeddings()), atol=1e-5)
