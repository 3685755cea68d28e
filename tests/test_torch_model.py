"""PyTorch port, ``models/pinsage.py`` and ``core/checkpoint.params_from_jax``
against the JAX package, at ``small_test_config`` widths with JAX's params
and JAX-sampled neighborhood tables.

Tolerances: in float32 compute 2e-5 abs on the unit-norm embeddings (the two
frameworks sum in different orders); in bfloat16 compute 2e-2 abs and row
cosine >= 0.999, because bf16 rounds at different places in the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu.core.checkpoint import _flatten
from movie_recommendation_engine_tpu.models import pinsage as j_ps
from movie_recommendation_engine_tpu.sampling import random_walk as j_rw
from movie_recommendation_engine_tpu_torch.core.checkpoint import params_from_jax
from movie_recommendation_engine_tpu_torch.models import pinsage as t_ps

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, ref, dtype):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
        return
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)
    cos = (got * ref).sum(1) / np.maximum(
        np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1), 1e-12)
    nonzero = np.linalg.norm(ref, axis=1) > 0
    assert cos[nonzero].min() >= 0.999


@pytest.fixture(scope="module")
def setup(tiny_data):
    """JAX params, features and JAX-sampled per-layer tables on the tiny
    corpus (movies-only pooling, the default)."""
    cfg, data = tiny_data
    m = data.num_movies
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, cfg.features.feature_dim)).astype(np.float32)
    params = j_ps.init_params(jax.random.PRNGKey(1), cfg.features.feature_dim,
                              cfg.model.hidden_dim, cfg.model.embed_dim, 2)
    csr = data.build_bipartite_graph()
    tables = j_rw.all_node_neighborhood_tables(
        j_rw.device_graph(csr), jax.random.PRNGKey(2), 2, cfg.walk.num_walks,
        cfg.walk.walk_length, cfg.walk.num_neighbors, j_rw.search_iters(csr),
        num_nodes=m, restrict_below=m)
    tables = [(np.array(nb), np.array(w)) for nb, w in tables]
    return x, params, tables, m


def test_params_from_jax_carries_every_leaf():
    params = j_ps.init_params(jax.random.PRNGKey(0), 12, 16, 8, 3,
                              use_batch_norm=True)
    flat = _flatten(params)
    got = params_from_jax(flat, "cpu")
    assert len(got["convs"]) == 3
    for key, arr in flat.items():
        node = got
        for p in key.split("/"):
            node = node[int(p)] if isinstance(node, list) else node[p]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), arr)
    # The same leaves under a whole checkpoint's "params/" prefix, with the
    # optimizer state and rng beside them.
    ck = {f"params/{k}": v for k, v in flat.items()}
    ck.update({"opt/step": np.zeros(()), "rng": np.zeros(2, np.uint32)})
    again = params_from_jax(ck, "cpu")
    np.testing.assert_array_equal(again["convs"][2]["neigh"]["w"].numpy(),
                                  np.asarray(params["convs"][2]["neigh"]["w"]))


def test_init_params_shapes_and_distribution():
    gen = torch.Generator().manual_seed(0)
    p = t_ps.init_params(gen, 64, 256, 128, 2, device="cpu")
    ref = j_ps.init_params(jax.random.PRNGKey(0), 64, 256, 128, 2)
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, p, is_leaf=torch.is_tensor))
    w = p["convs"][0]["update"]["w"]
    assert w.shape == (512, 256)
    assert w.std().item() == pytest.approx((2 / 512) ** 0.5, rel=0.05)
    assert torch.count_nonzero(p["convs"][0]["update"]["b"]) == 0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_importance_pool_matches_jax(impl, dtype):
    """Masked and renormalized pooling; JAX's ``impl="pallas"`` runs its
    kernel in interpret mode here."""
    rng = np.random.default_rng(3)
    n, d, b, k = 40, 32, 6, 5
    table = rng.standard_normal((n, d)).astype(np.float32)
    nbrs = rng.integers(0, n + 4, (b, k)).astype(np.int32)   # ids >= 36 masked
    nbrs[0] = n + 3                                          # all masked: zero row
    w = rng.random((b, k)).astype(np.float32)
    jd, td = DTYPES[dtype]
    ref = j_ps.importance_pool(jnp.asarray(table), jnp.asarray(nbrs), jnp.asarray(w),
                               valid_limit=36, dtype=jd, impl=impl)
    got = t_ps.importance_pool(torch.from_numpy(table), torch.from_numpy(nbrs),
                               torch.from_numpy(w), valid_limit=36, dtype=td, impl=impl)
    assert got.dtype == td
    _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), dtype)
    assert not got[0].any()


@pytest.mark.parametrize("direct_above_rows", [8192, 0])
def test_build_pool_matrix_matches_jax(setup, direct_above_rows):
    """Both builds: f32 accumulate then cast, and the direct bf16 scatter.
    Values are bf16; one rounding step (2^-8 at 1.0) may differ because the
    normalizing sums add in another order."""
    _, _, tables, m = setup
    nb, w = tables[0]
    ref = j_ps.build_pool_matrix(jnp.asarray(nb), jnp.asarray(w), num_cols=m,
                                 valid_limit=m, direct_above_rows=direct_above_rows)
    got = t_ps.build_pool_matrix(torch.from_numpy(nb), torch.from_numpy(w), m,
                                 valid_limit=m, direct_above_rows=direct_above_rows)
    assert got.dtype == torch.bfloat16 and got.shape == (m, m)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=2**-8, rtol=0)


@pytest.mark.parametrize("form", ["gather_xla", "gather_pallas", "hybrid", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(setup, form, dtype):
    """``pooled_forward`` (gather; hybrid with one dense layer) and
    ``pooled_forward_dense`` with the same params, features and tables. The
    JAX side runs its XLA gather (the Pallas kernel computes the same sum —
    ``test_importance_pool_matches_jax``)."""
    x, params, tables, m = setup
    jd, td = DTYPES[dtype]
    tp = params_from_jax(_flatten(params), "cpu")
    nbrs = [nb for nb, _ in tables]
    ws = [w for _, w in tables]
    n_dense = {"gather_xla": 0, "gather_pallas": 0, "hybrid": 1, "dense": 2}[form]
    j_mats = [j_ps.build_pool_matrix(jnp.asarray(nb), jnp.asarray(w), m, m)
              for nb, w in tables[:n_dense]]
    t_mats = [t_ps.build_pool_matrix(torch.from_numpy(nb), torch.from_numpy(w), m, m)
              for nb, w in tables[:n_dense]]
    if form == "dense":
        ref = j_ps.pooled_forward_dense(params, jnp.asarray(x), j_mats, dtype=jd)
        got = t_ps.pooled_forward_dense(tp, torch.from_numpy(x), t_mats, dtype=td)
    else:
        ref = j_ps.pooled_forward(params, jnp.asarray(x),
                                  [jnp.asarray(a) for a in nbrs],
                                  [jnp.asarray(a) for a in ws], valid_limit=m,
                                  dtype=jd, pool_mats=tuple(j_mats), gather_impl="xla")
        got = t_ps.pooled_forward(tp, torch.from_numpy(x),
                                  [torch.from_numpy(a) for a in nbrs],
                                  [torch.from_numpy(a) for a in ws], valid_limit=m,
                                  dtype=td, pool_mats=tuple(t_mats),
                                  gather_impl="pallas" if form == "gather_pallas" else "xla")
    assert got.dtype == torch.float32 and got.shape == (m, params["output_proj"]["w"].shape[1])
    _close(got.numpy(), np.asarray(ref), dtype)


def test_mlp_forward_matches_jax(setup):
    x, params, _, _ = setup
    ref = j_ps.mlp_forward(params, jnp.asarray(x), jnp.float32)
    got = t_ps.mlp_forward(params_from_jax(_flatten(params), "cpu"),
                           torch.from_numpy(x), torch.float32)
    _close(got.numpy(), np.asarray(ref), "float32")
