"""PyTorch port, ``sampling/random_walk.py`` against the JAX package.

Walks are held bit-equal given the same uniforms (the test reproduces JAX's
key schedule and feeds its draws to the port), and neighborhood tables
exactly equal given the same visit buffer, ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu.graph import csr as j_csr
from movie_recommendation_engine_tpu.sampling import random_walk as j_rw
from movie_recommendation_engine_tpu_torch.graph import csr as t_csr
from movie_recommendation_engine_tpu_torch.sampling import random_walk as t_rw


@pytest.fixture(scope="module")
def graphs():
    """A weighted graph with isolated nodes (walks halt there)."""
    rng = np.random.default_rng(0)
    n, e = 60, 400
    src = rng.integers(0, n - 5, e)           # nodes n-5..n-1 have no out-edges
    dst = rng.integers(0, n, e)
    w = rng.integers(1, 6, e).astype(np.float32)
    jc = j_csr.csr_from_edge_index(np.stack([src, dst]), w, num_nodes=n)
    tc = t_csr.csr_from_edge_index(np.stack([src, dst]), w, num_nodes=n)
    for f in ("indptr", "indices", "weights", "cumprob"):
        np.testing.assert_array_equal(getattr(jc, f), getattr(tc, f))
    return jc, j_rw.device_graph(jc), t_rw.device_graph(tc, "cpu")


def test_weighted_next_hop_bit_equal(graphs):
    csr, jg, tg = graphs
    rng = np.random.default_rng(1)
    cur = rng.integers(0, csr.num_nodes + 1, 500).astype(np.int32)  # + sentinel
    u = rng.random(500, dtype=np.float32)
    u[:5] = [0.0, 1.0 - 2**-24, 0.5, 1e-7, 0.999]
    iters = j_rw.search_iters(csr)
    assert iters == t_rw.search_iters(csr)
    j_nxt, j_has = j_rw._weighted_next_hop(jg, jnp.asarray(cur), jnp.asarray(u), iters)
    t_nxt, t_has = t_rw._weighted_next_hop(tg, torch.from_numpy(cur),
                                           torch.from_numpy(u), iters)
    np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(j_nxt))
    np.testing.assert_array_equal(t_has.numpy(), np.asarray(j_has))


@pytest.mark.parametrize("num_walks,walk_length", [(7, 3), (20, 2)])
def test_random_walks_bit_equal_given_jax_uniforms(graphs, num_walks, walk_length):
    csr, jg, tg = graphs
    starts = np.arange(csr.num_nodes, dtype=np.int32)
    key = jax.random.PRNGKey(5)
    iters = j_rw.search_iters(csr)
    visited = j_rw.random_walks(jg, jnp.asarray(starts), key, num_walks,
                                walk_length, iters)
    # JAX's schedule (random_walk._random_walks_jit): split the key per step,
    # one uniform per walker per step.
    bw = starts.shape[0] * num_walks
    u = np.stack([np.asarray(jax.random.uniform(k, (bw,)))
                  for k in jax.random.split(key, walk_length)])
    got = t_rw.random_walks(tg, torch.from_numpy(starts), num_walks,
                            walk_length, iters, uniforms=torch.from_numpy(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(visited))
    assert (got.numpy() == csr.num_nodes).any()   # some walks halted


@pytest.mark.parametrize("num_neighbors,restrict_below", [(5, None), (8, 12), (40, 20)])
def test_importance_neighborhoods_exact_with_ties(num_neighbors, restrict_below):
    """Ids from a small range make visit counts tie constantly; ``40`` is
    wider than the buffer (padding)."""
    rng = np.random.default_rng(num_neighbors)
    sentinel = 30
    visited = rng.integers(0, sentinel + 1, (50, 24)).astype(np.int32)
    visited[0] = sentinel                    # a row with no visits
    visited[1, :12] = visited[1, 12:]        # every count of a row equal
    j_nb, j_w = j_rw.importance_neighborhoods(jnp.asarray(visited), num_neighbors,
                                              sentinel, restrict_below)
    t_nb, t_w = t_rw.importance_neighborhoods(torch.from_numpy(visited),
                                              num_neighbors, sentinel, restrict_below)
    np.testing.assert_array_equal(t_nb.numpy(), np.asarray(j_nb))
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))


def test_all_node_tables_follow_the_graph(graphs):
    """Port-sampled tables: ids reachable in one or two hops, weights a
    distribution over the selected set, the sentinel at empty slots."""
    csr, _, tg = graphs
    gen = torch.Generator().manual_seed(0)
    iters = t_rw.search_iters(csr)
    tables = t_rw.all_node_neighborhood_tables(tg, 2, 10, 2, 6, iters,
                                               generator=gen, batch=16)
    adj = np.zeros((csr.num_nodes, csr.num_nodes), bool)
    for v in range(csr.num_nodes):
        adj[v, csr.neighbors(v)[0]] = True
    reach = adj | ((adj.astype(int) @ adj.astype(int)) > 0)
    assert len(tables) == 2
    for nb, w in tables:
        nb, w = nb.numpy(), w.numpy()
        assert nb.shape == w.shape == (csr.num_nodes, 6)
        for v in range(csr.num_nodes):
            ok = nb[v] < csr.num_nodes
            assert reach[v, nb[v][ok]].all()
            assert (w[v][~ok] == 0).all()
            if ok.any():
                assert w[v].sum() == pytest.approx(1.0, abs=1e-6)
