"""PyTorch port, PPR neighborhoods against the JAX package:
``sampling/ppr.py`` (``ppr_scores``, ``precompute_top_neighbors``,
``all_node_neighborhood_tables_ppr``) and ``walk.strategy="ppr"`` in the
trainer.

Inputs are made with numpy from a seed at small sizes; both packages run on
the CPU. Tolerances, each with its reason:

- scores rtol 1e-5 / atol 1e-7: JAX scatters one message per edge, the port
  sums each target's edges in one sparse product, so the f32 sums round
  differently;
- table ids equal at every position, except where the two ids' JAX scores
  lie within 1e-6 of each other (a near-tie that f32 rounding may order
  either way); weights 1e-6;
- embeddings of the slice (f32 compute, JAX's params carried across) 1e-5.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu import small_test_config
from movie_recommendation_engine_tpu.core.checkpoint import _flatten
from movie_recommendation_engine_tpu.core.logging import MetricsLogger as JLogger
from movie_recommendation_engine_tpu.graph import dataset as j_dataset
from movie_recommendation_engine_tpu.graph.csr import csr_from_edge_index as j_csr_from_edges
from movie_recommendation_engine_tpu.sampling import ppr as j_ppr
from movie_recommendation_engine_tpu.sampling import random_walk as j_rw
from movie_recommendation_engine_tpu.train.trainer import Trainer as JTrainer
from movie_recommendation_engine_tpu_torch.config import Config as TConfig
from movie_recommendation_engine_tpu_torch.core.checkpoint import params_from_jax
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger as TLogger
from movie_recommendation_engine_tpu_torch.graph import dataset as t_dataset
from movie_recommendation_engine_tpu_torch.graph.csr import csr_from_edge_index as t_csr_from_edges
from movie_recommendation_engine_tpu_torch.sampling import ppr as t_ppr
from movie_recommendation_engine_tpu_torch.sampling import random_walk as t_rw
from movie_recommendation_engine_tpu_torch.train.trainer import Trainer as TTrainer

SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-7
TIE, WEIGHT_ATOL = 1e-6, 1e-6


def _bipartite(seed=0, movies=30, users=45, ratings=400):
    """Movies 0..M-1, users M..M+U-1, each rating an edge both ways."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, movies, ratings)
    u = movies + rng.integers(0, users, ratings)
    r = rng.integers(1, 6, ratings).astype(np.float32)
    return np.stack([np.concatenate([m, u]), np.concatenate([u, m])]), np.tile(r, 2), \
        movies + users


def _star(leaves=150):
    """Every leaf -> hub (weight 1 + leaf % 3), the hub -> every third leaf:
    the hub's incoming edges span several push slices."""
    leaf = np.arange(1, leaves + 1)
    back = leaf[::3]
    edges = np.stack([np.r_[leaf, np.zeros_like(back)], np.r_[np.zeros_like(leaf), back]])
    return edges, np.r_[1.0 + leaf % 3, np.ones(back.shape[0])].astype(np.float32), leaves + 1


GRAPHS = {
    # 0 -> 1 (w 3), 0 -> 2 (w 1), 1 -> 0, 2 -> 0; node 3 -> 0 (w 2); 4 isolated.
    "weighted": (np.array([[0, 0, 1, 2, 3], [1, 2, 0, 0, 0]]),
                 np.array([3.0, 1.0, 1.0, 1.0, 2.0], np.float32), 5),
    "two_cycle": (np.array([[0, 1], [1, 0]]), None, 2),
    # 0 -> 1 -> 2 (a sink); 3 isolated.
    "chain_isolated": (np.array([[0, 1], [1, 2]]), np.ones(2, np.float32), 4),
    "bipartite": _bipartite(),
    "star": _star(),
}


def _graphs(name):
    edges, w, n = GRAPHS[name]
    j_csr = j_csr_from_edges(edges, w, num_nodes=n)
    t_csr = t_csr_from_edges(edges, w, num_nodes=n)
    return j_csr, j_rw.device_graph(j_csr), t_csr, t_rw.device_graph(t_csr, "cpu"), n


def _jax_scores(j_graph, sources, n, **kw):
    return np.array(j_ppr._ppr_scores_jit(j_graph, jnp.asarray(sources, jnp.int32), n, **kw))


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("iters", [1, 10, 30])
def test_ppr_scores_match_jax(name, iters):
    _, j_graph, _, t_graph, n = _graphs(name)
    sources = np.arange(n, dtype=np.int32)
    ref = _jax_scores(j_graph, sources, n, num_iterations=iters)
    got = t_ppr.ppr_scores(t_graph, torch.from_numpy(sources), n, num_iterations=iters)
    assert got.shape == (n, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    # Dangling residual is dropped, never carried: total mass <= 1.
    assert got.sum(dim=1).max().item() <= 1.0 + 1e-6


@pytest.mark.parametrize("name", ["star", "bipartite", "chain_isolated"])
def test_push_operator_is_the_normalized_transpose(name):
    """The slices hold P^T exactly: target t's slices list its sources
    ascending (ties: repeated edges) with weights w[s->t] / sum_u w[s->u];
    every row has a slice."""
    edges, w, n = GRAPHS[name]
    w = np.ones(edges.shape[1], np.float32) if w is None else w
    _, _, t_csr, t_graph, _ = _graphs(name)
    push = t_ppr.push_operator(t_graph)
    dense = np.zeros((n, n), np.float64)
    np.add.at(dense, (edges[1], edges[0]), w)            # [target, source]
    out_sum = dense.sum(axis=0)
    dense = np.divide(dense, out_sum[None, :], out=np.zeros_like(dense), where=out_sum > 0)
    nbrs, wts = push.nbrs.numpy(), push.weights.numpy()
    assert nbrs.shape[1] == t_ppr.SLICE and (push.slices.numpy() >= 1).all()
    row = np.repeat(np.arange(n), push.slices.numpy())
    got = np.zeros((n, n + 1), np.float64)
    np.add.at(got, (np.repeat(row, t_ppr.SLICE), nbrs.reshape(-1)), wts.reshape(-1))
    np.testing.assert_allclose(got[:, :n], dense, atol=1e-7)
    assert (got[:, n] == 0).all()
    for t in range(n):
        ids = nbrs[row == t].reshape(-1)
        ids = ids[ids < n]
        assert (np.diff(ids) >= 0).all()          # repeated edges stay apart
    if name == "star":
        assert push.slices[0] == -(-150 // t_ppr.SLICE) > 1


def test_ppr_dangling_rule():
    """An isolated source absorbs its teleport term once and keeps nothing
    else; a chain pours its mass into the sink without growing it."""
    _, _, _, t_graph, n = _graphs("chain_isolated")
    s = t_ppr.ppr_scores(t_graph, torch.tensor([0, 3]), n, num_iterations=20).numpy()
    np.testing.assert_allclose(s[1, 3], 0.15, atol=1e-6)
    assert s[1, [0, 1, 2]].max() == 0.0
    assert s[0, 0] > s[0, 1] > 0
    np.testing.assert_allclose(s[0], [0.15, 0.15 * 0.85, 0.15 * 0.85 ** 2, 0.0], atol=1e-6)


def _assert_ranked_equal(t_ids, t_w, j_ids, j_w, scores, sentinel):
    """Weights within WEIGHT_ATOL; ids equal at every position unless the two
    ids' JAX scores (row ``scores[r]``; the sentinel scores 0) lie within TIE."""
    t_ids, j_ids = np.asarray(t_ids), np.asarray(j_ids)
    np.testing.assert_allclose(np.asarray(t_w), np.asarray(j_w), atol=WEIGHT_ATOL)
    padded = np.concatenate([scores, np.zeros((scores.shape[0], 1), scores.dtype)], axis=1)
    for r, c in zip(*np.nonzero(t_ids != j_ids)):
        a, b = (min(int(x), sentinel) for x in (t_ids[r, c], j_ids[r, c]))
        assert abs(padded[r, a] - padded[r, b]) <= TIE, (r, c, t_ids[r], j_ids[r])


@pytest.mark.parametrize("name,num_neighbors,rows,restrict,batch", [
    ("weighted", 3, None, None, 2),          # tail chunk: 5 rows in batches of 2
    ("weighted", 8, None, None, 512),        # K above the node count: padded
    ("bipartite", 6, 30, 30, 7),             # movie rows, movie targets only
    ("bipartite", 10, None, None, 16),
    ("two_cycle", 4, 3, None, 2),            # rows past the last node repeat it
])
def test_neighborhood_tables_match_jax(name, num_neighbors, rows, restrict, batch):
    _, j_graph, _, t_graph, n = _graphs(name)
    kw = dict(num_nodes=rows, restrict_below=restrict, batch=batch)
    ref = j_ppr.all_node_neighborhood_tables_ppr(j_graph, 2, num_neighbors, **kw)
    got = t_ppr.all_node_neighborhood_tables_ppr(t_graph, 2, num_neighbors, **kw)
    assert len(got) == 2 and got[0][0] is got[1][0]
    nb, w = got[0]
    rows = rows or n
    assert nb.shape == w.shape == (rows, num_neighbors)
    assert nb.dtype == torch.int32 and w.dtype == torch.float32
    sources = np.minimum(np.arange(rows), n - 1)
    scores = _jax_scores(j_graph, sources, n)
    if restrict is not None:
        scores[:, restrict:] = 0.0
        assert (nb[nb < n] < restrict).all()
    _assert_ranked_equal(nb, w, ref[0][0], ref[0][1], scores, n)
    assert (w[nb == n] == 0).all()


@pytest.mark.parametrize("name,nodes,num_neighbors,batch", [
    ("bipartite", list(range(11)), 5, 8),          # tail chunk padded by its edge
    ("weighted", [0, 4, 3], 9, 2),                 # K above the node count
])
def test_precompute_top_neighbors_matches_jax(name, nodes, num_neighbors, batch):
    j_csr, j_graph, t_csr, t_graph, n = _graphs(name)
    ref = j_ppr.precompute_top_neighbors(j_csr, j_graph, np.array(nodes), num_neighbors,
                                         batch=batch)
    got = t_ppr.precompute_top_neighbors(t_csr, t_graph, np.array(nodes), num_neighbors,
                                         batch=batch)
    assert sorted(got) == sorted(ref)
    scores = _jax_scores(j_graph, np.array(sorted(ref)), n)
    for row, node in enumerate(sorted(ref)):
        (ti, tw), (ji, jw) = got[node], ref[node]
        assert len(ti) == len(ji)
        _assert_ranked_equal([ti], [tw], [ji], [jw], scores[row:row + 1], n)


# ---------------------------------------------------------------------------
# The slice: walk.strategy="ppr" through both trainers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    d = tmp_path_factory.mktemp("ppr")
    cfg = small_test_config().override({
        "walk.strategy": "ppr", "train.compute_dtype": "float32", "train.epochs": 2,
        "paths.checkpoint_dir": str(d), "paths.output_dir": str(d)})
    tcfg = TConfig.from_dict(cfg.to_dict())
    jt = JTrainer(cfg, j_dataset.load(cfg), JLogger(stream=io.StringIO()))
    tt = TTrainer(tcfg, t_dataset.load(tcfg), TLogger(stream=io.StringIO()), device="cpu")
    jt.refresh_neighborhoods()
    tt.refresh_neighborhoods()
    return jt, tt


def test_trainer_builds_jax_tables(trainers):
    """No draws injected: PPR draws none."""
    jt, tt = trainers
    n = tt.graph.num_nodes
    restrict = tt.data.num_movies
    sources = np.minimum(np.arange(tt.table_rows), n - 1)
    scores = _jax_scores(jt.graph, sources, n)
    scores[:, restrict:] = 0.0
    for (nb, w), (jnb, jw) in zip(tt.nbr_tables, jt.nbr_tables):
        assert nb.shape == (tt.table_rows, tt.cfg.walk.num_neighbors)
        _assert_ranked_equal(nb, w, jnb, jw, scores, n)


def test_trainer_embeddings_match_jax(trainers):
    jt, tt = trainers
    tt.params = params_from_jax(_flatten(jt.params), "cpu")
    np.testing.assert_allclose(tt.movie_embeddings().numpy(),
                               np.asarray(jt.movie_embeddings()), atol=1e-5)


def test_fit_builds_tables_once(tmp_path):
    cfg = TConfig.from_dict(small_test_config().to_dict()).override({
        "walk.strategy": "ppr", "train.epochs": 2, "paths.checkpoint_dir": str(tmp_path)})
    tr = TTrainer(cfg, t_dataset.load(cfg), TLogger(stream=io.StringIO()), device="cpu")
    out = tr.fit()
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    builds = [e for e in tr.log.history if e["event"] == "ppr_tables"]
    assert len(builds) == 1 and builds[0]["rows"] == tr.table_rows
    # A later refresh keeps the tables and their operators.
    tables, mats = tr.nbr_tables, tr.pool_mats
    tr.refresh_neighborhoods()
    assert tr.nbr_tables is tables and tr.pool_mats is mats


def test_unknown_strategy_raises():
    cfg = TConfig.from_dict(small_test_config().to_dict()).override(
        {"walk.strategy": "bogus"})
    tr = TTrainer(cfg, t_dataset.load(cfg), TLogger(stream=io.StringIO()), device="cpu")
    with pytest.raises(ValueError, match="walk.strategy"):
        tr.refresh_neighborhoods()
