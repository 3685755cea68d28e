"""The per-epoch programs as the card replays them (``core/graphs.GraphCache``),
held to the JAX package on the CPU.

JAX jits the neighbourhood refresh of each chunk (``_multilayer_neighborhoods``),
the validation ranks (``_ranks``, a scan over whole query chunks),
``recommend`` and k-means (a scan over its iterations). The port runs each
as one CUDA graph per static key on the card. No capture runs here (the CPU
runs every program eager, by rule), so these tests hold what the graphs must
not change to the JAX package, and the cache's rules with a stand-in graph:

- the refresh given JAX's uniforms (the seam, eager by rule) gives JAX's
  tables bit for bit, ragged last chunk and ``restrict_below`` included;
- ``_ranks`` padded to whole chunks equals the unpadded loop it replaced
  exactly, and JAX's ranks within the +-1 of the self-comparison rounding
  (``ROADMAP.md`` section 3: the gt's own similarity is an elementwise sum,
  the row it is compared with a matmul);
- ``recommend`` gives JAX's indices in JAX's tie order, scores within 1e-6
  (exact on tied rows whose products are exact);
- k-means from JAX's initial rows equals JAX's within 1e-5;
- which calls run eager (the CPU, the seams, a row-sharded graph, PPR,
  ``graphed=False``, the first call under a key), that the second captures
  and later ones replay, one graph per key, what drops a graph (a moved CSR,
  another generator, the trainer's ``graphs.drop()``), that a replay draws
  from the generator as an eager refresh would, and that a failed capture
  raises.

``test_torch_epoch_graph_cuda.py`` holds graphed programs against eager ones
on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu.evaluation import metrics as j_metrics
from movie_recommendation_engine_tpu.graph import csr as j_csr
from movie_recommendation_engine_tpu.retrieval import ivf as j_ivf
from movie_recommendation_engine_tpu.sampling import random_walk as j_rw
from movie_recommendation_engine_tpu_torch import api
from movie_recommendation_engine_tpu_torch import small_test_config as t_small_config
from movie_recommendation_engine_tpu_torch.core import graphs
from movie_recommendation_engine_tpu_torch.evaluation import metrics as t_metrics
from movie_recommendation_engine_tpu_torch.graph import csr as t_csr
from movie_recommendation_engine_tpu_torch.graph import dataset as t_dataset
from movie_recommendation_engine_tpu_torch.ops import pool as t_pool
from movie_recommendation_engine_tpu_torch.retrieval import ivf as t_ivf
from movie_recommendation_engine_tpu_torch.sampling import random_walk as t_rw
from movie_recommendation_engine_tpu_torch.sampling.sharded_walk import ShardedDeviceGraph
from movie_recommendation_engine_tpu_torch.train.trainer import Trainer as TTrainer


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def walk_graphs():
    """A weighted graph with isolated nodes (walks halt there)."""
    rng = np.random.default_rng(0)
    n, e = 60, 400
    src = rng.integers(0, n - 5, e)
    dst = rng.integers(0, n, e)
    w = rng.integers(1, 6, e).astype(np.float32)
    jc = j_csr.csr_from_edge_index(np.stack([src, dst]), w, num_nodes=n)
    tc = t_csr.csr_from_edge_index(np.stack([src, dst]), w, num_nodes=n)
    return jc, j_rw.device_graph(jc), t_rw.device_graph(tc, "cpu")


# ---------------------------------------------------------------------------
# The programs against the JAX package
# ---------------------------------------------------------------------------

def _jax_uniforms(key, rows: int, batch: int, layers: int, walks: int, length: int) -> list:
    """JAX's draws for ``all_node_neighborhood_tables``: a key per padded
    chunk, a key per layer (``_multilayer_neighborhoods``), a key per hop
    (``_random_walks_jit``), one uniform per walker; the port's ragged last
    chunk takes the first b * walks of them (its walkers come first)."""
    chunks = -(-rows // batch)
    out = []
    for c, ck in enumerate(jax.random.split(key, chunks)):
        b = min(batch, rows - c * batch)
        for lk in jax.random.split(ck, layers):
            u = np.stack([np.asarray(jax.random.uniform(hk, (batch * walks,)))
                          for hk in jax.random.split(lk, length)])
            out.append(torch.from_numpy(u[:, :b * walks]))
    return out


@pytest.mark.parametrize("rows,batch,layers,walks,length,k,restrict", [
    (60, 60, 2, 7, 3, 5, None),       # one chunk
    (60, 16, 2, 20, 2, 8, 20),        # a ragged last chunk, movies only
    (40, 16, 3, 5, 2, 12, 40),        # fewer rows than nodes (table rows)
    (60, 32, 1, 9, 4, 40, None),      # K wider than the visit buffer: padding
])
def test_refresh_given_jax_uniforms_equals_jax(walk_graphs, rows, batch, layers, walks,
                                               length, k, restrict):
    csr, jg, tg = walk_graphs
    iters = j_rw.search_iters(csr)
    key = jax.random.PRNGKey(rows + batch + k)
    ref = j_rw.all_node_neighborhood_tables(jg, key, layers, walks, length, k, iters,
                                            batch=batch, num_nodes=rows,
                                            restrict_below=restrict)
    cache = graphs.GraphCache(torch.device("cpu"))
    got = t_rw.all_node_neighborhood_tables(
        tg, layers, walks, length, k, iters, batch=batch, num_nodes=rows,
        restrict_below=restrict, graphs=cache, graphed=True,
        uniforms=_jax_uniforms(key, rows, batch, layers, walks, length))
    assert not cache.warm and not cache.graphs            # the seam: eager by rule
    assert len(got) == layers
    for (t_nb, t_w), (j_nb, j_w) in zip(got, ref):
        assert t_nb.dtype == torch.int32 and t_nb.shape == (rows, k)
        np.testing.assert_array_equal(t_nb.numpy(), np.asarray(j_nb))
        np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))


def _unpadded_ranks(emb, q, g, chunk):
    """The port's ranks before the padding: a loop with a ragged last chunk."""
    out = []
    for s in range(0, q.shape[0], chunk):
        qe = emb[q[s:s + chunk]]
        sims = qe @ emb.T
        gt_sim = (qe * emb[g[s:s + chunk]]).sum(dim=1)
        out.append(1 + (sims > gt_sim[:, None]).sum(dim=1))
    return torch.cat(out)


@pytest.mark.parametrize("q_rows,chunk", [(2500, 1024), (700, 256), (64, 1024)])
def test_padded_ranks_equal_unpadded_and_jax(q_rows, chunk):
    rng = np.random.default_rng(q_rows)
    emb = _unit_rows(rng, 400, 16)
    q = rng.integers(0, 400, q_rows)
    g = rng.integers(0, 400, q_rows)
    te, tq, tg = torch.from_numpy(emb), torch.from_numpy(q), torch.from_numpy(g)
    got = t_metrics._ranks(te, tq, tg, chunk=chunk)
    assert got.shape == (q_rows,) and got.dtype == torch.int64
    assert torch.equal(got, _unpadded_ranks(te, tq, tg, chunk))
    ref = np.asarray(j_metrics._ranks(jnp.asarray(emb), jnp.asarray(q, np.int32),
                                      jnp.asarray(g, np.int32), chunk=chunk))
    # The self-comparison rounding: a gt may count against itself in one
    # framework and not in the other.
    assert np.abs(got.numpy() - ref).max() <= 1


def test_evaluate_embeddings_graphed_equals_eager():
    rng = np.random.default_rng(1)
    emb = torch.from_numpy(_unit_rows(rng, 300, 16))
    pairs = rng.integers(0, 300, (1500, 2))
    pairs[:5, 0] = 300                                    # dropped: out of range
    want = t_metrics.evaluate_embeddings(emb, pairs, chunk=512)
    cache = _fake_cache()
    got = [t_metrics.evaluate_embeddings(emb, pairs, chunk=512, graphs=cache, graphed=True)
           for _ in range(3)]
    assert all(g == want for g in got) and want["num_pairs"] == 1495
    (key,) = cache.graphs
    assert key == ("ranks", 300, 16, 1536, 512) and cache.graphs[key].graph.replays == 2


def _tied_rows(seed):
    """Unit rows with entries in {-1/2, 0, 1/2}, duplicated: every product
    is exact in both frameworks, so equal rows score bitwise equal."""
    rng = np.random.default_rng(seed)
    base = np.zeros((12, 16), np.float32)
    for r in base:
        r[rng.choice(16, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    return base[rng.integers(0, 12, 90)]


@pytest.mark.parametrize("exclude", [True, False])
@pytest.mark.parametrize("rows", ["tied", "random"])
def test_recommend_graphed_matches_jax_tie_order(rows, exclude):
    rng = np.random.default_rng(4)
    emb = _tied_rows(2) if rows == "tied" else _unit_rows(rng, 90, 16)
    qi, k = np.array([0, 3, 7, 44, 89], np.int32), 15
    js, jidx = j_metrics.recommend(jnp.asarray(emb), jnp.asarray(qi), k=k,
                                   exclude_query=exclude)
    cache = _fake_cache()
    for _ in range(3):                       # eager, capture + replay, replay
        ts, tidx = t_metrics.recommend(torch.from_numpy(emb), torch.from_numpy(qi).long(), k=k,
                                       exclude_query=exclude, graphs=cache, graphed=True)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=0 if rows == "tied" else 1e-6)
    assert list(cache.graphs) == [("recommend", 90, 16, 5, k, exclude)]


def _jax_init(seed: int, n: int, p: int) -> np.ndarray:
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, shape=(p,),
                                        replace=False))


def _blobs(seed, n, d, blobs):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((blobs, d)) * 4
    return (centers[rng.integers(0, blobs, n)]
            + 0.05 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("n,d,p,iters", [(400, 8, 6, 15), (300, 4, 20, 15)])
def test_kmeans_from_jax_rows_matches_jax_and_graphed_matches_eager(n, d, p, iters):
    x = _blobs(n, n, d, p)
    jc, ja = j_ivf.kmeans(jnp.asarray(x), jax.random.PRNGKey(3), p, iters)
    cache = _fake_cache()
    tc, ta = t_ivf.kmeans(torch.from_numpy(x), p, iters, init_idx=_jax_init(3, n, p),
                          graphs=cache, graphed=True)
    assert not cache.warm                             # the seam: eager by rule
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    want = t_ivf.kmeans(torch.from_numpy(x), p, iters, seed=5)
    for _ in range(3):
        got = t_ivf.kmeans(torch.from_numpy(x), p, iters, seed=5, graphs=cache, graphed=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert list(cache.graphs) == [("kmeans", n, d, p, iters)]


# ---------------------------------------------------------------------------
# The cache's rules (a stand-in graph: no capture runs on the CPU)
# ---------------------------------------------------------------------------

class _FakeGraph:
    """Stands in for a captured graph: a replay writes ``fn`` of the static
    inputs into the static outputs, as the real graph would (drawing from
    the generator as its replay would)."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs
        self.replays = 0

    def replay(self):
        self.replays += 1
        for o, r in zip(graphs.tensors(self.outputs), graphs.tensors(self.fn(*self.inputs))):
            o.copy_(r)


def _fake_capture(cache, launches=(0, 0, 0, 0, 0)):
    """Replaces ``cache.capture`` with one that runs the program once on the
    static buffers (restoring the generator after it: a capture draws
    nothing) and keeps a ``_FakeGraph`` that counts ``launches`` a replay."""
    def capture(key, fn, inputs, generator=None):
        static = tuple(x.clone() for x in inputs)
        state = None if generator is None else generator.get_state()
        out = fn(*static)
        if state is not None:
            generator.set_state(state)
        g = graphs.Captured(_FakeGraph(fn, static, out), static, out, tuple(launches))
        cache.graphs[key] = g
        cache.events.append(dict(key=list(key)))
        return g
    cache.capture = capture
    return cache


def _fake_cache():
    return _fake_capture(graphs.GraphCache(torch.device("cpu")))


@pytest.fixture(scope="module")
def small_data():
    return t_dataset.load(t_small_config())


def _trainer(data, graphed: bool, **overrides) -> TTrainer:
    cfg = t_small_config().override(overrides)
    tr = TTrainer(cfg, data, device="cpu")
    if graphed:
        tr.graphed = True            # the rules with the cache logic alone
        _fake_capture(tr.graphs)
        _fake_capture(tr.graphs.programs)
    return tr


def _same_tables(a, b) -> bool:
    return all(torch.equal(x, y) for (xa, xb), (ya, yb) in zip(a, b)
               for x, y in ((xa, ya), (xb, yb)))


def test_programs_run_eager_on_the_cpu_by_rule(small_data):
    data = small_data
    tr = _trainer(data, graphed=False)
    assert tr.graphed is False
    pairs = np.random.default_rng(0).integers(0, data.num_movies, (50, 2))
    for _ in range(3):
        tr.refresh_neighborhoods()
        tr.evaluate(pairs)
    assert not tr.graphs.programs.warm and not tr.graphs.programs.graphs
    cache = graphs.GraphCache(torch.device("cpu"))
    emb = torch.from_numpy(_unit_rows(np.random.default_rng(0), 50, 8))
    t_metrics.recommend(emb, torch.tensor([1, 2]), k=3, graphs=cache)    # graphed=None: cuda only
    t_metrics._ranks(emb, torch.tensor([1, 2]), torch.tensor([3, 4]), graphs=cache)
    t_ivf.kmeans(emb, 4, graphs=cache)
    assert not cache.warm and not cache.graphs


def test_graphed_needs_a_cache():
    emb = torch.zeros(5, 2)
    with pytest.raises(ValueError, match="graphed=True needs graphs="):
        t_metrics.recommend(emb, torch.tensor([1]), k=2, graphed=True)


@pytest.mark.parametrize("rule", ["graphed_false", "sharded_graph"])
def test_the_refresh_runs_eager_by_rule(walk_graphs, monkeypatch, rule):
    _, _, tg = walk_graphs
    cache = _fake_cache()
    graph, graphed = tg, True
    if rule == "graphed_false":
        graphed = False
    else:
        # A row-sharded graph (under a mesh): its walks run collectives.
        graph = ShardedDeviceGraph(tg, 0, tg.num_nodes, None)
        monkeypatch.setattr(t_rw, "_tables", lambda g, layers, *a: (
            torch.zeros((layers, 60, 4), dtype=torch.int32), torch.zeros((layers, 60, 4))))
    for _ in range(3):
        t_rw.all_node_neighborhood_tables(graph, 2, 5, 2, 4, 3,
                                          generator=torch.Generator().manual_seed(0),
                                          graphs=cache, graphed=graphed)
    assert not cache.warm and not cache.graphs


def test_ppr_tables_are_not_graphed(small_data):
    tr = _trainer(small_data, graphed=True, **{"walk.strategy": "ppr"})
    for _ in range(3):
        tr.refresh_neighborhoods()
    assert not tr.graphs.programs.warm and not tr.graphs.programs.graphs


def test_the_refresh_eager_then_capture_then_replay_as_eager(small_data):
    """A graphed trainer and an eager twin from one seed: each refresh gives
    the same tables and leaves the generator in the same state; the first
    runs eager, the second captures and replays, the third replays."""
    g, e = _trainer(small_data, graphed=True), _trainer(small_data, graphed=False)
    assert g._dense_layers() == g.cfg.model.num_layers     # the dense rung
    for call in range(3):
        (tg, dg), (te, de) = g.walk_tables(), e.walk_tables()
        assert _same_tables(tg, te), call
        assert len(dg) == len(de) == 2 and all(torch.equal(a, b) for a, b in zip(dg, de))
        assert torch.equal(g.generator.get_state(), e.generator.get_state())
        cache = g.graphs.programs
        assert len(cache.warm) == 1
        (key,) = cache.warm
        cfg = g.cfg
        assert key == ("refresh", g.table_rows, 16384, cfg.model.num_layers, cfg.walk.num_walks,
                       cfg.walk.walk_length, cfg.walk.num_neighbors, g.n_iters,
                       g._count_below(), ("dense", 2))
        if call == 0:
            assert not cache.graphs
        else:
            captured = cache.graphs[key]
            assert captured.graph.replays == call
            # Copies: the next replay does not change what a refresh returned.
            assert tg[0][0].data_ptr() != captured.output[0].data_ptr()
    before = [(nb.clone(), w.clone()) for nb, w in tg]
    g.walk_tables()
    assert _same_tables(before, tg)


def test_the_dense_rung_builds_its_matrices_in_the_refresh(small_data):
    """On the dense rung the refresh program also builds the pool matrices,
    which ``set_neighborhood_tables`` takes as built; other rungs get
    none."""
    tr = _trainer(small_data, graphed=False)
    tables, dense = tr.walk_tables()
    tr.set_neighborhood_tables(tables, dense)
    assert all(a is b for a, b in zip(tr.pool_mats, dense))
    ref = _trainer(small_data, graphed=False)
    ref.set_neighborhood_tables(tables)
    assert all(torch.equal(a, b) for a, b in zip(tr.pool_mats, ref.pool_mats))
    gather = _trainer(small_data, graphed=False, **{"model.pool_impl": "gather"})
    assert gather._dense_layers() == 0 and gather.walk_tables()[1] is None
    hybrid = _trainer(small_data, graphed=False, **{"model.pool_impl": "hybrid"})
    assert hybrid._dense_layers() == 1 and len(hybrid.walk_tables()[1]) == 1


def test_a_graphed_refresh_reaches_the_trainer_as_eager(small_data):
    """``refresh_neighborhoods`` and validation through the programs
    (stand-in graphs) leave the tables, operators and metrics of an eager
    twin."""
    g, e = _trainer(small_data, graphed=True), _trainer(small_data, graphed=False)
    pairs = np.random.default_rng(0).integers(0, small_data.num_movies, (50, 2))
    for _ in range(3):
        for t in (g, e):
            t.refresh_neighborhoods()
        assert _same_tables(g.nbr_tables, e.nbr_tables)
        assert all(torch.equal(a, b) for a, b in zip(g.pool_mats, e.pool_mats))
        assert g.evaluate(pairs) == e.evaluate(pairs)
    keys = sorted(k[0] for k in g.graphs.programs.graphs)
    assert keys == ["ranks", "refresh"]


@pytest.mark.parametrize("event, dropped", [
    ("moved_csr", True), ("other_generator", True), ("graphs_drop", True),
    ("load_checkpoint", True), ("set_tables_new_shapes", False), ("reseed", False)])
def test_what_drops_the_refresh_graph(small_data, tmp_path, event, dropped):
    tr = _trainer(small_data, graphed=True, **{"model.pool_impl": "gather"})
    tr.walk_tables()
    tr.walk_tables()
    cache = tr.graphs.programs
    (key,) = cache.graphs
    if event == "moved_csr":
        tr.graph = t_rw.device_graph(tr.csr, "cpu")       # the CSR refreshed
    elif event == "other_generator":
        tr.generator = torch.Generator().manual_seed(9)
    elif event == "graphs_drop":
        tr.graphs.drop()
    elif event == "load_checkpoint":
        tr.save_checkpoint(str(tmp_path / "ck"))
        tr.load_checkpoint(str(tmp_path / "ck"))
    elif event == "set_tables_new_shapes":
        tr.set_neighborhood_tables([(nb[:, :4], w[:, :4]) for nb, w in tr.walk_tables()[0]])
    elif event == "reseed":
        tr._reseed(np.array([5, 6], np.uint32))
    want = _trainer(small_data, graphed=False, **{"model.pool_impl": "gather"})
    want.generator.set_state(tr.generator.get_state())
    got = tr.walk_tables()[0]
    assert (key not in cache.graphs) == dropped
    assert _same_tables(got, want.walk_tables()[0])


def test_one_graph_per_key():
    cache = _fake_cache()
    rng = np.random.default_rng(2)
    emb = torch.from_numpy(_unit_rows(rng, 120, 8))
    for q_rows, chunk in ((10, 64), (60, 64), (70, 64), (10, 32)):
        q = torch.from_numpy(rng.integers(0, 120, q_rows))
        for _ in range(2):
            t_metrics._ranks(emb, q, q.flip(0), chunk=chunk, graphs=cache, graphed=True)
    # 10 and 60 queries pad to one chunk of 64, 70 to two.
    assert sorted(cache.graphs) == [("ranks", 120, 8, 32, 32), ("ranks", 120, 8, 64, 64),
                                    ("ranks", 120, 8, 128, 64)]
    for k in (3, 5):
        for _ in range(2):
            t_metrics.recommend(emb, torch.tensor([1, 2]), k=k, graphs=cache, graphed=True)
    assert len([key for key in cache.graphs if key[0] == "recommend"]) == 2


def test_a_replay_adds_its_capture_launches():
    cache = _fake_capture(graphs.GraphCache(torch.device("cpu")), launches=(2, 0, 0, 0, 0))
    emb = torch.from_numpy(_unit_rows(np.random.default_rng(3), 40, 8))
    q = torch.tensor([0, 1, 2])
    t_metrics._ranks(emb, q, q, graphs=cache, graphed=True)
    before = graphs.read_counts()
    for _ in range(3):
        t_metrics._ranks(emb, q, q, graphs=cache, graphed=True)   # capture, 3 replays
    assert t_pool.LAUNCHES == before[0] + 6
    assert graphs.read_counts()[1:] == before[1:]


def test_a_failed_capture_raises_and_drops_the_graphs():
    cache = graphs.GraphCache(torch.device("cpu"))      # the real capture needs a card
    emb = torch.from_numpy(_unit_rows(np.random.default_rng(3), 40, 8))
    q = torch.tensor([0, 1, 2])
    t_metrics._ranks(emb, q, q, graphs=cache, graphed=True)
    with pytest.raises(RuntimeError, match=r"capturing the ranks graph \('ranks', 40, 8, 1024"):
        t_metrics._ranks(emb, q, q, graphs=cache, graphed=True)
    assert not cache.graphs and not cache.warm


def test_an_ivf_rebuild_replays_kmeans():
    rng = np.random.default_rng(6)
    x = _unit_rows(rng, 200, 16)
    index = t_ivf.WeakANDIndex(16, num_partitions=8, nprobe=3, device="cpu")
    eager = t_ivf.WeakANDIndex(16, num_partitions=8, nprobe=3, device="cpu")
    index.graphed = True
    _fake_capture(index.graphs)
    _fake_capture(index.build_graphs)
    q = _unit_rows(rng, 4, 16)
    for rebuild in range(3):
        emb = x + 0.01 * rebuild               # a re-embed of the same shape
        index.build(emb)
        eager.build(emb)
        for a, b in zip((index._centroids, index._perm, index._offsets),
                        (eager._centroids, eager._perm, eager._offsets)):
            assert torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(index.search(q, 5), eager.search(q, 5)))
    (key,) = index.build_graphs.graphs
    assert key == ("kmeans", 200, 16, 8, 15) and index.build_graphs.graphs[key].graph.replays == 2


def test_engine_recommend_on_the_device_path_equals_the_host_path():
    """``api.Engine.recommend``'s card path (``_recommend_on_device``, the
    graphed ``recommend``) run here on the CPU gives the host path's ids;
    scores within 1e-6 (GEMM against matvec rounding)."""
    cfg = t_small_config()
    eng = api.Engine(cfg, device="cpu")
    eng.embeddings()
    for qi, k in ((0, 7), (5, 3), (11, eng.data.num_movies + 4)):
        want = eng.recommend(movie_id=qi, k=k, by_index=True)
        got = eng._rows(*eng._recommend_on_device(qi, k), exclude={qi}, k=k)
        assert [r["movieId"] for r in got] == [r["movieId"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                   atol=1e-6)
        assert len(got) == min(k, eng.data.num_movies - 1)
