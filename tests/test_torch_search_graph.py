"""The serving searches as the card replays them (``core/graphs.SearchGraphs``),
held to the JAX package on the CPU.

JAX's server compiles one program per batch bucket and ``k`` before it takes
traffic; the port's server captures one CUDA graph per bucket and ``k``. No
capture runs here (the CPU runs every search eager, by rule), so these tests
hold what the graphs must not change to the JAX package, and the graph
cache's rules with the cache logic alone:

- the port's ``BatchingRecommender`` against JAX's on the same embeddings,
  requests submitted one at a time (the same batches): exact, LSH (JAX's
  hyperplanes injected, with and without rerank) and IVF (JAX's k-means
  initial rows injected); indices equal, scores within 1e-5;
- a bucket-padded batch answers its first n rows as JAX's jitted search of
  the n unpadded queries (``_l2_topk``, ``_hamming_topk`` and
  ``_exact_rerank``, ``_ivf_search``): indices equal, distances within 1e-5;
- which calls run eager (the CPU, the sharded indexes, ``graphed = False``,
  the first call under a key), which events drop the graphs (``build``, a
  moved or reshaped tensor the search reads), that a failed capture raises,
  and that a replay fills the static queries, returns copies and counts its
  capture's Hamming launches; the server's warm-up captures every bucket,
  and a large-exclusion ``search_k`` is captured at its second use.

``test_torch_search_graph_cuda.py`` holds graphed searches against eager
ones on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu import small_test_config as j_small_config
from movie_recommendation_engine_tpu.retrieval import exact as j_exact
from movie_recommendation_engine_tpu.retrieval import ivf as j_ivf
from movie_recommendation_engine_tpu.retrieval import lsh as j_lsh
from movie_recommendation_engine_tpu.retrieval.server import BatchingRecommender as JServer
from movie_recommendation_engine_tpu_torch import small_test_config as t_small_config
from movie_recommendation_engine_tpu_torch.core import graphs
from movie_recommendation_engine_tpu_torch.ops import hamming
from movie_recommendation_engine_tpu_torch.retrieval import bench, exact, ivf, lsh, server
from movie_recommendation_engine_tpu_torch.retrieval.sharded import (ShardedExactIndex,
                                                                     ShardedIVFIndex)
from movie_recommendation_engine_tpu_torch.retrieval.server import BatchingRecommender
from movie_recommendation_engine_tpu_torch.graph import dataset as t_dataset
from movie_recommendation_engine_tpu_torch.train.loop import make_trainer
from tests.test_torch_step_graph import HSTU


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _jax_init(seed: int, n: int, p: int) -> np.ndarray:
    """The initial rows JAX's ``kmeans`` draws with ``PRNGKey(seed)``."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, shape=(p,),
                                        replace=False))


# ---------------------------------------------------------------------------
# The server and padded searches against the JAX package
# ---------------------------------------------------------------------------

def _requests(n: int):
    """By item, by history and by vector; the last two histories overflow
    the exclusion headroom (a pow2 search_k, twice)."""
    rng = np.random.default_rng(11)
    out = []
    for r in range(10):
        if r % 3 == 0:
            out.append(("item", int(rng.integers(n)), 7))
        elif r % 3 == 1:
            out.append(("history", [int(x) for x in rng.choice(n, 4, replace=False)], 5))
        else:
            out.append(("vector", _unit_rows(rng, 1, 32)[0], 9))
    for _ in range(2):
        out.append(("history", [int(x) for x in rng.choice(n, 40, replace=False)], 10))
    return out


def _ask(srv, kind, arg, k):
    if kind == "item":
        return srv.recommend_by_item(arg, k=k)
    if kind == "history":
        return srv.recommend_by_history(arg, k=k)
    return srv.recommend_by_vector(arg, k=k)


@pytest.mark.parametrize("method", ["exact", "lsh", "lsh_rerank", "ivf"])
def test_server_matches_jax(method):
    emb = _unit_rows(np.random.default_rng(3), 200, 32)
    kw = dict(max_batch=8, max_wait_ms=1.0, max_k=20)
    ref = JServer(emb, method=method, cfg=j_small_config(), **kw)
    inject = {}
    if method.startswith("lsh"):
        inject["planes"] = np.asarray(ref.index.planes)
    if method == "ivf":
        inject["init_idx"] = _jax_init(0, 200, t_small_config().search.ivf_partitions)
    got = BatchingRecommender(emb, method=method, cfg=t_small_config(), device="cpu",
                              **kw, **inject)
    try:
        for kind, arg, k in _requests(200):
            a, b = _ask(got, kind, arg, k), _ask(ref, kind, arg, k)
            assert a["indices"] == b["indices"], (kind, arg)
            np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-5)
    finally:
        got.close()
        ref.close()


def _padded(q: np.ndarray) -> np.ndarray:
    """``q`` padded with zero rows to its server bucket, as ``_execute``
    pads a batch."""
    bucket = next(b for b in server._buckets(8) if b >= q.shape[0])
    out = np.zeros((bucket, q.shape[1]), np.float32)
    out[:q.shape[0]] = q
    return out


@pytest.mark.parametrize("form", ["exact", "lsh_popcount", "lsh_matmul", "lsh_rerank", "ivf"])
def test_a_padded_bucket_answers_as_jax_unpadded(form):
    rng = np.random.default_rng(5)
    emb, q, k = _unit_rows(rng, 300, 32), _unit_rows(rng, 5, 32), 12
    if form == "exact":
        ref_index = j_exact.ExactIndex(32)
        ref_index.build(jnp.asarray(emb))
        ref = j_exact._l2_topk(jnp.asarray(q), ref_index._emb, ref_index._sqnorm, k)
        index = exact.ExactIndex(32, device="cpu")
    elif form.startswith("lsh"):
        ref_index = j_lsh.LSHIndex(32, 64, 4, seed=0, use_pallas=False,
                                   hamming_impl="popcount")
        ref_index.build(jnp.asarray(emb))
        c = 40 if form == "lsh_rerank" else 0
        ref = j_lsh._hamming_topk(ref_index._signatures(jnp.asarray(q)), ref_index._sigs,
                                  max(c, k))
        if c:
            ref = j_lsh._exact_rerank(jnp.asarray(q), ref_index._emb, ref_index._sqnorm,
                                      ref[1], k)
        index = lsh.LSHIndex(32, 64, 4, rerank=c, planes=np.asarray(ref_index.planes),
                             device="cpu",
                             hamming_impl="matmul" if form == "lsh_matmul" else "popcount")
    else:
        ref_index = j_ivf.WeakANDIndex(32, num_partitions=10, nprobe=3, seed=2)
        ref_index.build(jnp.asarray(emb))
        ref = j_ivf._ivf_search(jnp.asarray(q), ref_index._emb, ref_index._norm2,
                                ref_index._centroids, ref_index._offsets, ref_index._perm,
                                nprobe=3, max_list=ref_index._max_list, k=k)
        index = ivf.WeakANDIndex(32, num_partitions=10, nprobe=3, device="cpu",
                                 init_idx=_jax_init(2, 300, 10))
    index.build(emb)
    d, i = index.search(_padded(q), k)
    assert d.shape == i.shape == (8, k)
    np.testing.assert_array_equal(i[:5].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(d[:5].float().numpy(), np.asarray(ref[0], np.float32),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# The graph cache's rules (no capture runs on the CPU)
# ---------------------------------------------------------------------------

class _FakeGraph:
    """Stands in for a captured graph: a replay writes ``fn`` of the static
    queries into the static outputs, as the real graph would."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs
        self.replays = 0

    def replay(self):
        self.replays += 1
        for o, r in zip(self.outputs, self.fn(self.inputs[0])):
            o.copy_(r)


def _fake_capture(cache, launches=(0, 0, 0, 0, 0)):
    """Replaces ``cache.capture`` with one that runs the search eager once
    and keeps a ``_FakeGraph`` of it that counts ``launches`` a replay."""
    def capture(key, fn, inputs, generator=None):
        static = tuple(x.clone() for x in inputs)
        out = fn(*static)
        g = graphs.Captured(_FakeGraph(fn, static, out), static, out, tuple(launches))
        cache.graphs[key] = g
        cache.events.append(dict(key=list(key)))
        return g
    cache.capture = capture


FORMS = {
    "exact": lambda: exact.ExactIndex(16, device="cpu"),
    "lsh_popcount": lambda: lsh.LSHIndex(16, 64, 4, device="cpu", hamming_impl="popcount"),
    "lsh_matmul": lambda: lsh.LSHIndex(16, 64, 4, rerank=20, device="cpu",
                                       hamming_impl="matmul"),
    "ivf": lambda: ivf.WeakANDIndex(16, num_partitions=6, nprobe=2, device="cpu"),
}


def _graphed_index(form: str):
    index = FORMS[form]()
    index.build(_unit_rows(np.random.default_rng(8), 120, 16))
    index.graphed = True            # the rules with the cache logic alone
    _fake_capture(index.graphs)
    return index


def test_cpu_and_sharded_indexes_run_eager():
    for make in FORMS.values():
        index = make()
        assert index.graphed is False                     # the CPU: eager by rule
        index.build(_unit_rows(np.random.default_rng(8), 120, 16))
        for _ in range(3):
            index.search(_unit_rows(np.random.default_rng(9), 4, 16), 5)
        assert not index.graphs.warm and not index.graphs.graphs
    assert ShardedExactIndex.graphed is False and ShardedIVFIndex.graphed is False
    assert bench.make_index("sharded_exact", 16, device="cpu").graphed is False


@pytest.mark.parametrize("form", sorted(FORMS))
def test_first_call_eager_then_capture_then_replay(form):
    index = _graphed_index(form)
    q = _unit_rows(np.random.default_rng(9), 4, 16)
    eager = FORMS[form]()
    eager.build(_unit_rows(np.random.default_rng(8), 120, 16))
    want = eager.search(q, 5)
    first = index.search(q, 5)
    assert len(index.graphs.warm) == 1 and not index.graphs.graphs
    key = next(iter(index.graphs.warm))
    assert key[:3] == (key[0], 4, 5)
    second = index.search(q, 5)                     # captures, then replays
    g = index.graphs.graphs[key]
    third = index.search(q + 0.5, 5)                # replays with new queries
    assert g.graph.replays == 2
    assert torch.equal(g.inputs[0], torch.as_tensor(q + 0.5))
    for got in (first, second):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    new = eager.search(q + 0.5, 5)
    assert all(torch.equal(a, b) for a, b in zip(third, new))
    # Copies: the next replay does not change what a search returned.
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(third, g.output))
    index.search(q, 5)
    assert all(torch.equal(a, b) for a, b in zip(third, new))


def test_each_key_has_its_own_graph():
    index = _graphed_index("lsh_popcount")
    q = _unit_rows(np.random.default_rng(9), 8, 16)
    for rows, k in ((8, 5), (4, 5), (8, 7)):
        index.search(q[:rows], k)
        index.search(q[:rows], k)
    assert sorted(key[1:3] for key in index.graphs.graphs) == [(4, 5), (8, 5), (8, 7)]
    index.rerank = 30                               # another form: another key
    index.search(q, 5)
    assert len(index.graphs.graphs) == 3 and len(index.graphs.warm) == 4


MOVES = [("exact", "_emb"), ("exact", "_sqnorm"), ("lsh_popcount", "_sigs"),
         ("lsh_popcount", "_planes_flat"), ("lsh_popcount", "_emb"), ("lsh_matmul", "_sigs_pm"),
         ("ivf", "_emb"), ("ivf", "_norm2"), ("ivf", "_centroids"), ("ivf", "_offsets"),
         ("ivf", "_perm")]


@pytest.mark.parametrize("form, name", MOVES + [(f, "build()") for f in sorted(FORMS)])
def test_build_and_moved_tensors_drop_the_graphs(form, name):
    index = _graphed_index(form)
    q = _unit_rows(np.random.default_rng(9), 4, 16)
    index.search(q, 5)
    index.search(q, 5)
    assert len(index.graphs.graphs) == 1
    if name == "build()":
        index.build(_unit_rows(np.random.default_rng(10), 120, 16))
        assert not index.graphs.graphs and not index.graphs.warm
    else:
        setattr(index, name, getattr(index, name).clone())    # what chip_smoke.py does
    out = index.search(q, 5)
    assert not index.graphs.graphs and len(index.graphs.warm) == 1   # eager again
    eager = FORMS[form]()
    eager.build(_unit_rows(np.random.default_rng(10 if name == "build()" else 8), 120, 16))
    assert all(torch.equal(a, b) for a, b in zip(out, eager.search(q, 5)))


def test_a_reshaped_tensor_at_the_same_address_drops_the_graphs():
    index = _graphed_index("exact")
    q = _unit_rows(np.random.default_rng(9), 4, 16)
    index.search(q, 5)
    index.search(q, 5)
    index._sqnorm = index._sqnorm[:100]             # same data_ptr, another shape
    index._emb = index._emb[:100]
    index.search(q, 5)
    assert not index.graphs.graphs


def test_graphed_false_keeps_an_index_eager():
    index = _graphed_index("ivf")
    index.graphed = False
    q = _unit_rows(np.random.default_rng(9), 4, 16)
    for _ in range(3):
        index.search(q, 5)
    assert not index.graphs.warm and not index.graphs.graphs


def test_a_failed_capture_raises_and_drops_the_graphs():
    index = exact.ExactIndex(16, device="cpu")
    index.build(_unit_rows(np.random.default_rng(8), 120, 16))
    index.graphed = True            # the real capture, which needs a card
    q = _unit_rows(np.random.default_rng(9), 4, 16)
    index.search(q, 5)
    with pytest.raises(RuntimeError, match=r"capturing the exact graph \('exact', 4, 5\)"):
        index.search(q, 5)
    assert not index.graphs.graphs and not index.graphs.warm


def test_a_replay_adds_its_capture_hamming_launches():
    index = _graphed_index("lsh_popcount")
    _fake_capture(index.graphs, launches=(0, 0, 0, 0, 1))
    q = _unit_rows(np.random.default_rng(9), 4, 16)
    index.search(q, 5)
    before = graphs.read_counts()
    for _ in range(3):
        index.search(q, 5)                          # capture (counts nothing), 3 replays
    assert hamming.LAUNCHES == before[4] + 3
    assert graphs.read_counts()[:4] == before[:4]


def test_queries_reach_the_device_as_f32():
    cpu = torch.device("cpu")
    q = np.arange(6, dtype=np.float64).reshape(2, 3)
    for src in (q, q.tolist(), torch.from_numpy(q)):
        got = graphs.queries_on(cpu, src)
        assert got.dtype == torch.float32 and torch.equal(got, torch.from_numpy(q).float())
    t = torch.ones(2, 3)
    assert graphs.queries_on(cpu, t) is t


def test_step_graphs_share_the_runner():
    """The trainers' step caches, their programs and every index's caches
    run through the one ``GraphCache.run`` and its one staleness check."""
    caches = []
    for cfg in (t_small_config(), t_small_config().override(HSTU)):
        tr = make_trainer(cfg, t_dataset.load(cfg), device="cpu")
        caches += [tr.graphs, tr.graphs.programs]
    for make in FORMS.values():
        index = make()
        caches += [index.graphs, getattr(index, "build_graphs", index.graphs)]
    for cache in caches:
        assert isinstance(cache, graphs.GraphCache)
        assert type(cache).run is graphs.GraphCache.run
        assert type(cache)._check is graphs.GraphCache._check
    assert {c.event for c in caches} == {"step_graph", "program_graph", "search_graph"}


# ---------------------------------------------------------------------------
# The server on graphed indexes (the cache logic alone)
# ---------------------------------------------------------------------------

@pytest.fixture
def graphed_server_index(monkeypatch):
    made = []

    def make_index(*a, **kw):
        index = bench.make_index(*a, **kw)
        index.graphed = True
        _fake_capture(index.graphs)
        made.append(index)
        return index
    monkeypatch.setattr(server, "make_index", make_index)
    return made


@pytest.mark.parametrize("method", ["exact", "lsh", "ivf"])
def test_server_captures_every_bucket_before_traffic(method, graphed_server_index):
    emb = _unit_rows(np.random.default_rng(3), 200, 32)
    srv = BatchingRecommender(emb, method=method, cfg=t_small_config(), max_batch=8,
                              max_wait_ms=1.0, max_k=20, device="cpu")
    index = graphed_server_index[0]
    try:
        keys = {key[1:3] for key in index.graphs.graphs}
        assert keys == {(b, srv._search_k) for b in (1, 2, 4, 8)}
        assert len(index.graphs.events) == 4
        assert {e["key"][0] for e in index.graphs.events} == {
            {"exact": "exact", "lsh": "lsh_popcount", "ivf": "ivf"}[method]}
        replays = sum(g.graph.replays for g in index.graphs.graphs.values())
        answers = [_ask(srv, kind, arg, k) for kind, arg, k in _requests(200)]
        assert sum(g.graph.replays for g in index.graphs.graphs.values()) > replays
        # The two large-exclusion batches: a pow2 search_k, eager first, then
        # captured at its second use.
        big = [key for key in index.graphs.graphs if key[2] != srv._search_k]
        assert [key[2] for key in big] == [64]
    finally:
        srv.close()
    eager = bench.make_index(method, 32, t_small_config(), device="cpu")
    eager.build(emb)
    for (kind, arg, k), got in zip(_requests(200), answers):
        if kind == "item":
            q, excl = emb[arg], [arg]
        elif kind == "history":
            q = emb[arg].mean(axis=0)
            q, excl = q / max(float(np.linalg.norm(q)), 1e-12), arg
        else:
            q, excl = arg, []
        need = k + len(excl)
        sk = srv._search_k if need <= srv._search_k else 64
        d, i = eager.search(q[None], sk)
        keep = [j for j in range(sk) if int(i[0, j]) not in excl and int(i[0, j]) >= 0][:k]
        assert got["indices"] == [int(i[0, j]) for j in keep]
        np.testing.assert_allclose(got["scores"], [-float(d[0, j]) for j in keep], atol=0)


def test_timed_search_warms_a_graphed_index_twice():
    calls = []

    class Index:
        graphed = True

        def search(self, q, k):
            calls.append(k)
            return torch.zeros(1, k), torch.zeros(1, k, dtype=torch.int64)
    bench._timed_search(Index(), None, 3, repeats=2)
    assert len(calls) == 4          # two warm-up calls (eager, capture), two timed
    Index.graphed = False
    calls.clear()
    bench._timed_search(Index(), None, 3, repeats=2)
    assert len(calls) == 3
