"""Graphed searches against eager searches on the card (``core/graphs.py``).

Needs no JAX, so it runs on the card machine (``-m cuda --noconftest``);
every test is marked ``cuda`` and skips without a card. Each index form
(exact; LSH popcount and ±1, each with and without rerank; IVF) is built
twice on one corpus, once with ``graphed = False``. At server batch buckets
the graphed index's first call (eager), second (capture, replay) and third
(replay) must equal the eager twin's bit for bit, the replay must not sync
the host, and replays must count the Hamming launches the eager calls make.
A graphed server must capture every bucket before traffic, log each
capture, and answer as its index does eagerly.
"""

from __future__ import annotations


import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch import small_test_config
from movie_recommendation_engine_tpu_torch.core import graphs
from movie_recommendation_engine_tpu_torch.ops import hamming
from movie_recommendation_engine_tpu_torch.retrieval import exact, ivf, lsh
from movie_recommendation_engine_tpu_torch.retrieval.server import BatchingRecommender

FORMS = {
    "exact": lambda dev: exact.ExactIndex(64, device=dev),
    "lsh": lambda dev: lsh.LSHIndex(64, device=dev, hamming_impl="popcount"),
    "lsh_rerank": lambda dev: lsh.LSHIndex(64, rerank=100, device=dev,
                                           hamming_impl="popcount"),
    "lsh_pm": lambda dev: lsh.LSHIndex(64, device=dev, hamming_impl="matmul"),
    "lsh_rerank_pm": lambda dev: lsh.LSHIndex(64, rerank=100, device=dev,
                                              hamming_impl="matmul"),
    "ivf": lambda dev: ivf.WeakANDIndex(64, num_partitions=30, nprobe=6, device=dev),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _twins(form, dev):
    emb = _unit_rows(np.random.default_rng(0), 3000, 64)
    graphed, eager = FORMS[form](dev), FORMS[form](dev)
    eager.graphed = False
    for index in (graphed, eager):
        index.build(emb)
    return graphed, eager


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 64])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_graphed_search_equals_eager_bitwise(cuda, form, rows):
    graphed, eager = _twins(form, cuda)
    assert graphed.graphed and not eager.graphed
    qs = [torch.as_tensor(_unit_rows(np.random.default_rng(s), rows, 64), device=cuda)
          for s in (1, 2, 3)]
    counts = []
    outs = {}
    for name, index in (("graphed", graphed), ("eager", eager)):
        before = graphs.read_counts()
        got = []
        for c, q in enumerate(qs):
            if c == 2:                      # the replay: no host sync
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got.append(index.search(q, 25))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                got.append(index.search(q, 25))
        torch.cuda.synchronize()
        counts.append(tuple(a - b for a, b in zip(graphs.read_counts(), before)))
        outs[name] = got
    assert len(graphed.graphs.graphs) == 1 and not eager.graphs.graphs
    for (gd, gi), (ed, ei) in zip(outs["graphed"], outs["eager"]):
        assert torch.equal(gi, ei) and torch.equal(_bits(gd), _bits(ed))
    assert counts[0] == counts[1]
    assert counts[0][4] == (3 if form in ("lsh", "lsh_rerank") else 0)
    event = graphed.graphs.events[0]
    assert event["kernels"] > 0 and event["key"][1] == rows
    if form in ("lsh", "lsh_rerank"):
        assert event["launches"] == {"hamming_distance": 1}


@pytest.mark.cuda
def test_host_queries_replay_without_a_sync(cuda):
    graphed, eager = _twins("lsh", cuda)
    q = _unit_rows(np.random.default_rng(4), 8, 64)
    graphed.search(q, 10)
    graphed.search(q, 10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d, i = graphed.search(q, 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ed, ei = eager.search(q, 10)
    assert torch.equal(i, ei) and torch.equal(d, ed)


@pytest.mark.cuda
def test_build_drops_the_graphs_on_the_card(cuda):
    graphed, eager = _twins("ivf", cuda)
    q = torch.as_tensor(_unit_rows(np.random.default_rng(5), 4, 64), device=cuda)
    graphed.search(q, 10)
    graphed.search(q, 10)
    emb = _unit_rows(np.random.default_rng(6), 2000, 64)
    graphed.build(emb)
    eager.build(emb)
    assert not graphed.graphs.graphs
    for _ in range(3):
        d, i = graphed.search(q, 10)
    ed, ei = eager.search(q, 10)
    assert torch.equal(i, ei) and torch.equal(_bits(d), _bits(ed))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["exact", "lsh", "ivf"])
def test_graphed_server_answers_as_its_index(cuda, method):
    emb = _unit_rows(np.random.default_rng(7), 2000, 64)
    srv = BatchingRecommender(emb, method=method, cfg=small_test_config(), max_batch=8,
                              max_wait_ms=1.0, max_k=20, device=cuda)
    try:
        index = srv.index
        assert {key[1:3] for key in index.graphs.graphs} == {(b, srv._search_k)
                                                              for b in (1, 2, 4, 8)}
        assert [e["key"][1:3] for e in index.graphs.events] == [[b, srv._search_k]
                                                                for b in (1, 2, 4, 8)]
        before = hamming.LAUNCHES
        answers = [srv.recommend_by_item(i, k=10) for i in range(6)]
        big = list(range(100, 160))                 # past the headroom: pow2 search_k
        answers += [srv.recommend_by_history(big, k=10) for _ in range(2)]
        if method == "lsh":
            assert hamming.LAUNCHES == before + 8
        assert any(key[2] == 128 for key in index.graphs.graphs)
    finally:
        srv.close()
    index.graphed = False
    for r, got in enumerate(answers):
        if r < 6:
            q, excl, sk = emb[r][None], [r], srv._search_k
        else:
            q = emb[big].mean(axis=0)
            q, excl, sk = (q / max(float(np.linalg.norm(q)), 1e-12))[None], big, 128
        d, i = (t.cpu().numpy()[0] for t in index.search(q, sk))
        keep = [j for j in range(sk) if i[j] not in excl and i[j] >= 0][:10]
        assert got["indices"] == [int(i[j]) for j in keep]
        assert got["scores"] == [float(-d[j]) for j in keep]
