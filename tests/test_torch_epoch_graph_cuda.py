"""Graphed per-epoch programs against eager ones on the card
(``core/graphs.GraphCache``).

Needs no JAX, so it runs on the card machine (``-m cuda --noconftest``);
every test is marked ``cuda`` and skips without a card. A graphed trainer
and an eager twin (``graphed = False``) from one seed on the 4k synthetic
corpus at the default width, on the gather rung with the CUDA kernels and on
the default dense rung (whose refresh graph builds the pool matrices too):
three refreshes (eager, capture + replay, replay) give bitwise equal tables,
operators and layouts and leave the generators in
one state, the last replay with no host sync; a 2-epoch ``fit`` (refresh,
step graphs, embedding graph, ranks graph each epoch) gives bitwise equal
params, tables and validation metrics and the same gather-pool launches.
``_ranks``, ``recommend`` and ``kmeans`` replay bitwise equal to eager, with
no host sync inside a replay.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch import default_config
from movie_recommendation_engine_tpu_torch.core import graphs, tree
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
from movie_recommendation_engine_tpu_torch.evaluation import metrics
from movie_recommendation_engine_tpu_torch.graph import dataset
from movie_recommendation_engine_tpu_torch.retrieval import ivf
from movie_recommendation_engine_tpu_torch.train.trainer import Trainer

RUNGS = {"gather": {"model.pool_impl": "gather", "model.gather_impl": "pallas"},
         "dense": {}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data4k():
    return dataset.load(default_config().override({"data.source": "synthetic"}))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _equal(a, b) -> bool:
    ta, tb = graphs.tensors(a), graphs.tensors(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and torch.equal(_bits(x), _bits(y)) for x, y in zip(ta, tb))


def _planned(layouts) -> list:
    """Each segment layout's planned part: the rows of ``chunks`` and
    ``splits`` past ``totals`` are unset memory."""
    out = []
    for lay in layouts or ():
        if lay is None:
            out.append(None)
            continue
        c, s, _ = lay.totals.tolist()
        out.append((lay.row_ptr, lay.slots, lay.chunks[:c], lay.splits[:s], lay.totals))
    return out


def _twins(rung: str, data, device, ckpt_dir=None) -> tuple[Trainer, Trainer]:
    over = {"data.source": "synthetic", **RUNGS[rung]}
    if ckpt_dir is not None:
        over["paths.checkpoint_dir"] = str(ckpt_dir)
    cfg = default_config().override(over)
    out = []
    for graphed in (True, False):
        t = Trainer(cfg, data, logger=MetricsLogger(io.StringIO()), device=device)
        t.graphed = graphed
        out.append(t)
    return tuple(out)


def _no_sync(fn):
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_graphed_refresh_equals_eager(cuda, data4k, rung):
    g, e = _twins(rung, data4k, cuda)
    for call in range(3):             # eager, capture + replay, replay
        tables, dense = _no_sync(g.walk_tables) if call == 2 else g.walk_tables()
        g.set_neighborhood_tables(tables, dense)
        e.refresh_neighborhoods()
        assert _equal(g.nbr_tables, e.nbr_tables), call
        assert _equal(g.pool_mats, e.pool_mats), call
        assert _equal(_planned(g.bwd_layouts), _planned(e.bwd_layouts)), call
        assert torch.equal(g.generator.get_state(), e.generator.get_state())
    assert [k[0] for k in g.graphs.programs.graphs] == ["refresh"]
    assert not e.graphs.programs.warm


@pytest.mark.cuda
def test_graphed_fit_equals_eager(cuda, data4k, tmp_path):
    g, e = _twins("gather", data4k, cuda, tmp_path)
    g.cfg.train.epochs = e.cfg.train.epochs = 2
    counts = []
    for t in (g, e):
        before = graphs.read_counts()
        hist = t.fit()["history"]
        counts.append(tuple(a - b for a, b in zip(graphs.read_counts(), before)))
        t.hist = [{k: v for k, v in h.items() if k.startswith("val_") and k != "val_seconds"}
                  for h in hist]
    assert g.hist == e.hist and "val_hit_rate@10" in g.hist[0]
    assert _equal(tree.flatten(g.params), tree.flatten(e.params))
    assert _equal(g.nbr_tables, e.nbr_tables)
    assert torch.equal(g.generator.get_state(), e.generator.get_state())
    assert counts[0] == counts[1] and counts[0][0] > 0 and counts[0][2] > 0
    assert {k[0] for k in g.graphs.programs.graphs} == {"refresh", "ranks"}


def _unit_rows(n, d, seed=0):
    x = torch.randn((n, d), generator=torch.Generator().manual_seed(seed))
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["ranks", "recommend", "kmeans"])
def test_graphed_programs_equal_eager(cuda, program):
    emb = _unit_rows(5000, 128).to(cuda)
    q = torch.randint(0, 5000, (3000,), generator=torch.Generator().manual_seed(1)).to(cuda)
    cache = graphs.GraphCache(cuda)
    if program == "ranks":
        def run(graphed):
            return metrics._ranks(emb, q, q.flip(0), graphs=cache, graphed=graphed)
    elif program == "recommend":
        def run(graphed):
            return metrics.recommend(emb, q[:64], k=10, graphs=cache, graphed=graphed)
    else:
        def run(graphed):
            return ivf.kmeans(emb, 100, 15, seed=3, graphs=cache, graphed=graphed)
    want = run(False)
    got = [run(True), run(True), _no_sync(lambda: run(True))]
    for out in got:
        assert _equal(out, want)
    (key,) = cache.graphs
    assert key[0] == program and len(cache.events) == 1
    assert cache.events[0]["kernels"] > 0


@pytest.mark.cuda
def test_an_ivf_rebuild_replays_kmeans(cuda):
    emb = _unit_rows(3000, 64)
    index, eager = (ivf.WeakANDIndex(64, num_partitions=30, nprobe=6, device=cuda)
                    for _ in range(2))
    eager.graphed = False
    for r in range(3):
        for i in (index, eager):
            i.build(emb + 0.01 * r)
        assert _equal((index._centroids, index._perm), (eager._centroids, eager._perm))
    assert len(index.build_graphs.graphs) == 1 and not eager.build_graphs.warm
    assert np.array_equal(index.search(emb[:8], 5)[1].cpu().numpy(),
                          eager.search(emb[:8], 5)[1].cpu().numpy())
