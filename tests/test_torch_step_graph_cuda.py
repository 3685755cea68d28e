"""Graphed steps against eager steps on the card (``train/loop.py``).

Needs no JAX, so it runs on the card machine (``-m cuda --noconftest``);
every test is marked ``cuda`` and skips without a card. A graphed trainer
and an eager twin (``graphed = False``) start from one state: params, Adam
state, tables, operators, layouts and generator seed. Both run the blocks
of epochs 0 and 1 (0, then 1 hard negative: two step graphs), with the
checkpoint's reseed before each epoch. The two must agree bit for bit in
params, Adam state, losses and the generator's state, count the same kernel
launches (the graphed trainer's by its replays), and embed alike.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch import small_test_config
from movie_recommendation_engine_tpu_torch.core import graphs, tree
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
from movie_recommendation_engine_tpu_torch.graph import dataset
from movie_recommendation_engine_tpu_torch.train import optim
from movie_recommendation_engine_tpu_torch.train.trainer import Trainer

RUNGS = {"gather": {"model.pool_impl": "gather", "model.gather_impl": "pallas"},
         "dense": {},
         "hubf": {"model.pool_impl": "hub", "model.hub_pool_final_layer": True,
                  "model.gather_impl": "pallas"}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _state(t: Trainer) -> dict:
    out = {f"params/{k}": v for k, v in tree.flatten(t.params).items()}
    for name in ("mu", "nu"):
        out.update({f"{name}/{k}": v
                    for k, v in tree.flatten(getattr(t.opt_state, name)).items()})
    out["step"] = t.opt_state.step
    return out


def _twins(cfg, device) -> tuple[Trainer, Trainer]:
    data = dataset.load(cfg)
    graphed = Trainer(cfg, data, logger=MetricsLogger(io.StringIO()), device=device)
    graphed.refresh_neighborhoods()
    eager = Trainer(cfg, data, logger=MetricsLogger(io.StringIO()), device=device)
    eager.graphed = False
    eager.set_neighborhood_tables(graphed.nbr_tables)
    assert graphs.copy_into((eager.pool_mats, eager.bwd_layouts),
                                (graphed.pool_mats, graphed.bwd_layouts))
    eager.params = tree.map_tree(torch.clone, graphed.params)
    eager.opt_state = optim.AdamState(graphed.opt_state.step.clone(),
                                      tree.map_tree(torch.clone, graphed.opt_state.mu),
                                      tree.map_tree(torch.clone, graphed.opt_state.nu))
    return graphed, eager


def _epochs(t: Trainer) -> tuple[torch.Tensor, tuple]:
    before = graphs.read_counts()
    losses = []
    for e in (0, 1):
        t._rng_words()
        q_all, p_all, block, _, num_hard = t.epoch_batches(e)
        for s0 in range(0, q_all.shape[0], block):
            losses.append(t.train_steps(q_all[s0:s0 + block], p_all[s0:s0 + block], 1e-3,
                                        float(e), num_hard))
    torch.cuda.synchronize()
    return torch.cat(losses), tuple(a - b for a, b in zip(graphs.read_counts(), before))


@pytest.mark.cuda
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_graphed_steps_equal_eager_steps_bitwise(cuda, rung):
    cfg = small_test_config().override(RUNGS[rung])
    graphed, eager = _twins(cfg, cuda)
    for t in (graphed, eager):
        t._reseed(np.array([7, 8], np.uint32))
    (loss_g, count_g), (loss_e, count_e) = _epochs(graphed), _epochs(eager)
    assert torch.equal(_bits(loss_g), _bits(loss_e))
    sg, se = _state(graphed), _state(eager)
    for k in sg:
        assert torch.equal(_bits(sg[k]), _bits(se[k])), k
    assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())
    assert len({k for k in graphed.graphs.graphs if k[0] == "step"}) == 2
    # Replays count as launches: the same counts as the eager steps.
    assert count_g == count_e
    if rung != "dense":
        assert count_g[0] > 0 and count_g[2] > 0       # forward and segment backward


@pytest.mark.cuda
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_graphed_embedding_pass_equals_eager(cuda, rung):
    cfg = small_test_config().override(RUNGS[rung])
    graphed, eager = _twins(cfg, cuda)
    ref = eager.movie_embeddings()
    before = graphs.read_counts()
    outs = [graphed.movie_embeddings() for _ in range(3)]   # eager, capture + replay, replay
    counts = tuple(a - b for a, b in zip(graphs.read_counts(), before))
    assert any(k[0] == "embed" for k in graphed.graphs.graphs)
    for out in outs:
        assert torch.equal(_bits(out), _bits(ref))
    assert outs[1].data_ptr() != outs[2].data_ptr()           # each call's own copy
    if rung != "dense":
        assert counts[0] == 3 * 2                             # two layers' forwards a pass
