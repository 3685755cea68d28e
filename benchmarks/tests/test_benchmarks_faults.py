"""Runs of the harness with the timed path broken underneath (the look for
a card skipped, the rest of a run as it is): each fault a cell can have
makes ``correct`` come out false. On one device no exchange between chips
exists to leave out."""

import pytest

from . import tiny

ADAM_UNCHANGED = """
import movie_recommendation_engine_tpu_torch.train.optim as o
o.adam_update = lambda grads, state, params, lr, **kw: (params, state)
"""
HALF_BATCH = """
import movie_recommendation_engine_tpu_torch.models.losses as L
_nce = L.nce_loss
def half(q, p, pool, hard=None, temperature=0.1):
    h = q.shape[0] // 2
    return _nce(q[:h], p[:h], pool, None if hard is None else hard[:h], temperature)
L.nce_loss = half
"""
ANSWER_ALTERED = """
import torch
import movie_recommendation_engine_tpu_torch.retrieval.exact as E
_topk = E._l2_topk
def altered(q, emb, sqnorm, k):
    d, i = _topk(q, emb, sqnorm, k)
    return d, torch.roll(i, 1, dims=1)
E._l2_topk = altered
"""
STALE_TABLES = """
import movie_recommendation_engine_tpu_torch.train.trainer as T
_walk = T.Trainer.walk_tables
def stale(self):
    if getattr(self, "_kept", None) is None:
        self._kept = _walk(self)
    return self._kept
T.Trainer.walk_tables = stale
"""


@pytest.mark.parametrize("cell,patch,fails", [
    ("tiny-hub-train", ADAM_UNCHANGED, "change_gap"),
    ("tiny-hub-train", HALF_BATCH, "loss_gap"),
    ("tiny-dense-train", STALE_TABLES, "tables_mismatch"),
    ("tiny-serve", ANSWER_ALTERED, "rank_gap"),
])
def test_fault_makes_the_run_incorrect(checkout, cell, patch, fails):
    out = tiny.run_cell(checkout, cell, seed=21, seconds=0.5, patch=patch)
    assert out["correct"] is False
    c = out["checks"][fails]
    assert c["value"] > c["limit"], out["checks"]
