"""DLRM-DCNv2's table gradient and step on the card (``ops/pool.compact_rows``
/ ``compact_grad``, ``train/click_trainer.py``): the compact route against
its plain version and against the dense segment route at the shape of
MLPerf's 100-id feature (a 5,000,000-row slice, B = 8,192), the card's
chunk plan against ``segment_plan_plain``, and the graphed step against its
eager twin, bit for bit.

Needs no JAX, so it runs on the card machine (``-m cuda --noconftest``);
every test is marked ``cuda`` and skips without a card.
"""

from __future__ import annotations

import io
import os

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch import small_test_config
from movie_recommendation_engine_tpu_torch.core import tree
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
from movie_recommendation_engine_tpu_torch.graph import criteo, dataset
from movie_recommendation_engine_tpu_torch.ops import pool
from movie_recommendation_engine_tpu_torch.train.click_trainer import ClickTrainer


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _bag_ids(n: int, b: int, k: int, seed: int, device) -> torch.Tensor:
    """[b, k] int32: a Zipf(1.05) first id over a permutation of ``n`` rows
    and k - 1 uniform ones, as the benchmark's traffic draws them."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(b, generator=g, device=device, dtype=torch.float64)
    s = 1.05
    rank = ((1 - u * (1 - (n + 1.0) ** (1 - s))) ** (1 / (1 - s))).long().clamp(1, n) - 1
    perm = torch.randperm(n, generator=g, device=device)
    rest = torch.randint(0, n, (b, k - 1), generator=g, device=device)
    return torch.cat([perm[rank][:, None], rest], 1).to(torch.int32).contiguous()


@pytest.mark.cuda
def test_compact_route_at_the_100_id_feature(cuda):
    n, b, k, d = 5_000_000, 8192, 100, 128
    ids = _bag_ids(n, b, k, 7, cuda)
    ones = torch.ones((b, k), device=cuda)
    g = torch.randn((b, d), generator=torch.Generator(device=cuda).manual_seed(8), device=cuda)
    c = pool.compact_rows(ids, spare=n)
    got = pool.compact_grad(g, ids, ones, c)
    torch.cuda.synchronize()
    assert got.shape == (b * k, d)
    uniq = torch.unique(ids.long())
    u = int(c.count)
    assert u == uniq.numel()
    assert torch.equal(c.rows[:u], uniq) and bool((c.rows[u:] == n).all())
    # The plain version of the same passes, on the card's own layout.
    like = torch.zeros((), device=cuda).expand(b * k, d)
    plain = pool.gather_pool_bwd_segment_plain(like, ids, ones, b * k, g, c.layout)
    assert torch.equal(got, plain)
    # The layout the CPU builds is the card's.
    cpu = pool.compact_rows(ids.cpu(), spare=n)
    cc, ss = int(c.layout.totals[0]), int(c.layout.totals[1])
    assert torch.equal(cpu.layout.totals, c.layout.totals.cpu())
    assert torch.equal(cpu.layout.slots, c.layout.slots.cpu())
    assert torch.equal(cpu.layout.chunks[:cc], c.layout.chunks[:cc].cpu())
    assert torch.equal(cpu.layout.splits[:ss], c.layout.splits[:ss].cpu())
    # The dense segment route's touched rows, bit for bit.
    table = torch.zeros((n + 1, d), device=cuda)
    dense, _ = pool.gather_pool_bwd(table, ids, ones, n, g, need_weights=False)
    assert torch.equal(got[:u], dense[uniq])
    assert not bool(got[u:].any())
    # Repeats bit for bit.
    assert torch.equal(pool.compact_grad(g, ids, ones, pool.compact_rows(ids, spare=n)), got)


@pytest.mark.cuda
@pytest.mark.parametrize("limit,slots", [(1, 40), (1000, 70_000), (1024, 3000), (5000, 200_000),
                                         (59_393, 600_000), (819_200, 819_200)])
def test_card_plan_equals_the_plain_plan(cuda, limit, slots):
    """The plan kernels, one block a tile, write ``segment_plan_plain``'s
    chunks, splits and totals, on skewed rows (some of many chunks) and
    empty ones, at one tile and at many, counting three launches."""
    g = torch.Generator(device=cuda).manual_seed(limit)
    ids = (torch.rand(slots, generator=g, device=cuda) ** 3 * limit).long().clamp(max=limit - 1)
    key = torch.sort(ids).values.to(torch.int32)
    row_ptr = torch.searchsorted(key, torch.arange(limit + 1, dtype=torch.int32, device=cuda),
                                 out_int32=True)
    bounds = (32, limit + slots // 32, min(limit, slots // 33))
    before = pool.PLAN_LAUNCHES
    card = pool._segment_plan(row_ptr, *bounds)
    assert pool.PLAN_LAUNCHES == before + pool.PLAN_KERNELS == before + 3
    plain = pool.segment_plan_plain(row_ptr.cpu(), *bounds)
    assert torch.equal(card[2].cpu(), plain[2])
    c, s = int(plain[2][0]), int(plain[2][1])
    assert torch.equal(card[0][:c].cpu(), plain[0][:c])
    assert torch.equal(card[1][:s].cpu(), plain[1][:s])


BAGS, HELD = (3, 1, 100, 2, 1), (4000, 3, 50_000, 20, 1)


def _trainers(tmp_path, device):
    rng = np.random.default_rng(5)
    d = str(tmp_path / "criteo")
    for split, n in (("train", 3 * 512), ("val", 700)):
        dense = np.log1p(rng.lognormal(0.0, 1.0, (n, 13))).astype(np.float32)
        sparse = [rng.integers(0, r, (n, k)).astype(np.int32) for k, r in zip(BAGS, HELD)]
        criteo.write_split(d, split, dense, sparse, (rng.random(n) < 0.1).astype(np.float32))
    cfg = small_test_config().override({
        "model.arch": "dlrm_dcnv2", "data.source": "criteo", "data.data_dir": d,
        "model.embed_dim": 128, "model.dlrm_bag_sizes": list(BAGS),
        "model.dlrm_table_rows": list(HELD), "model.dlrm_bottom": [512, 256, 128],
        "model.dlrm_top": [1024, 256, 1], "model.dlrm_cross_layers": 3,
        "model.dlrm_cross_rank": 512, "train.batch_size": 512, "train.learning_rate": 0.004,
        "paths.checkpoint_dir": os.path.join(d, "ckpt")})
    data = dataset.load(cfg)
    out = []
    for graphed in (True, False):
        t = ClickTrainer(cfg, data, MetricsLogger(io.StringIO()), device=device)
        t.graphed = graphed
        out.append(t)
    return out


def _state(t: ClickTrainer) -> dict:
    return {**{f"params/{k}": v for k, v in tree.flatten(t.params).items()},
            **{f"opt/{k}": v for k, v in tree.flatten(t.opt_state._asdict()).items()}}


@pytest.mark.cuda
def test_graphed_steps_equal_eager_steps_bitwise(cuda, tmp_path):
    """Three steps (the first eager, the second captured, the third a
    replay) against three eager steps from the same state."""
    graphed, eager = _trainers(tmp_path, cuda)
    a, b = graphed.train_epoch(0), eager.train_epoch(0)
    assert a["steps"] == 3 and a["loss"] == b["loss"]
    assert (a["lookups"], a["unique_rows"]) == (b["lookups"], b["unique_rows"])
    assert [e["key"][0] for e in graphed.graphs.events] == ["click_step"]
    sa, sb = _state(graphed), _state(eager)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for _ in range(2):                 # eager, then captured
        va = graphed.validate()
    assert va == eager.validate()
    assert torch.equal(graphed.split_logits("val"), eager.split_logits("val"))


@pytest.mark.cuda
def test_a_graphed_epoch_repeats_bitwise(cuda, tmp_path):
    first, second = _trainers(tmp_path, cuda)
    second.graphed = True
    assert first.train_epoch(0)["loss"] == second.train_epoch(0)["loss"]
    assert first.train_epoch(1)["loss"] == second.train_epoch(1)["loss"]
    sa, sb = _state(first), _state(second)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
