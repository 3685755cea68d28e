"""The dense rung's padded row stride on the card, at the ``pinsage-ml20m``
shape: N = 26,709 table rows (row stride 26,752), hidden width 256.

Needs no JAX, so it runs on the card machine (``-m cuda --noconftest``);
every test is marked ``cuda`` and skips without a card.

- The pooling products through the padded bf16 matrix
  (``pinsage.padded_pool_matrix``) against the same products through the
  [N, N] matrix (``build_pool_matrix``): layer 0's [N, N] @ [N, 256] and its
  gradient, and the last layer's gathered [B, N] rows @ [N, 256] and its
  gradient, B = 4,596 (the ``ml20m`` step's rows). The two run on different
  GEMM kernels, which sum the same f32 terms in other orders before the one
  rounding to bf16: within 2^-8 of the output's norm (bf16's own step is
  2^-8 of a value at most).
- A graphed dense step at that N against its eager twin, bit for bit.
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
from movie_recommendation_engine_tpu_torch.models import pinsage
from movie_recommendation_engine_tpu_torch.ops.hub_pool import take_rows
from movie_recommendation_engine_tpu_torch.train import optim
from movie_recommendation_engine_tpu_torch.train.trainer import Trainer

N, D, B, K = 26_709, 256, 4_596, 50
STRIDE = 26_752


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _tables(device, layers: int, seed: int = 0) -> list:
    """``layers`` walk-like tables [N, K]: distinct ids in each row, weights
    in (0, 1]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(layers):
        offs = torch.randperm(N, generator=gen, device=device)[:K]
        nbrs = ((torch.arange(N, device=device)[:, None] + offs[None, :]) % N).int()
        w = 1.0 - torch.rand((N, K), generator=gen, device=device)
        out.append((nbrs, w))
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.cuda
def test_padded_products_equal_the_unpadded_within_bf16_rounding(cuda):
    (nbrs, w), = _tables(cuda, 1)
    padded = pinsage.padded_pool_matrix(nbrs, w, num_cols=N)
    plain = pinsage.build_pool_matrix(nbrs, w, num_cols=N)
    assert padded.shape == (N, STRIDE) and padded.stride() == (STRIDE, 1)
    assert torch.equal(padded[:, :N], plain) and not padded[:, N:].any()
    del nbrs, w
    gen = torch.Generator(device=cuda).manual_seed(1)
    h = torch.randn((N, D), generator=gen, device=cuda).bfloat16()
    g = torch.randn((N, D), generator=gen, device=cuda).bfloat16()
    gb = torch.randn((B, D), generator=gen, device=cuda).bfloat16()
    idx = torch.randint(0, N, (B,), generator=gen, device=cuda)
    for rows, grad in ((lambda a: a, g), (lambda a: take_rows(a, idx), gb)):
        out = {}
        for name, a in (("padded", padded), ("plain", plain)):
            hh = h.clone().requires_grad_(True)
            y = pinsage._dense_pool(rows(a), hh, torch.bfloat16)
            y.backward(grad)
            out[name] = (y.detach(), hh.grad)
        torch.cuda.synchronize()
        assert _rel(out["padded"][0], out["plain"][0]) <= 2 ** -8
        assert _rel(out["padded"][1], out["plain"][1]) <= 2 ** -8


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
def test_graphed_dense_step_at_ml20m_rows_equals_eager_bitwise(cuda):
    """The small corpus's trainer on a table of N rows (its movies' pairs
    and negatives; every row pooled), hidden 256: a graphed trainer and an
    eager twin from one state run the same steps (eager, capture, replays)
    and agree bit for bit in losses, params and Adam state."""
    cfg = small_test_config().override({"model.hidden_dim": D, "model.embed_dim": 128})
    data = dataset.load(cfg)
    x = torch.randn((N, cfg.features.feature_dim),
                    generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    tables = _tables(cuda, cfg.model.num_layers, seed=3)
    twins = []
    for graphed in (True, False):
        t = Trainer(cfg, data, logger=MetricsLogger(io.StringIO()), device=cuda)
        t.graphed = graphed
        t.x_table, t.table_rows, t.valid_limit = x.clone(), N, N
        t.set_neighborhood_tables(tables)
        twins.append(t)
    g, e = twins
    assert [tuple(pm.shape) for pm in g.pool_mats] == [(N, STRIDE)] * 2
    assert graphs.copy_into(e.pool_mats, g.pool_mats)
    e.params = tree.map_tree(torch.clone, g.params)
    e.opt_state = optim.AdamState(g.opt_state.step.clone(),
                                  tree.map_tree(torch.clone, g.opt_state.mu),
                                  tree.map_tree(torch.clone, g.opt_state.nu))
    losses = []
    for t in twins:
        t._reseed(np.array([7, 8], np.uint32))
        q_all, p_all, _, _, _ = t.epoch_batches(1)
        losses.append(torch.cat([t.train_steps(q_all, p_all, 1e-3, 1.0, 1) for _ in range(2)]))
    torch.cuda.synchronize()
    assert any(k[0] == "step" for k in g.graphs.graphs)
    assert torch.equal(_bits(losses[0]), _bits(losses[1]))
    for k, v in tree.flatten(g.params).items():
        assert torch.equal(_bits(v), _bits(tree.flatten(e.params)[k])), k
    for name in ("mu", "nu"):
        sg, se = tree.flatten(getattr(g.opt_state, name)), tree.flatten(getattr(e.opt_state, name))
        for k in sg:
            assert torch.equal(_bits(sg[k]), _bits(se[k])), (name, k)
