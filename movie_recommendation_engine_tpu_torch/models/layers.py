"""Standalone layer variants (functional).

Port of ``movie_recommendation_engine_tpu/models/layers.py``: the
reference's alternate layer zoo (``model/layers.py``, standalone there too):
a GraphConv block with Xavier init + BatchNorm + ReLU + L2-norm, plus the
three pooling layers, which share their math with ``models/aggregators.py``
and ``pinsage.importance_pool``.
"""

from __future__ import annotations

import torch

from .aggregators import mean_aggregate, weighted_aggregate
from .pinsage import importance_pool, l2_normalize, linear


def xavier_uniform(gen: torch.Generator, fan_in: int, fan_out: int, device=None) -> torch.Tensor:
    """[fan_in, fan_out] U(-b, b) with b = sqrt(6 / (fan_in + fan_out))
    (``nn.init.xavier_uniform_``), drawn from ``gen``."""
    device = gen.device if device is None else device
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand((fan_in, fan_out), generator=gen, device=device)
    return (2 * u - 1) * bound


def init_graph_conv_layer(gen: torch.Generator, in_dim: int, out_dim: int,
                          device=None) -> dict:
    """GraphConvLayer params: Xavier weights, zero biases, BatchNorm
    scale/bias (reference ``model/layers.py:17-42``)."""
    device = gen.device if device is None else device

    def lin(fan_in):
        return {"w": xavier_uniform(gen, fan_in, out_dim, device),
                "b": torch.zeros(out_dim, device=device)}

    return {"self": lin(in_dim), "neigh": lin(in_dim), "out": lin(2 * out_dim),
            "bn": {"scale": torch.ones(out_dim, device=device),
                   "bias": torch.zeros(out_dim, device=device)}}


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Batch-statistics normalization (biased variance, as ``jnp.var``);
    a batch of one row passes through, as the reference's layer applies
    BatchNorm1d only above one row."""
    if x.shape[0] <= 1:
        return x
    mean = x.mean(dim=0, keepdim=True)
    var = x.var(dim=0, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def graph_conv_layer(params: dict, x: torch.Tensor, neigh_x: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """lin_self(x) ‖ lin_neigh(neigh_x) -> lin_out -> BN -> ReLU -> L2-norm
    (reference ``model/layers.py:44-77``)."""
    h_self = linear(params["self"], x, dtype)
    h_neigh = linear(params["neigh"], neigh_x, dtype)
    out = linear(params["out"], torch.cat([h_self, h_neigh], dim=1), dtype)
    out = batch_norm(out, params["bn"]["scale"], params["bn"]["bias"])
    return l2_normalize(torch.relu(out))


def importance_pooling_layer(x, nbrs, weights, valid_limit=None, dtype=torch.float32):
    """ImportancePoolingLayer (reference ``model/layers.py:79-133``): masked
    importance pooling with renormalization."""
    return importance_pool(x, nbrs, weights, valid_limit, dtype)


def weighted_mean_pooling_layer(x, nbrs, weights=None, valid_limit=None,
                                dtype=torch.float32):
    """WeightedMeanPoolingLayer (reference ``model/layers.py:135-195``): the
    weighted sum when weights are given (the mean where they are all zero),
    the plain mean otherwise."""
    if weights is None:
        return mean_aggregate(x, nbrs, valid_limit, dtype)
    return weighted_aggregate(x, nbrs, weights, valid_limit, dtype)


def max_pooling_layer(x, nbrs, valid_limit=None, dtype=torch.float32):
    """MaxPoolingLayer (reference ``model/layers.py:197-237``): the
    elementwise max over valid neighbor rows (no MLP, unlike the max
    aggregator); 0 for a row with none."""
    n = x.shape[0]
    limit = n if valid_limit is None else min(valid_limit, n)
    valid = nbrs < limit
    feats = x.to(dtype)[nbrs.long().clamp(0, n - 1)]
    out = torch.amax(torch.where(valid[:, :, None], feats, -torch.inf), dim=1)
    return torch.where(torch.isfinite(out), out, 0.0)
