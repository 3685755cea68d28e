"""Neighborhood aggregators over fixed-shape [B, K] neighborhoods.

Port of ``movie_recommendation_engine_tpu/models/aggregators.py``, the
``model.aggregator_type`` knob: ``mean``, ``weighted``, ``attention``,
``max``, ``importance`` (the importance pooling of ``pinsage``, through the
gather-pool kernel with ``gather_impl="pallas"``) and
``importance_transform``. The others are plain PyTorch, as JAX's are XLA only.

Shared conventions: neighbor slots with id >= valid_limit are masked out;
rows with no valid neighbors aggregate to zero. As in JAX, the [B, K, D]
gather runs in ``dtype``; a weighted sum rounds its weights to ``dtype`` and
accumulates in f32 (JAX's ``preferred_element_type``), returning f32; the
max aggregators take ``torch.amax``, which splits the gradient among tied
maxima as JAX's ``max`` does.
"""

from __future__ import annotations

import torch

_EPS = 1e-12

KINDS = ("mean", "weighted", "attention", "max", "importance",
         "importance_transform")


def init_aggregator_params(gen: torch.Generator, kind: str, in_dim: int, out_dim: int,
                           style: str = "he_zero_bias", device=None):
    """Parameters of the parameterized aggregators (JAX's shapes and
    distributions, drawn from ``gen``); None for the others.

    - attention: a 2-layer MLP over [self || neighbor] (``attn1``, ``attn2``)
    - max: a per-neighbor MLP before the max (``mlp``)
    - importance_transform: a linear transform and LayerNorm
      (``transform``, ``ln_scale``, ``ln_bias``)
    """
    from .pinsage import _linear_init

    if kind not in KINDS:
        raise ValueError(f"unknown aggregator: {kind}")
    device = gen.device if device is None else device
    if kind == "attention":
        return {"attn1": _linear_init(gen, in_dim * 2, in_dim, style, device),
                "attn2": _linear_init(gen, in_dim, 1, style, device)}
    if kind == "max":
        return {"mlp": _linear_init(gen, in_dim, out_dim, style, device)}
    if kind == "importance_transform":
        return {"transform": _linear_init(gen, in_dim, out_dim, style, device),
                "ln_scale": torch.ones(out_dim, device=device),
                "ln_bias": torch.zeros(out_dim, device=device)}
    return None


def _mask_and_gather(h_table, nbrs, valid_limit, dtype):
    """([B, K, D] rows in ``dtype``, [B, K] valid mask); ids clamped into
    the table, as JAX's ``take(..., mode="clip")``."""
    n = h_table.shape[0]
    limit = n if valid_limit is None else min(valid_limit, n)
    valid = nbrs < limit
    feats = h_table.to(dtype)[nbrs.long().clamp(0, n - 1)]
    return feats, valid


def _weighted_sum(w: torch.Tensor, feats: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum("bk,bkd->bd", w.astype(dtype), feats,
    preferred_element_type=f32)``: [B, D] f32."""
    return torch.bmm(w.to(dtype).float().unsqueeze(1), feats.to(dtype).float()).squeeze(1)


def _uniform(valid: torch.Tensor) -> torch.Tensor:
    cnt = valid.sum(dim=1, keepdim=True).float()
    return torch.where(valid, 1.0, 0.0) / cnt.clamp_min(1.0)


def _normalized(weights: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Weights masked and normalized per row; the mean where a row's
    weights sum to zero."""
    w = torch.where(valid, weights, 0.0)
    wsum = w.sum(dim=1, keepdim=True)
    return torch.where(wsum > 0, w / wsum.clamp_min(_EPS), _uniform(valid))


def mean_aggregate(h_table, nbrs, valid_limit=None, dtype=torch.bfloat16):
    """Unweighted mean over valid neighbors, [B, D] f32."""
    feats, valid = _mask_and_gather(h_table, nbrs, valid_limit, dtype)
    return _weighted_sum(_uniform(valid), feats, dtype)


def weighted_aggregate(h_table, nbrs, weights, valid_limit=None, dtype=torch.bfloat16):
    """Normalized weighted sum; the mean where all weights are zero."""
    feats, valid = _mask_and_gather(h_table, nbrs, valid_limit, dtype)
    return _weighted_sum(_normalized(weights, valid), feats, dtype)


def attention_aggregate(params, h_table, nbrs, self_feats, valid_limit=None,
                        dtype=torch.bfloat16):
    """Softmax attention over [self || neighbor]. A row with no valid
    neighbor gives 0; its softmax is NaN, as in JAX, and the masks keep the
    NaN out of the output and of the gradients."""
    from .pinsage import linear

    feats, valid = _mask_and_gather(h_table, nbrs, valid_limit, dtype)
    feats = feats.float()
    b, k, d = feats.shape
    self_exp = self_feats[:, None, :].float().expand(b, k, d)
    cat = torch.cat([self_exp, feats], dim=-1).reshape(b * k, 2 * d)
    scores = linear(params["attn2"], torch.relu(linear(params["attn1"], cat, dtype)), dtype)
    scores = torch.where(valid, scores.reshape(b, k), -torch.inf)
    # jax.nn.softmax's formula, in the scores' dtype.
    e = torch.exp(scores - scores.amax(dim=1, keepdim=True))
    attn = e / e.sum(dim=1, keepdim=True)
    attn = torch.where(valid.any(dim=1, keepdim=True), attn, 0.0)
    return _weighted_sum(attn, feats, dtype)


def max_aggregate(params, h_table, nbrs, valid_limit=None, dtype=torch.bfloat16):
    """Per-neighbor MLP + ReLU, then the elementwise max over valid
    neighbors, [B, out] in ``dtype``."""
    from .pinsage import linear

    feats, valid = _mask_and_gather(h_table, nbrs, valid_limit, dtype)
    b, k, d = feats.shape
    t = torch.relu(linear(params["mlp"], feats.float().reshape(b * k, d), dtype))
    t = torch.where(valid[:, :, None], t.reshape(b, k, -1), -torch.inf)
    out = torch.amax(t, dim=1)
    return torch.where(torch.isfinite(out), out, 0.0)


def importance_transform_aggregate(params, h_table, nbrs, weights, valid_limit=None,
                                   dtype=torch.bfloat16):
    """Linear transform -> normalized weighted sum -> LayerNorm, [B, out]
    f32; rows with no valid neighbor stay 0."""
    from .pinsage import linear

    feats, valid = _mask_and_gather(h_table, nbrs, valid_limit, dtype)
    b, k, d = feats.shape
    t = linear(params["transform"], feats.float().reshape(b * k, d), dtype).reshape(b, k, -1)
    agg = _weighted_sum(_normalized(weights, valid), t, dtype)
    mean = agg.mean(dim=-1, keepdim=True)
    var = agg.var(dim=-1, unbiased=False, keepdim=True)
    out = (agg - mean) * torch.rsqrt(var + 1e-5) * params["ln_scale"] + params["ln_bias"]
    return torch.where(valid.any(dim=1, keepdim=True), out, 0.0)


def aggregate(kind, params, h_table, nbrs, weights, self_feats=None, valid_limit=None,
              dtype=torch.bfloat16, gather_impl: str = "xla", bwd_layout=None):
    """Dispatch on ``model.aggregator_type``. ``importance`` is the plain
    importance pooling of the PinSage model, through ``gather_impl`` (and
    ``bwd_layout`` for the kernel's backward); the others are plain
    PyTorch."""
    if kind == "importance":
        from .pinsage import importance_pool

        return importance_pool(h_table, nbrs, weights, valid_limit, dtype,
                               impl=gather_impl, bwd_layout=bwd_layout)
    if kind == "mean":
        return mean_aggregate(h_table, nbrs, valid_limit, dtype)
    if kind == "weighted":
        return weighted_aggregate(h_table, nbrs, weights, valid_limit, dtype)
    if kind == "attention":
        return attention_aggregate(params, h_table, nbrs, self_feats, valid_limit, dtype)
    if kind == "max":
        return max_aggregate(params, h_table, nbrs, valid_limit, dtype)
    if kind == "importance_transform":
        return importance_transform_aggregate(params, h_table, nbrs, weights, valid_limit,
                                              dtype)
    raise ValueError(f"unknown aggregator: {kind}")
