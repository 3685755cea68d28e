"""PinSage forwards as PyTorch functions on tensors.

Port of ``movie_recommendation_engine_tpu/models/pinsage.py``: the MLP path
(a), and the importance-pooling path (b) in gather form (``pooled_forward``,
optionally with dense pool matrices for a prefix of the layers) and
dense-matrix form (``pooled_forward_dense``), each with the batch-restricted
training form (``pooled_forward_batch[_dense]``) and inverted dropout after
the hidden convs (``_dropout``). Parameters keep the
JAX layout — a dict ``{"input_proj", "convs": [...], "output_proj"}`` of
``{"w": [in, out], "b": [out]}`` f32 tensors — so JAX weights load one to one.

Dtype contract (as in the JAX package): activations in ``dtype`` (bf16 by
default), pooling accumulated in f32, L2 norms in f32, params f32.

Neighbor id ``>= valid_limit`` marks an empty slot; pooling masks it and
renormalizes over the valid set. A row with no valid neighbors pools to zero.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.pool import SegmentLayout, gather_pool

Params = dict[str, Any]

_EPS = 1e-12  # torch F.normalize eps (reference model/pinsage.py:66)


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int,
                 style: str, device) -> dict[str, torch.Tensor]:
    """He-normal weights and zero biases ("he_zero_bias"), or
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for both ("torch_default")."""
    if style == "torch_default":
        bound = fan_in ** -0.5
        w = torch.rand((fan_in, fan_out), generator=gen, device=device)
        b = torch.rand((fan_out,), generator=gen, device=device)
        return {"w": (2 * w - 1) * bound, "b": (2 * b - 1) * bound}
    std = (2.0 / fan_in) ** 0.5
    return {
        "w": std * torch.randn((fan_in, fan_out), generator=gen, device=device),
        "b": torch.zeros((fan_out,), device=device),
    }


def init_params(gen: torch.Generator, in_dim: int, hidden_dim: int,
                embed_dim: int, num_layers: int = 2,
                aggregator: str = "importance", use_batch_norm: bool = False,
                init_style: str = "he_zero_bias", device=None) -> Params:
    """Same shapes and distributions as the JAX ``init_params``, drawn from a
    ``torch.Generator`` (the numbers differ from JAX's; tests inject JAX's
    params through ``core.checkpoint.params_from_jax``)."""
    if aggregator != "importance":
        raise NotImplementedError(
            f"aggregator {aggregator!r} is not ported yet (ROADMAP queue 1); "
            "only 'importance' pooling is")
    device = gen.device if device is None else device
    params: Params = {
        "input_proj": _linear_init(gen, in_dim, hidden_dim, init_style, device),
        "convs": [],
        "output_proj": _linear_init(gen, hidden_dim, embed_dim, init_style, device),
    }
    for _ in range(num_layers):
        conv = {
            "self": _linear_init(gen, hidden_dim, hidden_dim, init_style, device),
            "neigh": _linear_init(gen, hidden_dim, hidden_dim, init_style, device),
            "update": _linear_init(gen, 2 * hidden_dim, hidden_dim, init_style, device),
        }
        if use_batch_norm:
            conv["bn"] = {"scale": torch.ones(hidden_dim, device=device),
                          "bias": torch.zeros(hidden_dim, device=device)}
        params["convs"].append(conv)
    return params


def num_params(params) -> int:
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    if isinstance(params, list):
        return sum(num_params(v) for v in params)
    return params.numel()


def linear(p: dict[str, torch.Tensor], x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Affine layer; with ``dtype`` the inputs and weights are cast to it and
    the output stays in it."""
    w, b = p["w"], p["b"]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    return x @ w + b.to(x.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    xf = x.float()
    n = torch.linalg.vector_norm(xf, dim=dim, keepdim=True)
    return (xf / n.clamp_min(_EPS)).to(x.dtype)


def mlp_forward(params: Params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Path (a), no graph: relu(input_proj) -> relu(lin_self) per layer ->
    output_proj -> L2 norm."""
    h = torch.relu(linear(params["input_proj"], x, dtype))
    for conv in params["convs"]:
        h = torch.relu(linear(conv["self"], h, dtype))
    return l2_normalize(linear(params["output_proj"], h, dtype).float())


def importance_pool(h_table: torch.Tensor, nbrs: torch.Tensor,
                    weights: torch.Tensor, valid_limit: int | None = None,
                    dtype=torch.bfloat16, impl: str = "xla",
                    bwd_layout: SegmentLayout | None = None) -> torch.Tensor:
    """Masked weighted-sum pooling, [B, D] in ``dtype``.

    Masks ids ``>= limit`` and clamps ids into the table (a negative id keeps
    its weight and reads row 0, as in the JAX function). ``impl="pallas"``
    runs ``ops.pool.gather_pool`` (the CUDA kernel on the card), which also
    masks ids ``< 0``; ``"xla"`` is the gather + einsum formulation.
    ``bwd_layout`` (``impl="pallas"`` only) is ``segment_layout(nbrs,
    limit)``, built ahead for the backward kernel."""
    n = h_table.shape[0]
    limit = n if valid_limit is None else min(valid_limit, n)
    valid = nbrs < limit
    w = torch.where(valid, weights, 0.0)
    wsum = w.sum(dim=1, keepdim=True)
    w = torch.where(wsum > 0, w / wsum.clamp_min(_EPS), 0.0)
    if impl == "pallas":
        out = gather_pool(h_table.to(dtype).contiguous(), nbrs.to(torch.int32).contiguous(),
                          w.float().contiguous(), limit, bwd_layout=bwd_layout)
        return out.to(dtype)
    if impl != "xla":
        raise ValueError(f"gather impl must be 'xla' or 'pallas', got {impl!r}")
    if bwd_layout is not None:
        raise ValueError("bwd_layout is for the kernel's backward (impl='pallas')")
    feats = h_table.to(dtype)[nbrs.clamp(0, n - 1).long()]        # [B, K, D]
    out = torch.bmm(w.to(dtype).float().unsqueeze(1), feats.float()).squeeze(1)
    return out.to(dtype)


def dense_pool_matrix(nbrs: torch.Tensor, weights: torch.Tensor, num_cols: int,
                      valid_limit: int | None = None, dtype=torch.bfloat16,
                      accumulate_dtype=torch.float32) -> torch.Tensor:
    """[N, num_cols] row-stochastic pooling matrix A with
    ``A[i, nbrs[i, k]] += w_norm[i, k]`` (masked and renormalized like
    ``importance_pool``), scattered in ``accumulate_dtype``."""
    n, k = nbrs.shape
    limit = num_cols if valid_limit is None else min(valid_limit, num_cols)
    valid = nbrs < limit
    w = torch.where(valid, weights, 0.0)
    wsum = w.sum(dim=1, keepdim=True)
    w = torch.where(wsum > 0, w / wsum.clamp_min(_EPS), 0.0)
    rows = torch.arange(n, device=nbrs.device).repeat_interleave(k)
    cols = nbrs.clamp(max=num_cols - 1).long().reshape(-1)
    a = torch.zeros((n, num_cols), dtype=accumulate_dtype, device=nbrs.device)
    a.index_put_((rows, cols), w.reshape(-1).to(accumulate_dtype), accumulate=True)
    return a.to(dtype)


def build_pool_matrix(nbrs: torch.Tensor, weights: torch.Tensor, num_cols: int,
                      valid_limit: int | None = None, dtype=torch.bfloat16,
                      direct_above_rows: int = 8192) -> torch.Tensor:
    """Memory-aware ``dense_pool_matrix``: up to ``direct_above_rows`` rows
    the scatter accumulates in f32; above, it scatters straight into
    ``dtype`` so that peak memory is the one [N, num_cols] output (exact
    when each row's ids are unique, as walk tables' are)."""
    acc = torch.float32 if nbrs.shape[0] <= direct_above_rows else dtype
    return dense_pool_matrix(nbrs, weights, num_cols, valid_limit, dtype,
                             accumulate_dtype=acc)


def _dense_pool(pm: torch.Tensor, h: torch.Tensor, dtype) -> torch.Tensor:
    return (pm.to(dtype) @ h.to(dtype)).to(dtype)


def _conv_block(conv: Params, h_self_in: torch.Tensor, h_neigh: torch.Tensor,
                dtype) -> torch.Tensor:
    """concat(lin_self(h), pooled) -> lin_update [-> BN] -> ReLU -> L2 norm."""
    h_self = linear(conv["self"], h_self_in, dtype)
    h = linear(conv["update"], torch.cat([h_self, h_neigh], dim=-1), dtype)
    if "bn" in conv and h.shape[0] > 1:
        mean = h.mean(dim=0, keepdim=True)
        var = h.var(dim=0, unbiased=False, keepdim=True)
        h = (h - mean) * torch.rsqrt(var + 1e-5)
        h = h * conv["bn"]["scale"] + conv["bn"]["bias"]
    return l2_normalize(torch.relu(h))


def _dropout(h: torch.Tensor, rate: float, generator: torch.Generator | None = None,
             keep: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout, ``where(keep, h / (1 - rate), 0)``, applied after the
    hidden convs only. ``keep`` (bool, ``h``'s shape) is the mask to use;
    without it one is drawn from ``generator`` (``uniform < 1 - rate``, as
    ``jax.random.bernoulli``). A no-op at ``rate <= 0`` or with neither."""
    if rate <= 0.0 or (keep is None and generator is None):
        return h
    if keep is None:
        keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - rate
    # The scale in h's dtype, as JAX rounds its weak-typed scalar (bf16 0.8
    # is 0.80078125).
    scale = torch.tensor(1.0 - rate, dtype=h.dtype, device=h.device)
    return torch.where(keep, h / scale, 0.0)


def _hidden_dropout(h: torch.Tensor, i: int, rate: float, generator, keep) -> torch.Tensor:
    return _dropout(h, rate, generator, None if keep is None else keep[i])


def _gather_layer(h, nbrs, w, valid_limit, dtype, aggregator, gather_impl, bwd_layout=None):
    if aggregator != "importance":
        raise NotImplementedError(
            f"aggregator {aggregator!r} is not ported yet (ROADMAP queue 1)")
    return importance_pool(h, nbrs, w, valid_limit, dtype, impl=gather_impl,
                           bwd_layout=bwd_layout)


def pooled_forward_dense(params: Params, x_table: torch.Tensor,
                         pool_mats: list[torch.Tensor], dtype=torch.bfloat16,
                         dropout_rate: float = 0.0,
                         generator: torch.Generator | None = None,
                         dropout_keep: list[torch.Tensor] | None = None) -> torch.Tensor:
    """Full-graph pooled forward with matmul pooling, one [N, N] matrix per
    layer (importance aggregator). ``dropout_keep`` holds one mask per hidden
    conv (see ``_dropout``)."""
    convs = params["convs"]
    if len(pool_mats) != len(convs):
        raise ValueError("pooled_forward_dense needs one pool matrix per layer")
    h = torch.relu(linear(params["input_proj"], x_table, dtype))
    for i, (pm, conv) in enumerate(zip(pool_mats, convs)):
        h = _conv_block(conv, h, _dense_pool(pm, h, dtype), dtype)
        if i < len(convs) - 1:
            h = _hidden_dropout(h, i, dropout_rate, generator, dropout_keep)
    return l2_normalize(linear(params["output_proj"], h, dtype).float())


def pooled_forward(params: Params, x_table: torch.Tensor,
                   layer_neighbors: list[torch.Tensor],
                   layer_weights: list[torch.Tensor],
                   valid_limit: int | None = None, dtype=torch.bfloat16,
                   dropout_rate: float = 0.0,
                   generator: torch.Generator | None = None,
                   dropout_keep: list[torch.Tensor] | None = None,
                   aggregator: str = "importance", pool_mats=(),
                   gather_impl: str = "xla") -> torch.Tensor:
    """Full-graph forward: embeddings for every row of ``x_table``. Layer
    ``i < len(pool_mats)`` pools through the dense matrix (hybrid mode); the
    others through ``importance_pool`` with ``gather_impl``."""
    convs = params["convs"]
    h = torch.relu(linear(params["input_proj"], x_table, dtype))
    for i, conv in enumerate(convs):
        if i < len(pool_mats):
            h_neigh = _dense_pool(pool_mats[i], h, dtype)
        else:
            h_neigh = _gather_layer(
                h, layer_neighbors[min(i, len(layer_neighbors) - 1)],
                layer_weights[min(i, len(layer_weights) - 1)], valid_limit, dtype,
                aggregator, gather_impl)
        h = _conv_block(conv, h, h_neigh, dtype)
        if i < len(convs) - 1:
            h = _hidden_dropout(h, i, dropout_rate, generator, dropout_keep)
    return l2_normalize(linear(params["output_proj"], h, dtype).float())


def pooled_forward_batch(params: Params, x_table: torch.Tensor,
                         layer_neighbors: list[torch.Tensor],
                         layer_weights: list[torch.Tensor],
                         batch_nodes: torch.Tensor,
                         valid_limit: int | None = None, dtype=torch.bfloat16,
                         dropout_rate: float = 0.0,
                         generator: torch.Generator | None = None,
                         dropout_keep: list[torch.Tensor] | None = None,
                         aggregator: str = "importance", pool_mats=(),
                         gather_impl: str = "xla",
                         bwd_layouts: list[SegmentLayout | None] | None = None
                         ) -> torch.Tensor:
    """Training-step forward: layers 0..L-2 over the full graph (their output
    is the table the next layer gathers from), then the final conv and the
    output projection for ``batch_nodes`` [B] only. Batch ids are clamped into
    the table, as JAX's ``take(..., mode="clip")``. ``pool_mats`` gives dense
    pooling for a prefix of the layers (hybrid mode), the final one included
    when it covers every layer. ``bwd_layouts[i]`` (``gather_impl="pallas"``)
    is the backward kernel's layout of full-graph gather layer ``i``, or None;
    the batch layer's rows change every step, so its backward builds its own."""
    convs = params["convs"]
    h = torch.relu(linear(params["input_proj"], x_table, dtype))
    for i, conv in enumerate(convs[:-1]):
        if i < len(pool_mats):
            h_neigh = _dense_pool(pool_mats[i], h, dtype)
        else:
            h_neigh = _gather_layer(
                h, layer_neighbors[min(i, len(layer_neighbors) - 1)],
                layer_weights[min(i, len(layer_weights) - 1)], valid_limit, dtype,
                aggregator, gather_impl, bwd_layouts[i] if bwd_layouts else None)
        h = _conv_block(conv, h, h_neigh, dtype)
        h = _hidden_dropout(h, i, dropout_rate, generator, dropout_keep)
    last, li = convs[-1], len(convs) - 1
    idx = batch_nodes.long().clamp(0, h.shape[0] - 1)
    if li < len(pool_mats):
        pm = pool_mats[li]
        h_neigh = _dense_pool(pm[batch_nodes.long().clamp(0, pm.shape[0] - 1)], h, dtype)
    else:
        nbrs = layer_neighbors[min(li, len(layer_neighbors) - 1)]
        w = layer_weights[min(li, len(layer_weights) - 1)]
        rows = batch_nodes.long().clamp(0, nbrs.shape[0] - 1)
        h_neigh = _gather_layer(h, nbrs[rows], w[rows], valid_limit, dtype, aggregator,
                                gather_impl)
    h_out = _conv_block(last, h[idx], h_neigh, dtype)
    return l2_normalize(linear(params["output_proj"], h_out, dtype).float())


def pooled_forward_batch_dense(params: Params, x_table: torch.Tensor,
                               pool_mats: list[torch.Tensor], batch_nodes: torch.Tensor,
                               dtype=torch.bfloat16, dropout_rate: float = 0.0,
                               generator: torch.Generator | None = None,
                               dropout_keep: list[torch.Tensor] | None = None
                               ) -> torch.Tensor:
    """Dense-matmul ``pooled_forward_batch``: full-graph convs for layers
    0..L-2, then the final conv on ``batch_nodes`` through a [B, N] row-gather
    of the last pool matrix."""
    convs = params["convs"]
    if len(pool_mats) != len(convs):
        raise ValueError("pooled_forward_batch_dense needs one pool matrix per layer")
    return pooled_forward_batch(params, x_table, [], [], batch_nodes, dtype=dtype,
                                dropout_rate=dropout_rate, generator=generator,
                                dropout_keep=dropout_keep, pool_mats=pool_mats)
