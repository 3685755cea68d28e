"""PinSage forwards as PyTorch functions on tensors.

Port of ``movie_recommendation_engine_tpu/models/pinsage.py``: the MLP path
(a); the neighborhood-pooling path (b) in gather form (``pooled_forward``,
each gather layer through ``model.aggregator_type``'s aggregator,
``models/aggregators.py``; optionally with pooling operators for a prefix of
the layers: dense matrices, hub or block operators, ``_pool_apply``) and
dense-matrix form (``pooled_forward_dense``), each with the batch-restricted
training form (``pooled_forward_batch[_dense]``) and inverted dropout after
the hidden convs (``_dropout``); and the edge_index path (c),
``edge_forward``, with ``forward`` dispatching among the three. Parameters
keep the JAX layout — a dict ``{"input_proj", "convs": [...], "output_proj"}``
of ``{"w": [in, out], "b": [out]}`` f32 tensors, a conv's aggregator
parameters under ``"agg"`` and its batch norm under ``"bn"`` — so JAX
weights load one to one.

Dtype contract (as in the JAX package): activations in ``dtype`` (bf16 by
default), pooling accumulated in f32, L2 norms in f32, params f32.

Neighbor id ``>= valid_limit`` marks an empty slot; pooling masks it and
renormalizes over the valid set. A row with no valid neighbors pools to zero.

Under a mesh (``shard``, a ``parallel.mesh.RowShard``) the tables are
row-sharded over the model axis: ``x_table``, the walk tables and the pool
operators hold the rank's rows. A full-graph layer computes the rank's
[C, H] rows, all-gathers ``h`` over the model axis and pools its own rows
of the walk table (global ids) against it; batch norm there sums its
statistics over the axis. The batch layer reads the gathered ``h``, and the
operator or walk-table rows of its nodes through
``parallel.collectives.sharded_rows``; ``batch_stats`` sums its batch
norm over the ranks that share the batch.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.block_sparse import BlockPool, block_pool_matmul
from ..ops.hub_pool import HubPool, hub_pool_matmul, hub_pool_matmul_batch, take_rows
from ..ops.pool import SegmentLayout, edge_slices, gather_pool, slice_sum
from ..parallel.collectives import all_gather_rows, all_reduce_sum, sharded_rows
from ..parallel.mesh import BatchStats, RowShard
from . import aggregators

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
    params through ``core.checkpoint.params_from_jax``): an aggregator with
    parameters gets them under ``conv["agg"]``, ``use_batch_norm`` a scale
    and bias under ``conv["bn"]``."""
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
        agg = aggregators.init_aggregator_params(gen, aggregator, hidden_dim, hidden_dim,
                                                 device=device)
        if agg is not None:
            conv["agg"] = agg
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


# Rows up to which ``build_pool_matrix`` scatters in f32.
_DIRECT_ABOVE_ROWS = 8192
# ``padded_pool_matrix``'s row stride, in elements: a multiple of 64 puts each
# row of a bf16 pool matrix, of its transpose and of a gather of its rows on
# a 128-byte boundary, as Hopper's GEMM kernels (TMA) need.
POOL_ROW_ALIGN = 64


def dense_pool_matrix(nbrs: torch.Tensor, weights: torch.Tensor, num_cols: int,
                      valid_limit: int | None = None, dtype=torch.bfloat16,
                      accumulate_dtype=torch.float32) -> torch.Tensor:
    """[N, num_cols] row-stochastic pooling matrix A with
    ``A[i, nbrs[i, k]] += w_norm[i, k]`` (masked and renormalized like
    ``importance_pool``), scattered in ``accumulate_dtype``."""
    return _scatter_pool_matrix(nbrs, weights, num_cols, num_cols, valid_limit, dtype,
                                accumulate_dtype)


def _scatter_pool_matrix(nbrs, weights, num_cols: int, row_stride: int, valid_limit, dtype,
                         accumulate_dtype) -> torch.Tensor:
    """``dense_pool_matrix``'s A in the first ``num_cols`` columns of a zero
    [N, row_stride] matrix. A negative id wraps within ``num_cols``, as an
    index of the [N, num_cols] matrix does."""
    n, k = nbrs.shape
    limit = num_cols if valid_limit is None else min(valid_limit, num_cols)
    valid = nbrs < limit
    w = torch.where(valid, weights, 0.0)
    wsum = w.sum(dim=1, keepdim=True)
    w = torch.where(wsum > 0, w / wsum.clamp_min(_EPS), 0.0)
    rows = torch.arange(n, device=nbrs.device).repeat_interleave(k)
    cols = nbrs.clamp(max=num_cols - 1).long().reshape(-1)
    cols = torch.where(cols < 0, cols + num_cols, cols)
    a = torch.zeros((n, row_stride), dtype=accumulate_dtype, device=nbrs.device)
    a.index_put_((rows, cols), w.reshape(-1).to(accumulate_dtype), accumulate=True)
    return a.to(dtype)


def _accumulate_dtype(rows: int, dtype, direct_above_rows: int):
    """The scatter's dtype: f32 up to ``direct_above_rows`` rows, ``dtype``
    itself above, so that peak memory is the one output matrix (exact when
    each row's ids are unique, as walk tables' are)."""
    return torch.float32 if rows <= direct_above_rows else dtype


def build_pool_matrix(nbrs: torch.Tensor, weights: torch.Tensor, num_cols: int,
                      valid_limit: int | None = None, dtype=torch.bfloat16,
                      direct_above_rows: int = _DIRECT_ABOVE_ROWS) -> torch.Tensor:
    """Memory-aware ``dense_pool_matrix``: up to ``direct_above_rows`` rows
    the scatter accumulates in f32; above, it scatters straight into
    ``dtype`` (``_accumulate_dtype``)."""
    acc = _accumulate_dtype(nbrs.shape[0], dtype, direct_above_rows)
    return dense_pool_matrix(nbrs, weights, num_cols, valid_limit, dtype,
                             accumulate_dtype=acc)


def padded_pool_matrix(nbrs: torch.Tensor, weights: torch.Tensor, num_cols: int,
                       valid_limit: int | None = None) -> torch.Tensor:
    """``build_pool_matrix``'s bf16 [N, num_cols] matrix, bit for bit, as
    the first ``num_cols`` columns of a matrix whose row stride is
    ``num_cols`` rounded up to ``POOL_ROW_ALIGN`` and whose further columns
    are zero, scattered there directly so that no [N, num_cols] copy is
    made. ``_dense_pool`` takes it as it is."""
    stride = -(-num_cols // POOL_ROW_ALIGN) * POOL_ROW_ALIGN
    acc = _accumulate_dtype(nbrs.shape[0], torch.bfloat16, _DIRECT_ABOVE_ROWS)
    return _scatter_pool_matrix(nbrs, weights, num_cols, stride, valid_limit, torch.bfloat16,
                                acc)


def _dense_pool(pm: torch.Tensor, h: torch.Tensor, dtype) -> torch.Tensor:
    """``pm`` [R, C] @ ``h`` [N, D] for C >= N: the columns of ``pm`` past
    N are zero (``padded_pool_matrix``) and ``h`` gets as many zero rows, so
    each product and its gradient sum the same N terms, with every operand
    at ``pm``'s row stride. At an odd N an [R, N] bf16 matrix has rows off
    16-byte boundaries, and cuBLAS leaves Hopper's kernels for pre-Hopper
    ones, 4-5x slower on an H100 at 26,709 rows."""
    h = h.to(dtype)
    if pm.shape[1] > h.shape[0]:
        h = torch.nn.functional.pad(h, (0, 0, 0, pm.shape[1] - h.shape[0]))
    return (pm.to(dtype) @ h).to(dtype)


def _pool_apply(pm, h: torch.Tensor, dtype, gather_impl: str = "xla",
                bwd_layout: SegmentLayout | None = None,
                shard: RowShard | None = None) -> torch.Tensor:
    """Full-graph pooling through one layer's operator: a dense [N, N]
    matrix (or [N, C] with zero columns past N, ``_dense_pool``), an
    ``ops.hub_pool.HubPool`` (its residual through ``gather_impl``;
    ``bwd_layout`` is its residual table's layout for the kernel's
    backward) or an ``ops.block_sparse.BlockPool``. Under
    ``shard``, ``h`` is the whole gathered table and the result the rank's
    rows."""
    if isinstance(pm, HubPool):
        return hub_pool_matmul(pm, h, dtype=dtype, gather_impl=gather_impl,
                               bwd_layout=bwd_layout)
    if isinstance(pm, BlockPool):
        out = block_pool_matmul(pm, h, dtype=dtype, group=shard and shard.group)
        return out if shard is None else out[shard.start:shard.stop]
    return _dense_pool(pm, h, dtype)


def _batch_norm(h: torch.Tensor, bn: Params, stats: BatchStats | None) -> torch.Tensor:
    """Normalize over the rows (biased variance, eps 1e-5), then scale and
    shift. ``stats`` sums the statistics over its group's ``rows`` rows."""
    if stats is None:
        if h.shape[0] <= 1:
            return h
        mean = h.mean(dim=0, keepdim=True)
        var = h.var(dim=0, unbiased=False, keepdim=True)
    else:
        if stats.rows <= 1:
            return h
        hf = h.float()
        mean = all_reduce_sum(hf.sum(dim=0, keepdim=True), stats.group) / stats.rows
        var = all_reduce_sum(((hf - mean) ** 2).sum(dim=0, keepdim=True),
                             stats.group) / stats.rows
        mean, var = mean.to(h.dtype), var.to(h.dtype)
    h = (h - mean) * torch.rsqrt(var + 1e-5)
    return h * bn["scale"] + bn["bias"]


def _conv_block(conv: Params, h_self_in: torch.Tensor, h_neigh: torch.Tensor,
                dtype, stats: BatchStats | None = None) -> torch.Tensor:
    """concat(lin_self(h), pooled) -> lin_update [-> BN] -> ReLU -> L2 norm."""
    h_self = linear(conv["self"], h_self_in, dtype)
    h = linear(conv["update"], torch.cat([h_self, h_neigh], dim=-1), dtype)
    if "bn" in conv:
        h = _batch_norm(h, conv["bn"], stats)
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
    # is 0.80078125); filled on the device, so no copy from the host.
    scale = torch.full((), 1.0 - rate, dtype=h.dtype, device=h.device)
    return torch.where(keep, h / scale, 0.0)


def _hidden_dropout(h: torch.Tensor, i: int, rate: float, generator, keep,
                    shard: RowShard | None = None) -> torch.Tensor:
    """Dropout after hidden conv ``i``; under ``shard`` the whole table's
    mask is drawn (or given), as on one device, and the rank's rows kept."""
    k = None if keep is None else keep[i]
    if shard is not None and rate > 0:
        if k is None and generator is not None:
            k = torch.rand((shard.total, h.shape[1]), generator=generator,
                           device=h.device) < 1.0 - rate
        if k is not None:
            k = k[shard.start:shard.stop]
    return _dropout(h, rate, generator, k)


def _gathered(h: torch.Tensor, shard: RowShard | None) -> torch.Tensor:
    """The whole table of ``h`` (the rank's rows all-gathered under a
    shard)."""
    return h if shard is None else all_gather_rows(h, shard.group)


def _full_graph_layer(i: int, conv, h, layer_neighbors, layer_weights, pool_mats,
                      valid_limit, dtype, aggregator, gather_impl, layout, shard):
    """Layer ``i`` for every row (the rank's rows under ``shard``)."""
    table = _gathered(h, shard)
    if i < len(pool_mats):
        h_neigh = _pool_apply(pool_mats[i], table, dtype, gather_impl, layout, shard)
    else:
        h_neigh = _gather_layer(
            conv, table, h, layer_neighbors[min(i, len(layer_neighbors) - 1)],
            layer_weights[min(i, len(layer_weights) - 1)], valid_limit, dtype,
            aggregator, gather_impl, layout)
    stats = None if shard is None else BatchStats(shard.group, shard.total)
    return _conv_block(conv, h, h_neigh, dtype, stats)


def _gather_layer(conv, h, h_self, nbrs, w, valid_limit, dtype, aggregator, gather_impl,
                  bwd_layout=None):
    """One layer's neighborhood pooling through its aggregator, in ``dtype``;
    ``h_self`` are the rows being pooled for (attention's query)."""
    return aggregators.aggregate(aggregator, conv.get("agg"), h, nbrs, w, self_feats=h_self,
                                 valid_limit=valid_limit, dtype=dtype,
                                 gather_impl=gather_impl, bwd_layout=bwd_layout).to(dtype)


def pooled_forward_dense(params: Params, x_table: torch.Tensor,
                         pool_mats: list[torch.Tensor], dtype=torch.bfloat16,
                         dropout_rate: float = 0.0,
                         generator: torch.Generator | None = None,
                         dropout_keep: list[torch.Tensor] | None = None,
                         shard: RowShard | None = None) -> torch.Tensor:
    """Full-graph pooled forward with matmul pooling, one [N, N] matrix per
    layer (or [N, C] with zero columns past N; importance aggregator).
    ``dropout_keep`` holds one mask per hidden conv (see ``_dropout``)."""
    if len(pool_mats) != len(params["convs"]):
        raise ValueError("pooled_forward_dense needs one pool matrix per layer")
    return pooled_forward(params, x_table, [], [], dtype=dtype, dropout_rate=dropout_rate,
                          generator=generator, dropout_keep=dropout_keep,
                          pool_mats=pool_mats, shard=shard)


def pooled_forward(params: Params, x_table: torch.Tensor,
                   layer_neighbors: list[torch.Tensor],
                   layer_weights: list[torch.Tensor],
                   valid_limit: int | None = None, dtype=torch.bfloat16,
                   dropout_rate: float = 0.0,
                   generator: torch.Generator | None = None,
                   dropout_keep: list[torch.Tensor] | None = None,
                   aggregator: str = "importance", pool_mats=(),
                   gather_impl: str = "xla", shard: RowShard | None = None) -> torch.Tensor:
    """Full-graph forward: embeddings for every row of ``x_table`` (the
    rank's rows under ``shard``). Layer ``i < len(pool_mats)`` pools through
    its operator (``_pool_apply``: dense matrix, hub or block); the others
    through ``importance_pool`` with ``gather_impl``."""
    convs = params["convs"]
    h = torch.relu(linear(params["input_proj"], x_table, dtype))
    for i, conv in enumerate(convs):
        h = _full_graph_layer(i, conv, h, layer_neighbors, layer_weights, pool_mats,
                              valid_limit, dtype, aggregator, gather_impl, None, shard)
        if i < len(convs) - 1:
            h = _hidden_dropout(h, i, dropout_rate, generator, dropout_keep, shard)
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
                         bwd_layouts: list[SegmentLayout | None] | None = None,
                         shard: RowShard | None = None,
                         batch_stats: BatchStats | None = None) -> torch.Tensor:
    """Training-step forward: layers 0..L-2 over the full graph (their output
    is the table the next layer gathers from), then the final conv and the
    output projection for ``batch_nodes`` [B] only. Batch ids are clamped into
    the table, as JAX's ``take(..., mode="clip")``. ``pool_mats`` gives the
    pooling operators of a prefix of the layers (``_pool_apply``), the final
    one included when it covers every layer: a hub operator there pools the
    batch rows alone (``hub_pool_matmul_batch``), a block operator pools the
    whole graph and takes the batch rows, a dense matrix its batch rows
    (at the matrix's row stride, ``_dense_pool``).
    ``bwd_layouts[i]`` (``gather_impl="pallas"``) is the backward kernel's
    layout of full-graph layer ``i``'s gather table (a hub layer's residual
    table), or None; the batch layer's rows change every step, so its
    backward builds its own. Under ``shard`` (see the module docstring) the
    batch rows are this rank's share and ``batch_stats`` their batch norm's
    group."""
    convs = params["convs"]
    h = torch.relu(linear(params["input_proj"], x_table, dtype))
    for i, conv in enumerate(convs[:-1]):
        layout = bwd_layouts[i] if bwd_layouts else None
        h = _full_graph_layer(i, conv, h, layer_neighbors, layer_weights, pool_mats,
                              valid_limit, dtype, aggregator, gather_impl, layout, shard)
        h = _hidden_dropout(h, i, dropout_rate, generator, dropout_keep, shard)
    h = _gathered(h, shard)
    take = take_rows if shard is None else (lambda a, r: sharded_rows(a, r, shard.group))
    last, li = convs[-1], len(convs) - 1
    idx = batch_nodes.long().clamp(0, h.shape[0] - 1)
    pm = pool_mats[li] if li < len(pool_mats) else None
    if isinstance(pm, HubPool):
        h_neigh = hub_pool_matmul_batch(pm, h, batch_nodes, dtype=dtype,
                                        gather_impl=gather_impl, take=take)
    elif isinstance(pm, BlockPool):
        h_neigh = block_pool_matmul(pm, h, dtype=dtype, group=shard and shard.group)[idx]
    elif pm is not None:
        h_neigh = _dense_pool(take(pm, idx), h, dtype)
    else:
        nbrs = layer_neighbors[min(li, len(layer_neighbors) - 1)]
        w = layer_weights[min(li, len(layer_weights) - 1)]
        rows = batch_nodes.long().clamp(0, (nbrs.shape[0] if shard is None else shard.total) - 1)
        h_neigh = _gather_layer(last, h, h[idx], take(nbrs, rows), take(w, rows), valid_limit,
                                dtype, aggregator, gather_impl)
    h_out = _conv_block(last, h[idx], h_neigh, dtype, batch_stats)
    return l2_normalize(linear(params["output_proj"], h_out, dtype).float())


def pooled_forward_batch_dense(params: Params, x_table: torch.Tensor,
                               pool_mats: list[torch.Tensor], batch_nodes: torch.Tensor,
                               dtype=torch.bfloat16, dropout_rate: float = 0.0,
                               generator: torch.Generator | None = None,
                               dropout_keep: list[torch.Tensor] | None = None,
                               shard: RowShard | None = None,
                               batch_stats: BatchStats | None = None) -> torch.Tensor:
    """Dense-matmul ``pooled_forward_batch``: full-graph convs for layers
    0..L-2, then the final conv on ``batch_nodes`` through a [B, N] row-gather
    of the last pool matrix."""
    convs = params["convs"]
    if len(pool_mats) != len(convs):
        raise ValueError("pooled_forward_batch_dense needs one pool matrix per layer")
    return pooled_forward_batch(params, x_table, [], [], batch_nodes, dtype=dtype,
                                dropout_rate=dropout_rate, generator=generator,
                                dropout_keep=dropout_keep, pool_mats=pool_mats,
                                shard=shard, batch_stats=batch_stats)


def edge_forward(params: Params, x: torch.Tensor, edge_src: torch.Tensor,
                 edge_dst: torch.Tensor, edge_weight: torch.Tensor | None = None,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Path (c), GraphConv message passing: per conv, the message
    ``lin_neigh(h)[src] * edge_weight`` summed into ``dst`` in f32
    (``aggr="add"``), then concat / update / ReLU / L2 norm.

    Where JAX scatters one message per edge (``segment_sum``), each target's
    incoming edges, in edge order, are cut into slices (``ops.pool.
    edge_slices``, weights the raw edge weights or 1) that one
    ``gather_pool`` call sums (the gather-pool kernel on the card), and a
    target's slices are added in order (``ops.pool.slice_sum``): the sums
    run in a fixed order, so a call repeats bit for bit."""
    n, dev = x.shape[0], x.device
    src, dst = torch.as_tensor(edge_src, device=dev), torch.as_tensor(edge_dst, device=dev)
    w = (torch.ones(src.shape[0], device=dev) if edge_weight is None
         else torch.as_tensor(edge_weight, device=dev))
    slices = edge_slices(src, dst, w, n)
    h = torch.relu(linear(params["input_proj"], x, dtype))
    for conv in params["convs"]:
        transformed = linear(conv["neigh"], h, dtype)
        h = _conv_block(conv, h, slice_sum(transformed, slices).to(dtype), dtype)
    return l2_normalize(linear(params["output_proj"], h, dtype).float())


def forward(params: Params, x: torch.Tensor, edge_index=None, sampled_neighbors=None,
            importance_weights=None, **kw) -> torch.Tensor:
    """Path selection of the reference's ``PinSage.forward``: the MLP path
    without graph inputs, the pooled path with per-layer neighborhoods and
    weights, else the edge path over ``edge_index`` ([2, E] or a (src, dst)
    pair, ``edge_weight`` in ``kw``)."""
    dtype = kw.get("dtype", torch.bfloat16)
    if edge_index is None and (sampled_neighbors is None or importance_weights is None):
        return mlp_forward(params, x, dtype)
    if edge_index is None:
        kw.pop("edge_weight", None)      # the pooled path has no edge weights
        return pooled_forward(params, x, sampled_neighbors, importance_weights, **kw)
    return edge_forward(params, x, edge_index[0], edge_index[1], kw.get("edge_weight"),
                        dtype=dtype)
