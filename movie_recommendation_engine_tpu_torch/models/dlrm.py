"""DLRM-DCNv2, MLPerf Training's click-through ranker, as PyTorch functions on
tensors: DLRM (Naumov et al., arXiv:1906.00091) with the low-rank cross
network of DCN-V2 (Wang et al., arXiv:2008.13535) as its interaction, the
model of MLPerf's ``recommendation_v2/torchrec_dlrm`` reference (TorchRec's
``DLRM_DCN``).

A sample has ``dense`` features (already ``log(x + 1)``) and, per
categorical feature f, a bag of K_f ids into table f. Then

    z  = bottom(dense)                       (ReLU after every layer)
    e_f = sum of table_f's rows at the bag's ids
    x0 = concat(z, e_1, ..., e_F)            [(1 + F) * d]
    x_{l+1} = x0 * (U_l (V_l^T x_l) + b_l) + x_l     (low-rank cross, l < L)
    logit = top(x_L)                         (ReLU between layers, none after)

and the loss is binary cross-entropy on the logit, the batch's mean.

Each bag is one ``ops.pool.gather_pool`` call with weight 1 at K = K_f, on
its own table (so no table passes the kernel's 32-bit limits). The tables
take no part in autograd: the bags enter the dense part as one leaf, whose
gradient [B, F, d] the trainer turns into each table's gradient over the
rows the batch touched (``ops.pool.compact_rows`` / ``compact_grad``), so
no step makes a tensor of a table's size beside the table and its
accumulator. A table holds ``SPARE_ROWS`` rows past its ``rows_f``, which no
id names: the padding of the compact rows' writes lands there, spread, so
that no one row takes every padding write of a step.

Precision as the port's other models: matmuls in ``dtype`` (bf16 by
default) with f32 accumulation, the tables, bags, biases, cross products,
loss and optimizer state in f32.

Initialisation as TorchRec's: table f uniform in +-sqrt(1 / its published
rows); linear layers as ``nn.Linear`` (weight and bias uniform in
+-1 / sqrt(fan in)); each cross layer's V and U Xavier-normal and its bias
zero, as ``LowRankCrossNet``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..ops.pool import gather_pool
from ..parallel.sharding import loss_and_grads as grads_of

Params = dict[str, Any]

SPARE_ROWS = 256          # rows past each table's held rows, 0 and never named by an id


class Dims(NamedTuple):
    dense: int                  # dense features
    bags: tuple[int, ...]       # K_f, ids per bag of feature f
    rows: tuple[int, ...]       # rows held of table f (its ids lie in [0, rows_f))
    published: tuple[int, ...]  # the published rows of table f (its init's bound)
    d: int                      # the tables' width
    bottom: tuple[int, ...]     # the bottom MLP's widths; the last is d
    top: tuple[int, ...]        # the top MLP's widths; the last is 1
    cross_layers: int
    rank: int

    @property
    def width(self) -> int:
        """The interaction's width, (1 + F) * d."""
        return (1 + len(self.bags)) * self.d


def dims(cfg) -> Dims:
    m = cfg.model
    published = tuple(int(r) for r in m.dlrm_table_rows)
    held = tuple(int(r) for r in m.dlrm_rows_held) or published
    dm = Dims(m.dlrm_dense_features, tuple(int(k) for k in m.dlrm_bag_sizes), held, published,
              m.embed_dim, tuple(int(w) for w in m.dlrm_bottom),
              tuple(int(w) for w in m.dlrm_top), m.dlrm_cross_layers, m.dlrm_cross_rank)
    if not len(dm.bags) == len(dm.rows) == len(dm.published):
        raise ValueError(f"model.dlrm_bag_sizes, dlrm_table_rows and dlrm_rows_held name "
                         f"{len(dm.bags)}, {len(dm.published)} and {len(dm.rows)} features")
    if any(h < 1 or h > p for h, p in zip(dm.rows, dm.published)):
        raise ValueError("model.dlrm_rows_held must lie in [1, dlrm_table_rows] per table")
    if dm.bottom[-1] != dm.d or dm.top[-1] != 1:
        raise ValueError(f"the bottom MLP must end at embed_dim={dm.d} and the top at 1, got "
                         f"{dm.bottom}, {dm.top}")
    return dm


def init_params(generator: torch.Generator, dm: Dims, device) -> Params:
    """TorchRec's initialisation (module docstring), drawn from
    ``generator`` in this order: the tables, the bottom MLP, the cross
    layers, the top MLP. Each table's spare rows are 0."""
    def uniform(shape, bound):
        return bound * (2 * torch.rand(shape, generator=generator, device=device) - 1)

    def linear(n_in, n_out):
        bound = 1.0 / math.sqrt(n_in)
        return {"w": uniform((n_in, n_out), bound), "b": uniform((n_out,), bound)}

    def xavier(n_in, n_out):
        std = math.sqrt(2.0 / (n_in + n_out))
        return std * torch.randn((n_in, n_out), generator=generator, device=device)

    tables = []
    for rows, published in zip(dm.rows, dm.published):
        t = torch.zeros((rows + SPARE_ROWS, dm.d), device=device)
        t[:rows] = uniform((rows, dm.d), math.sqrt(1.0 / published))
        tables.append(t)
    widths = (dm.dense, *dm.bottom)
    bottom = [linear(a, b) for a, b in zip(widths[:-1], widths[1:])]
    cross = [{"v": xavier(dm.width, dm.rank), "u": xavier(dm.rank, dm.width),
              "b": torch.zeros(dm.width, device=device)} for _ in range(dm.cross_layers)]
    widths = (dm.width, *dm.top)
    top = [linear(a, b) for a, b in zip(widths[:-1], widths[1:])]
    return {"tables": tables, "bottom": bottom, "cross": cross, "top": top}


def dense_params(params: Params) -> Params:
    """The parameters autograd reaches: everything but the tables."""
    return {k: v for k, v in params.items() if k != "tables"}


def bags(tables: list[torch.Tensor], ids: list[torch.Tensor], ones: list[torch.Tensor],
         dm: Dims) -> torch.Tensor:
    """[B, F * d] f32: feature f's columns the sum of ``tables[f]``'s rows
    at ``ids[f]`` [B, K_f] int32 (every id in [0, rows_f)), one
    ``gather_pool`` call a bag with ``ones[f]`` [B, K_f] f32 as weights."""
    return torch.cat([gather_pool(t, i, w, rows)
                      for t, i, w, rows in zip(tables, ids, ones, dm.rows)], dim=1)


def mlp(layers: list, x: torch.Tensor, dtype: torch.dtype, relu_last: bool) -> torch.Tensor:
    for i, p in enumerate(layers):
        x = (x.to(dtype) @ p["w"].to(dtype)).float() + p["b"]
        if relu_last or i < len(layers) - 1:
            x = F.relu(x)
    return x


def logits(params: Params, dense: torch.Tensor, emb: torch.Tensor,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[B] f32 logits of ``dense`` [B, dense] f32 and the bags ``emb`` [B,
    F * d] f32 (``bags``), at ``params``' dense parts."""
    x0 = torch.cat([mlp(params["bottom"], dense, dtype, True), emb], dim=1)
    x = x0
    for c in params["cross"]:
        low = (x.to(dtype) @ c["v"].to(dtype)) @ c["u"].to(dtype)
        x = x0 * (low.float() + c["b"]) + x
    return mlp(params["top"], x, dtype, False)[:, 0]


def loss_and_grads(params: Params, dense: torch.Tensor, ids: list[torch.Tensor],
                   ones: list[torch.Tensor], labels: torch.Tensor, dm: Dims,
                   dtype: torch.dtype = torch.bfloat16):
    """(loss, the dense parameters' gradients in their tree, the bags'
    gradient [B, F, d] f32) of the batch's mean binary cross-entropy."""
    emb = bags(params["tables"], ids, ones, dm)

    def loss_fn(p):
        return F.binary_cross_entropy_with_logits(logits(p, dense, p["emb"], dtype), labels)

    loss, grads = grads_of(loss_fn, {**dense_params(params), "emb": emb})
    d_emb = grads.pop("emb")
    return loss, grads, d_emb.view(emb.shape[0], len(dm.bags), dm.d)


@torch.no_grad()
def predict(params: Params, dense: torch.Tensor, ids: list[torch.Tensor],
            ones: list[torch.Tensor], dm: Dims,
            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[B] f32 logits of a batch."""
    return logits(params, dense, bags(params["tables"], ids, ones, dm), dtype)
