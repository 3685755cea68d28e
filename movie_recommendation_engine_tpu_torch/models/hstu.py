"""HSTU, the Hierarchical Sequential Transduction Unit (Zhai et al., "Actions
Speak Louder than Words", ICML 2024, arXiv:2402.17152), as PyTorch functions
on tensors: a causal stack of pointwise-attention blocks over each user's
rating history in time order, trained to predict the next item against
sampled negatives.

One block on ``X`` [B, L, d] computes

    U, V, Q, K = split(SiLU(LayerNorm(X) @ f1))
    A = SiLU(Q K^T + rab^{p,t}) / L        (causal, per head)
    Y = X + f2(dropout(LayerNorm(A V) * U))

with ``rab^{p,t}`` a learned bias indexed by the relative position ``j - i``
and by the bucket ``floor(log(max(|t_q - t_j|, 1)) / 0.301)`` (capped at
``TIME_BUCKETS``) of the gap between key ``j``'s timestamp and the
query time of position ``i``: the timestamp of the event position ``i``
predicts (in the published code, the next slot's timestamp, the target's
included). The layer norms have no affine parameters, ``f1`` no bias; the
relative bias is one per block, shared by its heads. The input is the item
embedding times sqrt(d) plus a learned absolute position embedding, dropped
out and zeroed at padding; the output and the item table are L2-normalised
(eps 1e-6), and the loss is a sampled softmax at every position against
``R`` uniform negatives, an accidental hit masked (``sampled_softmax_loss``).

Lookups: every item row (history, positives, negatives) comes through
``ops.pool.gather_pool`` at K = 1 with weight 1, so the item table's
gradient is the deterministic segment kernel on the card. The relative
bias's rows come through ``bias_lookup``, whose gradient sums in 64-bit
integers (exact, so any order gives the same bits) where a float
scatter-add on the card would change bits from run to run. Matmuls run in
``dtype`` (bf16 by default), SiLU, the norms, the bias and the loss in f32.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..ops.pool import gather_pool

Params = dict[str, Any]

LN_EPS = 1e-6
L2_EPS = 1e-6
BUCKET_SCALE = 0.301
HIT_LOGIT = -5e4          # an accidental hit's logit (the published code's)
TIME_BUCKETS = 128        # the relative bias's log time buckets (published)
LINEAR_DROPOUT = 0.2      # on the input of each block's f2 (published)


class Dims(NamedTuple):
    d: int
    blocks: int
    heads: int
    dqk: int
    dv: int
    max_len: int
    dropout: float


def dims(cfg) -> Dims:
    m = cfg.model
    return Dims(m.embed_dim, m.num_layers, m.hstu_heads, m.hstu_dqk, m.hstu_dv,
                m.hstu_max_len, m.dropout)


def init_params(generator: torch.Generator, num_items: int, dm: Dims, device) -> Params:
    """The published initialisation: item embeddings and ``f1`` N(0, 0.02),
    position embeddings N(0, 1/d), ``f2`` Xavier-uniform with a zero bias,
    the relative bias N(0, 0.02) (normals untruncated here)."""
    def normal(shape, std):
        return std * torch.randn(shape, generator=generator, device=device)

    hv, width = dm.heads * dm.dv, 2 * dm.heads * (dm.dv + dm.dqk)
    bound = math.sqrt(6.0 / (hv + dm.d))
    return {
        "item_emb": normal((num_items, dm.d), 0.02),
        "pos_emb": normal((dm.max_len, dm.d), dm.d ** -0.5),
        "blocks": [{
            "uvqk": normal((dm.d, width), 0.02),
            "o": {"w": bound * (2 * torch.rand((hv, dm.d), generator=generator,
                                               device=device) - 1),
                  "b": torch.zeros(dm.d, device=device)},
            "ts_w": normal((TIME_BUCKETS + 1,), 0.02),
            "pos_w": normal((2 * dm.max_len - 1,), 0.02),
        } for _ in range(dm.blocks)],
    }


class Draws(NamedTuple):
    """One step's random inputs: ``negatives`` [B, L, R] int32 item ids, and
    bool keep masks for the input dropout [B, L, d] (None at rate 0) and
    each block's linear dropout [B, L, H * dv]."""

    negatives: torch.Tensor
    keep_in: torch.Tensor | None
    keep_lin: list[torch.Tensor]


def draw_step(generator: torch.Generator, b: int, length: int, num_negatives: int,
              num_items: int, dm: Dims, device) -> Draws:
    """The draws of one step, in this order: the negatives, the input mask,
    each block's mask (``uniform >= rate`` keeps)."""
    negs = torch.randint(0, num_items, (b, length, num_negatives), generator=generator,
                         device=device, dtype=torch.int32)
    keep_in = None
    if dm.dropout > 0:
        keep_in = torch.rand((b, length, dm.d), generator=generator, device=device) >= dm.dropout
    keep_lin = [torch.rand((b, length, dm.heads * dm.dv), generator=generator,
                           device=device) >= LINEAR_DROPOUT
                for _ in range(dm.blocks)]
    return Draws(negs, keep_in, keep_lin)


def _dropout(x: torch.Tensor, keep: torch.Tensor | None, rate: float) -> torch.Tensor:
    return x if keep is None else torch.where(keep, x / (1.0 - rate), 0.0)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(L2_EPS)


def fixed_point_sum(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """[n] sums of ``values`` [R, M] by ``index`` [R, M], in ``values``'
    dtype: each value scaled by 2**61 over the sum of magnitudes (a power of
    two), rounded to int64 and added with integer atomics into a row of
    ``n`` sums per row of ``values`` (so that few atomics meet on one
    address), whose sums do not depend on their order; then the rows are
    summed. The rounding error is at most R * M * 2**-62 of the sum of
    magnitudes. Nothing is read back to the host."""
    v = values.double()
    total = v.abs().sum().clamp_min(2.0 ** -900)
    scale = torch.exp2(61 - torch.ceil(torch.log2(total)))
    q = torch.round(v * scale).long()
    acc = torch.zeros((v.shape[0], n), dtype=torch.int64, device=v.device)
    return (acc.scatter_add_(1, index, q).sum(0).double() / scale).to(values.dtype)


class _BiasLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, index):
        ctx.save_for_backward(index)
        ctx.n = w.shape[0]
        return w[index]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        rows = index.shape[0] if index.dim() > 2 else 1      # a batch's rows apart
        return fixed_point_sum(g.reshape(rows, -1), index.reshape(rows, -1), ctx.n), None


def bias_lookup(w: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``w[index]``, its gradient in ``w`` summed by ``fixed_point_sum``."""
    return _BiasLookup.apply(w, index)


def time_buckets(ts: torch.Tensor) -> torch.Tensor:
    """[B, L, L] int64 buckets of ``|t_q(i) - t_j|`` for ``ts`` [B, L + 1]:
    the query time of position i is ``ts[:, i + 1]``, key j's ``ts[:, j]``."""
    gap = (ts[:, 1:, None] - ts[:, None, :-1]).abs().clamp_min(1)
    return (torch.log(gap.float()) / BUCKET_SCALE).long().clamp(0, TIME_BUCKETS)


def relative_positions(length: int, device) -> torch.Tensor:
    """[L, L] int64 ``L - 1 + j - i``: the relative position's row of
    ``pos_w`` (the published Toeplitz of a length-L window)."""
    r = torch.arange(length, device=device)
    return length - 1 + r[None, :] - r[:, None]


def block(p: Params, x: torch.Tensor, bucket: torch.Tensor, rel: torch.Tensor,
          causal: torch.Tensor, keep: torch.Tensor | None, dm: Dims,
          dtype: torch.dtype) -> torch.Tensor:
    """One HSTU block on ``x`` [B, L, d] f32."""
    b, length, d = x.shape
    h, hv, hq = dm.heads, dm.heads * dm.dv, dm.heads * dm.dqk
    uvqk = F.silu((F.layer_norm(x, (d,), eps=LN_EPS).to(dtype) @ p["uvqk"].to(dtype)).float())
    u, v, q, k = torch.split(uvqk, [hv, hv, hq, hq], dim=-1)
    dense = torch.contiguous_format                # [B, H, L, *] in one copy each
    q = q.reshape(b, length, h, dm.dqk).transpose(1, 2).to(dtype, memory_format=dense)
    k = k.reshape(b, length, h, dm.dqk).transpose(1, 2).to(dtype, memory_format=dense)
    v = v.reshape(b, length, h, dm.dv).transpose(1, 2).to(dtype, memory_format=dense)
    bias = bias_lookup(p["ts_w"], bucket) + bias_lookup(p["pos_w"], rel)     # [B, L, L]
    scores = (q @ k.transpose(-1, -2)).float() + bias[:, None]
    attn = F.silu(scores) / length * causal
    o = (attn.to(dtype) @ v).float().transpose(1, 2).reshape(b, length, hv)
    o = _dropout(F.layer_norm(o, (hv,), eps=LN_EPS) * u, keep, LINEAR_DROPOUT)
    return x + (o.to(dtype) @ p["o"]["w"].to(dtype)).float() + p["o"]["b"]


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [N, d] at ``ids`` (any shape, int32; -1 gives a zero
    row) through ``gather_pool`` at K = 1, weight 1: ``ids.shape + (d,)``."""
    flat = ids.reshape(-1, 1).contiguous()
    ones = torch.ones(flat.shape, dtype=torch.float32, device=flat.device)
    return gather_pool(table, flat, ones, table.shape[0]).reshape(*ids.shape, table.shape[1])


def encode(params: Params, ids: torch.Tensor, ts: torch.Tensor, dm: Dims,
           keep_in: torch.Tensor | None = None, keep_lin: list | None = None,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[B, L, d] f32 L2-normalised user states for ``ids`` [B, L] int32
    (right padded with -1) and ``ts`` [B, L + 1] int64 (slot i + 1 holds
    position i's query time); position i reads positions 0..i only."""
    b, length = ids.shape
    if length > dm.max_len:
        raise ValueError(f"{length} positions, above hstu_max_len={dm.max_len}")
    x = lookup(params["item_emb"], ids) * (dm.d ** 0.5) + params["pos_emb"][:length]
    x = _dropout(x, keep_in, dm.dropout) * (ids >= 0)[..., None]
    bucket = time_buckets(ts)
    rel = relative_positions(length, ids.device)
    causal = torch.ones((length, length), device=ids.device).tril_()
    for i, p in enumerate(params["blocks"]):
        x = block(p, x, bucket, rel, causal, None if keep_lin is None else keep_lin[i], dm, dtype)
    return l2_normalize(x)


def item_table(params: Params) -> torch.Tensor:
    """[N, d] f32 L2-normalised item embeddings: the rows the loss scores
    and the indexes search."""
    return l2_normalize(params["item_emb"])


def sampled_softmax_loss(states: torch.Tensor, rows: torch.Tensor, targets: torch.Tensor,
                         negatives: torch.Tensor, temperature: float) -> torch.Tensor:
    """Mean over the supervised positions (``targets >= 0``) of the
    cross-entropy of the target against its own ``R`` negatives:
    ``states`` [..., d] and ``rows`` [..., 1 + R, d] (target first) f32 and
    L2-normalised; a negative equal to the target gets ``HIT_LOGIT``. The
    per-query form of ``losses.nce_loss``."""
    logits = (rows @ states[..., None])[..., 0] / temperature     # no copy of ``rows``
    hit = torch.cat([torch.zeros_like(targets[..., None], dtype=torch.bool),
                     negatives == targets[..., None]], dim=-1)
    logits = torch.where(hit, HIT_LOGIT, logits)
    nll = -torch.log_softmax(logits, dim=-1)[..., 0]
    sup = (targets >= 0).float()
    return (nll * sup).sum() / sup.sum().clamp_min(1.0)


def seq_loss(params: Params, ids: torch.Tensor, ts: torch.Tensor, draws: Draws, dm: Dims,
             temperature: float, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The train loss of windows ``ids``, ``ts`` [B, L + 1]: the forward over
    slots 0..L-1, position i predicting slot i + 1, against ``draws``."""
    length = ids.shape[1] - 1
    states = encode(params, ids[:, :length], ts, dm, draws.keep_in, draws.keep_lin, dtype)
    targets = ids[:, 1:]
    cand = torch.cat([targets[..., None], draws.negatives], dim=-1)
    rows = lookup(item_table(params), cand)
    return sampled_softmax_loss(states, rows, targets, draws.negatives, temperature)
