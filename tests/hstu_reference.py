"""A plain reference of HSTU's training step: float32 PyTorch, nothing of the
port (no gather kernel, no graph, no cache, no batching), written from the
published equations and code (Zhai et al., ICML 2024, arXiv:2402.17152;
github.com/facebookresearch/generative-recommenders, ``hstu.py`` and
``relative_bias.py``).

Departures from the published code, each the port's too:

- windows are right padded with id -1 (the published code pads with id 0
  and counts items from 1); a padded slot's timestamp repeats the last real
  one;
- the query time of position i is slot i + 1's timestamp of a window one
  longer than the forward (the published code appends the last timestamp
  again, so its last position reads a gap of 0);
- the relative position bias reads ``pos_w[L - 1 + j - i]`` for a forward
  of L positions, which is the published Toeplitz at L = max length;
- normals are not truncated at initialisation;
- negatives are drawn over all items with torch's generator, not 1..N.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def params_like(generator: torch.Generator, num_items: int, d: int, blocks: int, heads: int,
                dqk: int, dv: int, max_len: int, buckets: int) -> dict:
    """Seeded weights in the port's tree (every leaf float32)."""
    def normal(*shape, std):
        return std * torch.randn(shape, generator=generator)

    return {"item_emb": normal(num_items, d, std=0.3),
            "pos_emb": normal(max_len, d, std=d ** -0.5),
            "blocks": [{"uvqk": normal(d, 2 * heads * (dqk + dv), std=d ** -0.5),
                        "o": {"w": normal(heads * dv, d, std=(heads * dv) ** -0.5),
                              "b": normal(d, std=0.1)},
                        "ts_w": normal(buckets + 1, std=0.3),
                        "pos_w": normal(2 * max_len - 1, std=0.3)} for _ in range(blocks)]}


def bucket(gap: torch.Tensor, buckets: int) -> torch.Tensor:
    """The published ``floor(log(max(|dt|, 1)) / 0.301)``, capped."""
    return (torch.log(gap.abs().clamp(min=1).float()) / 0.301).long().clamp(0, buckets)


def toeplitz(pos_w: torch.Tensor, n: int) -> torch.Tensor:
    """[n, n] relative position bias, as the published module builds it."""
    t = F.pad(pos_w[:2 * n - 1], [0, n]).repeat(n)
    t = t[..., :-n].reshape(1, n, 3 * n - 2)
    r = (2 * n - 1) // 2
    return t[:, :, r:-r][0]


def forward(params: dict, ids: torch.Tensor, ts: torch.Tensor, heads: int, dqk: int, dv: int,
            buckets: int, rate_in: float = 0.0, rate_lin: float = 0.0, keep_in=None,
            keep_lin=None) -> torch.Tensor:
    """[B, L, d] normalised states for ``ids`` [B, L] and ``ts`` [B, L + 1]."""
    b, n = ids.shape
    d = params["item_emb"].shape[1]
    valid = ids >= 0
    emb = params["item_emb"][ids.clamp(min=0).long()] * valid[..., None]
    x = emb * math.sqrt(d) + params["pos_emb"][:n][None]
    if keep_in is not None:
        x = x * keep_in / (1 - rate_in)
    x = x * valid[..., None]
    ts_bucket = bucket(ts[:, 1:].unsqueeze(2) - ts[:, :-1].unsqueeze(1), buckets)
    mask = torch.tril(torch.ones(n, n))
    for i, blk in enumerate(params["blocks"]):
        h = F.layer_norm(x, [d], eps=1e-6) @ blk["uvqk"]
        u, v, q, k = torch.split(F.silu(h), [heads * dv, heads * dv, heads * dqk,
                                             heads * dqk], dim=-1)
        q = q.view(b, n, heads, dqk)
        k = k.view(b, n, heads, dqk)
        v = v.view(b, n, heads, dv)
        rab = blk["ts_w"][ts_bucket] + toeplitz(blk["pos_w"], n)[None]
        qk = torch.einsum("bnhd,bmhd->bhnm", q, k) + rab[:, None]
        a = F.silu(qk) / n * mask
        o = torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(b, n, heads * dv)
        o = F.layer_norm(o, [heads * dv], eps=1e-6) * u
        if keep_lin is not None:
            o = o * keep_lin[i] / (1 - rate_lin)
        x = x + o @ blk["o"]["w"] + blk["o"]["b"]
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-6)


def loss(params: dict, ids: torch.Tensor, ts: torch.Tensor, negatives: torch.Tensor,
         heads: int, dqk: int, dv: int, buckets: int, temperature: float, rate_in=0.0,
         rate_lin=0.0, keep_in=None, keep_lin=None) -> torch.Tensor:
    """The sampled softmax at every supervised position of windows ``ids``,
    ``ts`` [B, L + 1], each against its own ``negatives`` [B, L, R]."""
    n = ids.shape[1] - 1
    states = forward(params, ids[:, :n], ts, heads, dqk, dv, buckets, rate_in, rate_lin,
                     keep_in, keep_lin)
    target = ids[:, 1:]
    table = params["item_emb"]
    pos = table[target.clamp(min=0).long()] * (target >= 0)[..., None]
    pos = pos / pos.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    neg = table[negatives.long()]
    neg = neg / neg.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    pos_logit = (states * pos).sum(-1, keepdim=True) / temperature
    neg_logit = (states[:, :, None, :] * neg).sum(-1) / temperature
    neg_logit = torch.where(negatives == target[..., None], -5e4, neg_logit)
    nll = -F.log_softmax(torch.cat([pos_logit, neg_logit], -1), dim=-1)[..., 0]
    w = (target >= 0).float()
    return (nll * w).sum() / w.sum().clamp(min=1)


def flat(params, prefix=""):
    if isinstance(params, dict):
        out = {}
        for k in sorted(params):
            out.update(flat(params[k], f"{prefix}{k}/"))
        return out
    if isinstance(params, list):
        out = {}
        for i, v in enumerate(params):
            out.update(flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: params}


def unflat(template, values: dict, prefix=""):
    if isinstance(template, dict):
        return {k: unflat(v, values, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, list):
        return [unflat(v, values, f"{prefix}{i}/") for i, v in enumerate(template)]
    return values[prefix[:-1]]


def train(params: dict, batches: list, lr: float, **kw) -> tuple[list, dict, list]:
    """Adam (0.9, 0.999, eps 1e-8, no decay) over ``batches`` of (ids, ts,
    negatives, keep_in, keep_lin): (losses, final params, first gradients)."""
    p = {k: v.clone() for k, v in flat(params).items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t, (ids, ts, negs, keep_in, keep_lin) in enumerate(batches, start=1):
        leaves = {k: x.clone().requires_grad_() for k, x in p.items()}
        value = loss(unflat(params, leaves), ids, ts, negs, keep_in=keep_in,
                     keep_lin=keep_lin, **kw)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
        first = first or grads
        losses.append(float(value.detach()))
        with torch.no_grad():
            for k in p:
                m[k] = 0.9 * m[k] + 0.1 * grads[k]
                v2[k] = 0.999 * v2[k] + 0.001 * grads[k] ** 2
                p[k] = p[k] - lr * (m[k] / (1 - 0.9 ** t)) / (
                    torch.sqrt(v2[k] / (1 - 0.999 ** t)) + 1e-8)
    return losses, unflat(params, p), first
