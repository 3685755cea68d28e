"""The plain reference of the HSTU cell: float32 PyTorch with TF32 off,
nothing of the port, for the comparison that decides ``correct``.

It follows the published code (Zhai et al., ICML 2024, arXiv:2402.17152;
github.com/facebookresearch/generative-recommenders) with the port's
departures, each written in ``tests/hstu_reference.py`` too: windows right
padded with id -1, slot i + 1's timestamp the query time of position i, the
relative position bias ``pos_w[L - 1 + j - i]``, untruncated normals. Beside
that reference it adds what the check needs: the seeded weights
(``init``), the port's draws from a generator in the port's order
(``draw_step``), the fp8 control (``pinsage.Precision``), the faults of
calibration (half the positions out of the loss, the relative bias left
out), Adam, and the user encoding in blocks of users.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .pinsage import Precision, tf32_off

__all__ = ["Precision", "tf32_off", "Dims", "init", "draw_step", "forward", "loss",
           "train_steps", "item_table", "user_states", "leaves", "TIME_BUCKETS",
           "LINEAR_DROPOUT"]

TIME_BUCKETS = 128        # the published log time buckets of the relative bias
LINEAR_DROPOUT = 0.2      # the published dropout on each block's f2 input


class Dims(NamedTuple):
    d: int
    blocks: int
    heads: int
    dqk: int
    dv: int
    max_len: int
    buckets: int
    rate_in: float
    rate_lin: float


def init(seed: int, num_items: int, dm: Dims, device) -> dict:
    """The check's weights, drawn on the device from ``seed``: item and f1
    rows N(0, 0.02), positions N(0, 1/d), f2 N(0, 1/(H dv)) with a zero
    bias, and the relative bias N(0, 1), the scale a trained model's bias
    reaches, so that the bias moves the states the check compares."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std):
        return std * torch.randn(shape, generator=g, device=device)

    hv = dm.heads * dm.dv
    return {"item_emb": normal((num_items, dm.d), 0.02),
            "pos_emb": normal((dm.max_len, dm.d), dm.d ** -0.5),
            "blocks": [{"uvqk": normal((dm.d, 2 * dm.heads * (dm.dv + dm.dqk)), 0.02),
                        "o": {"w": normal((hv, dm.d), hv ** -0.5),
                              "b": torch.zeros(dm.d, device=device)},
                        "ts_w": normal((dm.buckets + 1,), 1.0),
                        "pos_w": normal((2 * dm.max_len - 1,), 1.0)}
                       for _ in range(dm.blocks)]}


def leaves(params, prefix: str = "") -> dict[str, torch.Tensor]:
    """``{key path: leaf}``, keys sorted as the port's trees flatten."""
    if isinstance(params, dict):
        out = {}
        for k in sorted(params):
            out.update(leaves(params[k], f"{prefix}{k}/"))
        return out
    if isinstance(params, list):
        out = {}
        for i, v in enumerate(params):
            out.update(leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: params}


def rebuild(template, flat: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: rebuild(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, list):
        return [rebuild(v, flat, f"{prefix}{i}/") for i, v in enumerate(template)]
    return flat[prefix[:-1]]


class Draws(NamedTuple):
    negatives: torch.Tensor
    keep_in: torch.Tensor | None
    keep_lin: list | None


def draw_step(generator: torch.Generator, b: int, length: int, num_negatives: int,
              num_items: int, dm: Dims, device) -> Draws:
    """One step's draws as the port makes them: the negatives, the input
    mask, each block's mask (``uniform >= rate`` keeps)."""
    negs = torch.randint(0, num_items, (b, length, num_negatives), generator=generator,
                         device=device, dtype=torch.int32)
    keep_in = (torch.rand((b, length, dm.d), generator=generator, device=device) >= dm.rate_in
               if dm.rate_in > 0 else None)
    keep_lin = ([torch.rand((b, length, dm.heads * dm.dv), generator=generator,
                            device=device) >= dm.rate_lin for _ in range(dm.blocks)]
                if dm.rate_lin > 0 else None)
    return Draws(negs, keep_in, keep_lin)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-6)


def forward(params: dict, ids: torch.Tensor, ts: torch.Tensor, dm: Dims, prec: Precision,
            draws: Draws | None = None, bias: bool = True) -> torch.Tensor:
    """[B, L, d] normalised states of ``ids`` [B, L] (-1 padded) and ``ts``
    [B, L + 1]; ``bias=False`` leaves the relative bias out (a fault)."""
    b, n = ids.shape
    valid = (ids >= 0)[..., None]
    table = prec.q(params["item_emb"])
    x = table[ids.clamp(min=0).long()] * valid * math.sqrt(dm.d) + params["pos_emb"][:n][None]
    if draws is not None and draws.keep_in is not None:
        x = x * draws.keep_in / (1 - dm.rate_in)
    x = x * valid
    gap = (ts[:, 1:].unsqueeze(2) - ts[:, :-1].unsqueeze(1)).abs().clamp(min=1)
    bucket = (torch.log(gap.float()) / 0.301).long().clamp(0, dm.buckets)
    r = torch.arange(n, device=ids.device)
    rel = n - 1 + r[None, :] - r[:, None]
    mask = torch.tril(torch.ones(n, n, device=ids.device))
    hv, hq = dm.heads * dm.dv, dm.heads * dm.dqk
    for i, blk in enumerate(params["blocks"]):
        h = F.silu(prec.q(F.layer_norm(x, [dm.d], eps=1e-6)) @ prec.q(blk["uvqk"]))
        u, v, q, k = torch.split(h, [hv, hv, hq, hq], dim=-1)
        q = prec.q(q).view(b, n, dm.heads, dm.dqk)
        k = prec.q(k).view(b, n, dm.heads, dm.dqk)
        v = prec.q(v).view(b, n, dm.heads, dm.dv)
        s = torch.einsum("bnhd,bmhd->bhnm", q, k)
        if bias:
            s = s + (blk["ts_w"][bucket] + blk["pos_w"][rel][None])[:, None]
        a = prec.q(F.silu(s) / n * mask)
        o = torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(b, n, hv)
        o = F.layer_norm(o, [hv], eps=1e-6) * u
        if draws is not None and draws.keep_lin is not None:
            o = o * draws.keep_lin[i] / (1 - dm.rate_lin)
        x = x + prec.q(o) @ prec.q(blk["o"]["w"]) + blk["o"]["b"]
    return _unit(x)


def item_table(params: dict) -> torch.Tensor:
    return _unit(params["item_emb"])


def loss(params: dict, ids: torch.Tensor, ts: torch.Tensor, draws: Draws, dm: Dims,
         temperature: float, prec: Precision, half: bool = False,
         bias: bool = True) -> torch.Tensor:
    """The sampled softmax at every supervised position of windows ``ids``,
    ``ts`` [B, L + 1], each against its own negatives (an accidental hit
    at -5e4); ``half`` keeps the even positions only (a fault)."""
    n = ids.shape[1] - 1
    states = prec.q(forward(params, ids[:, :n], ts, dm, prec, draws, bias))
    target = ids[:, 1:]
    table = prec.q(item_table(params))
    pos = table[target.clamp(min=0).long()] * (target >= 0)[..., None]
    neg = table[draws.negatives.long()]
    logits = torch.cat([(states * pos).sum(-1, keepdim=True),
                        torch.einsum("bnd,bnrd->bnr", states, neg)], -1) / temperature
    hit = torch.cat([torch.zeros_like(target[..., None], dtype=torch.bool),
                     draws.negatives == target[..., None]], -1)
    nll = -F.log_softmax(torch.where(hit, -5e4, logits), dim=-1)[..., 0]
    w = (target >= 0).float()
    if half:
        w = w * (torch.arange(n, device=ids.device) % 2 == 0)
    return (nll * w).sum() / w.sum().clamp(min=1)


def train_steps(params0: dict, batches: list, draws: list, lr: float, dm: Dims,
                temperature: float, prec: Precision, half: bool = False,
                bias: bool = True) -> dict:
    """Adam (0.9, 0.999, eps 1e-8; the port's f32 bias corrections) from
    ``params0`` over ``batches`` of (ids, ts): the losses, the first
    gradients and the final params, by key path."""
    p = {k: v.detach().clone() for k, v in leaves(params0).items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t, ((ids, ts), d) in enumerate(zip(batches, draws), start=1):
        live = {k: x.clone().requires_grad_() for k, x in p.items()}
        value = loss(rebuild(params0, live), ids, ts, d, dm, temperature, prec, half, bias)
        grads = dict(zip(live, torch.autograd.grad(value, list(live.values()),
                                                   allow_unused=True, materialize_grads=True)))
        first = first if first is not None else {k: g.detach() for k, g in grads.items()}
        losses.append(float(value.detach()))
        tt = torch.tensor(float(t), device=value.device)
        c1, c2 = 1.0 - torch.pow(0.9, tt), 1.0 - torch.pow(0.999, tt)
        with torch.no_grad():
            for k in p:
                m[k] = 0.9 * m[k] + 0.1 * grads[k]
                v2[k] = 0.999 * v2[k] + 0.001 * grads[k] * grads[k]
                p[k] = p[k] - lr * (m[k] / c1) / (torch.sqrt(v2[k] / c2) + 1e-8)
    return {"losses": losses, "first_grads": first, "params": p}


@torch.no_grad()
def user_states(params: dict, ids: torch.Tensor, ts: torch.Tensor, pos: torch.Tensor,
                dm: Dims, prec: Precision, block: int = 512, bias: bool = True) -> torch.Tensor:
    """[Q, d] states at ``pos`` of windows ``ids``, ``ts`` [Q, L + 1], in
    blocks of ``block`` users."""
    n = ids.shape[1] - 1
    out = []
    for s in range(0, ids.shape[0], block):
        st = forward(params, ids[s:s + block, :n], ts[s:s + block], dm, prec, bias=bias)
        out.append(st[torch.arange(st.shape[0], device=st.device), pos[s:s + block]])
    return torch.cat(out)


@torch.no_grad()
def hit_rate(states: torch.Tensor, items: torch.Tensor, targets: torch.Tensor, k: int,
             dtype=torch.float64, block: int = 1024) -> float:
    """HR@k of each target among all items by dot product with its state,
    ranks taken in ``dtype``."""
    hits = 0
    it = items.to(dtype)
    for s in range(0, states.shape[0], block):
        q = states[s:s + block].to(dtype)
        sims = q @ it.T
        gt = (q * it[targets[s:s + block]]).sum(1)
        hits += int(((1 + (sims > gt[:, None]).sum(1)) <= k).sum())
    return hits / max(states.shape[0], 1)
