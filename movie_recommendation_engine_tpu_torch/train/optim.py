"""Adam over a parameter tree, and the reduce-on-plateau / early-stop host
logic.

Port of ``movie_recommendation_engine_tpu/train/optim.py``. ``adam_update``
computes JAX's formula with JAX's constants (betas 0.9 / 0.999, eps 1e-8,
bias corrections in f32 from one shared step count), as a few multi-tensor
(``torch._foreach_*``) operations over all leaves. Unlike the JAX function it
updates the params, the moments and the step count in place, which saves
holding a second copy of each; it returns them as JAX's does. The step count
is a 0-d int32 tensor on the params' device, the bias corrections are
computed from it there, and ``lr`` may be a 0-d f32 tensor there too: no
number of the update lives on the host, so one update can be captured in a
CUDA graph and replayed (``train/loop.py``), as JAX traces ``step``
and ``lr`` into its jitted step. ``state_to_jax`` / ``state_from_jax``
carry the state in JAX's checkpoint layout: ``opt/step`` int32,
``opt/mu/<param path>``, ``opt/nu/<param path>``.

DLRM-DCNv2 (``models/dlrm.py``) trains as MLPerf's reference does: Adagrad
on the dense parameters (``adagrad_update``, torch.optim.Adagrad's formula)
and FBGEMM's exact row-wise Adagrad on the tables (``rowwise_adagrad_update``),
which reads and writes only the rows a batch touched, through
``ops.pool.compact_rows``. Both keep their accumulators in f32, start them
at 0 and add ``ADAGRAD_EPS`` to the root; ``adagrad_to_flat`` /
``adagrad_from_flat`` carry them as ``opt/sum/<param path>`` and
``opt/rows/<table>``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import tree


class AdamState(NamedTuple):
    step: torch.Tensor  # 0-d int32: updates taken so far
    mu: Any           # first-moment tree, the params' structure
    nu: Any           # second-moment tree


def _step_count(value: int, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.int32, device=device)


def adam_init(params: Any) -> AdamState:
    device = tree.leaves(params)[0].device
    return AdamState(step=_step_count(0, device), mu=tree.map_tree(torch.zeros_like, params),
                     nu=tree.map_tree(torch.zeros_like, params))


@torch.no_grad()
def adam_update(grads: Any, state: AdamState, params: Any, lr: float | torch.Tensor,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> tuple[Any, AdamState]:
    """``p - lr * (m / c1) / (sqrt(v / c2) + eps)`` with ``c = 1 - beta ** t``
    (torch.optim.Adam's defaults), in place; returns (params, state), the
    same objects. ``lr`` is a float or a 0-d f32 tensor on the params'
    device; ``t`` is the incremented step count as f32, and ``c1``, ``c2``
    are computed from it in f32 in JAX's order."""
    p, g = tree.leaves(params), tree.leaves(grads)
    m, v = tree.leaves(state.mu), tree.leaves(state.nu)
    state.step.add_(1)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1 - b2)
    t = state.step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    upd = torch._foreach_div(m, c1)
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_mul_(upd, lr)
    torch._foreach_div_(upd, denom)
    torch._foreach_sub_(p, upd)
    return params, state


def state_to_jax(state: AdamState) -> dict[str, np.ndarray]:
    """The state as checkpoint leaves under JAX's key paths."""
    flat = {"opt/step": np.asarray(int(state.step), np.int32)}
    for name, moments in (("mu", state.mu), ("nu", state.nu)):
        for k, x in tree.flatten(moments).items():
            flat[f"opt/{name}/{k}"] = x.detach().cpu().numpy().astype(np.float32)
    return flat


def state_from_jax(flat: dict[str, np.ndarray], device) -> AdamState:
    """The state from a checkpoint's ``opt/`` leaves."""
    moments = {}
    for name in ("mu", "nu"):
        prefix = f"opt/{name}/"
        moments[name] = tree.unflatten({
            k[len(prefix):]: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in flat.items() if k.startswith(prefix)})
    return AdamState(_step_count(int(flat["opt/step"]), device), moments["mu"], moments["nu"])


class PlateauState(NamedTuple):
    """ReduceLROnPlateau bookkeeping (mode='min', factor 0.5, patience 2 by
    default)."""

    lr: float
    best: float
    num_bad: int


def plateau_init(lr: float) -> PlateauState:
    return PlateauState(lr=lr, best=float("inf"), num_bad=0)


def plateau_step(state: PlateauState, metric: float, factor: float = 0.5,
                 patience: int = 2, min_lr: float = 0.0) -> PlateauState:
    if metric < state.best - 1e-12:
        return PlateauState(lr=state.lr, best=metric, num_bad=0)
    num_bad = state.num_bad + 1
    if num_bad > patience:
        return PlateauState(lr=max(state.lr * factor, min_lr), best=state.best, num_bad=0)
    return PlateauState(lr=state.lr, best=state.best, num_bad=num_bad)


class EarlyStopping:
    """Patience-based early stop on a maximized validation metric."""

    def __init__(self, patience: int = 3):
        self.patience = patience
        self.best = -float("inf")
        self.num_bad = 0

    def update(self, metric: float) -> bool:
        """Returns True when training should stop."""
        if metric > self.best:
            self.best = metric
            self.num_bad = 0
            return False
        self.num_bad += 1
        return self.num_bad >= self.patience


# ---- Adagrad (DLRM-DCNv2) ---------------------------------------------------

ADAGRAD_EPS = 1e-8        # MLPerf's DLRM-DCNv2 reference, dense and row-wise


class AdagradState(NamedTuple):
    sum: Any            # the dense parameters' squared-gradient sums, their structure
    rows: list          # per table, [rows] f32: the mean squared gradient summed per row


def adagrad_init(dense: Any, tables: list) -> AdagradState:
    return AdagradState(tree.map_tree(torch.zeros_like, dense),
                        [torch.zeros(t.shape[0], dtype=torch.float32, device=t.device)
                         for t in tables])


@torch.no_grad()
def adagrad_update(grads: Any, acc: Any, params: Any, lr: float | torch.Tensor,
                   eps: float = ADAGRAD_EPS) -> None:
    """torch.optim.Adagrad (no decay, accumulators from 0) in place:
    ``acc += g * g``, then ``p -= lr * (g / (sqrt(acc) + eps))``; ``lr`` a
    float or a 0-d f32 tensor on the params' device."""
    p, g, a = tree.leaves(params), tree.leaves(grads), tree.leaves(acc)
    torch._foreach_addcmul_(a, g, g)
    denom = torch._foreach_sqrt(a)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(g, denom)
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(p, upd)


@torch.no_grad()
def rowwise_adagrad_update(table: torch.Tensor, acc: torch.Tensor, rows: torch.Tensor,
                           d_rows: torch.Tensor, lr: float | torch.Tensor,
                           eps: float = ADAGRAD_EPS) -> None:
    """FBGEMM's exact row-wise Adagrad on the rows of ``table`` named by
    ``rows`` [M] int64, whose summed gradients are ``d_rows`` [M, D] f32:
    ``acc[r] += mean(g * g)``, then ``w[r] -= (lr / (sqrt(acc[r]) + eps)) *
    g``. The rows are read and written through ``rows`` alone, and written
    back by ``index_copy_``, which accumulates nothing: ``rows`` names each
    touched row once, and its padding names spare rows whose gradient is 0,
    so every write to one carries its own unchanged value."""
    a = acc.index_select(0, rows) + (d_rows * d_rows).mean(1)
    mult = lr / (a.sqrt() + eps)
    w = table.index_select(0, rows) - mult[:, None] * d_rows
    table.index_copy_(0, rows, w)
    acc.index_copy_(0, rows, a)


def adagrad_to_flat(state: AdagradState) -> dict[str, np.ndarray]:
    flat = {f"opt/sum/{k}": x.detach().cpu().numpy().astype(np.float32)
            for k, x in tree.flatten(state.sum).items()}
    flat.update({f"opt/rows/{i}": x.detach().cpu().numpy() for i, x in enumerate(state.rows)})
    return flat


def adagrad_from_flat(flat: dict[str, np.ndarray], device) -> AdagradState:
    sums = tree.unflatten({k[len("opt/sum/"):]: torch.tensor(np.asarray(v), dtype=torch.float32,
                                                             device=device)
                           for k, v in flat.items() if k.startswith("opt/sum/")})
    rows = [torch.tensor(np.asarray(flat[f"opt/rows/{i}"]), dtype=torch.float32, device=device)
            for i in range(sum(k.startswith("opt/rows/") for k in flat))]
    return AdagradState(sums, rows)
