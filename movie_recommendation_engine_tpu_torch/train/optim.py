"""Adam over a parameter tree, and the reduce-on-plateau / early-stop host
logic.

Port of ``movie_recommendation_engine_tpu/train/optim.py``. ``adam_update``
computes JAX's formula with JAX's constants (betas 0.9 / 0.999, eps 1e-8,
bias corrections in f32 from one shared step count), as a few multi-tensor
(``torch._foreach_*``) operations over all leaves. Unlike the JAX function it
updates the params and moments in place, which saves holding a second copy
of each; it returns them as JAX's does. ``state_to_jax`` / ``state_from_jax``
carry the state in JAX's checkpoint layout: ``opt/step`` int32,
``opt/mu/<param path>``, ``opt/nu/<param path>``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import tree


class AdamState(NamedTuple):
    step: int         # updates taken so far
    mu: Any           # first-moment tree, the params' structure
    nu: Any           # second-moment tree


def adam_init(params: Any) -> AdamState:
    return AdamState(step=0, mu=tree.map_tree(torch.zeros_like, params),
                     nu=tree.map_tree(torch.zeros_like, params))


@torch.no_grad()
def adam_update(grads: Any, state: AdamState, params: Any, lr: float,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> tuple[Any, AdamState]:
    """``p - lr * (m / c1) / (sqrt(v / c2) + eps)`` with ``c = 1 - beta ** t``
    (torch.optim.Adam's defaults), in place; returns (params, state)."""
    p, g = tree.leaves(params), tree.leaves(grads)
    m, v = tree.leaves(state.mu), tree.leaves(state.nu)
    step = state.step + 1
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1 - b2)
    t = np.float32(step)
    c1 = float(np.float32(1) - np.float32(b1) ** t)
    c2 = float(np.float32(1) - np.float32(b2) ** t)
    upd = torch._foreach_div(m, c1)
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_mul_(upd, lr)
    torch._foreach_div_(upd, denom)
    torch._foreach_sub_(p, upd)
    return params, AdamState(step, state.mu, state.nu)


def state_to_jax(state: AdamState) -> dict[str, np.ndarray]:
    """The state as checkpoint leaves under JAX's key paths."""
    flat = {"opt/step": np.asarray(state.step, np.int32)}
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
    return AdamState(int(flat["opt/step"]), moments["mu"], moments["nu"])


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
