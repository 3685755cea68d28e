"""CUDA graphs of the train step and of the embedding pass: capture once,
replay.

Port of how the JAX trainer runs on its device. ``Trainer._run_steps``
(``movie_recommendation_engine_tpu/train/trainer.py``) is one jitted
program per block of steps, compiled once for each ``num_hard`` (the only
static argument; ``lr`` and ``epoch`` are traced, the params and Adam state
donated), and ``_embed_all`` is one program for the whole corpus. Run op by
op from Python, the port's step launches ~240-310 kernels from the host, and
the host, not the card, sets its pace. A CUDA graph is this card's
counterpart of a jitted program with static shapes: captured once for each
static signature, it reads its inputs at fixed addresses and replays with
one host call.

``StepGraphs`` keeps one graph per static key: (``num_hard``, batch size,
pooling rung) for a step, the rung for the embedding pass. A step graph
records one whole step, negatives from the trainer's generator (registered
with the graph, so that each replay draws new numbers and leaves the
generator where an eager step would), forward, loss, backward through the
gather-pool kernels, and the in-place Adam update; it reads the batch from
two static [B] int32 buffers that each step fills, and leaves the loss in a
static scalar. Per-step graphs (not one graph for a block of S steps) let
the first step under a new key run eager, as a real step that also warms the
caches, with capture right after it, and let a block of any length replay.
The embedding graph writes a static [num_movies, E] output; each call
returns a copy of it.

A graph must never replay against stale addresses. The trainer drops the
graphs (``drop``) where what they read is replaced (a new checkpoint's
params, tables whose shapes changed), copies new tables into the captured
storages where shapes match (``copy_into``), and ``check`` drops them when
the addresses of what a step reads differ from those at capture (a caller
that assigned new params) or the generator object changed. A reseed keeps
them: ``manual_seed`` resets the registered generator state in place, and
the next replay draws from the new seed as an eager step would.

The capture, the replay, the shared pool and the launch accounting (a
replay adds what its capture counted, so the wrappers' counts stay
launches) are ``core/graphs.GraphCache``'s, shared with the indexes'
search graphs.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.graphs import Captured, GraphCache, ProgramGraphs, read_counts, tensors
from ..ops import block_sparse, hub_pool

__all__ = ["Captured", "StepGraphs", "copy_into", "read_counts", "rung", "tensors"]


def rung(pool_mats) -> str:
    """The pooling rung of a trainer's operators, one word a layer
    (``dense``, ``hub``, ``block``), or ``gather`` where there are none."""
    words = ["hub" if isinstance(pm, hub_pool.HubPool)
             else "block" if isinstance(pm, block_sparse.BlockPool) else "dense"
             for pm in pool_mats]
    return ",".join(words) or "gather"


def _same_structure(a: Any, b: Any) -> bool:
    if torch.is_tensor(a) or torch.is_tensor(b):
        return (torch.is_tensor(a) and torch.is_tensor(b) and a.shape == b.shape
                and a.dtype == b.dtype and a.device == b.device)
    if isinstance(a, dict) or isinstance(b, dict):
        return (type(a) is type(b) and sorted(a) == sorted(b)
                and all(_same_structure(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    return a == b


def copy_into(dst: Any, src: Any) -> bool:
    """Copies every tensor of ``src`` into the tensor at the same place in
    ``dst`` and returns True when the two have one structure (the same
    containers, tensor shapes and dtypes, and equal other leaves); else
    copies nothing and returns False."""
    if dst is None or not _same_structure(dst, src):
        return False
    for d, s in zip(tensors(dst), tensors(src)):
        if d.data_ptr() != s.data_ptr():
            d.copy_(s)
    return True


class StepGraphs(GraphCache):
    """The graphs of one trainer on ``device``; ``generator`` is the CUDA
    generator the step draws from; ``log`` gets one ``step_graph`` event a
    capture. All graphs share one memory pool: they replay one at a time on
    one stream, and each output is copied out before the next replay."""

    def __init__(self, device: torch.device, generator: torch.Generator, log):
        super().__init__(device, log, "step_graph")
        self.generator = generator
        # The trainer's per-epoch programs: the refresh and the validation
        # ranks (a pool of their own; they read no params and no tables).
        self.programs = ProgramGraphs(device, log)

    def drop(self, programs: bool = True) -> None:
        """Forgets the step and embedding graphs and, with ``programs``, the
        refresh and ranks graphs too."""
        super().drop()
        if programs:
            self.programs.drop()

    def check(self, state: Any, generator: torch.Generator) -> None:
        """Drops the step and embedding graphs when the tensors of ``state``
        (what they read) no longer lie where they lay at capture, or the
        step draws from another generator than the one registered with them.
        The programs keep their own record of what they read."""
        addresses = tuple(t.data_ptr() for t in tensors(state))
        if generator is not self.generator or addresses != self.addresses:
            self.drop(programs=False)
            self.generator, self.addresses = generator, addresses

    def steps(self, step: Callable, q_blk: torch.Tensor, p_blk: torch.Tensor,
              key: tuple) -> torch.Tensor:
        """``step(q, p) -> loss`` over the rows of ``q_blk``, ``p_blk`` [S, B]:
        the first step under a new ``key`` eager, then captured and replayed.
        Returns the [S] f32 losses, without waiting for them."""
        losses = torch.empty(q_blk.shape[0], dtype=torch.float32, device=self.device)
        for s in range(q_blk.shape[0]):
            g = self.graphs.get(key)
            if g is None and key not in self.warm:
                losses[s] = step(q_blk[s], p_blk[s])
                self.warm.add(key)
                continue
            if g is None:
                g = self.capture(key, step, (q_blk[s], p_blk[s]), generator=self.generator)
            g.inputs[0].copy_(q_blk[s])
            g.inputs[1].copy_(p_blk[s])
            self.replay(g)
            losses[s] = g.output
        return losses

    def embed(self, fn: Callable, key: tuple) -> torch.Tensor:
        """``fn()`` (the embedding pass): eager on the first call under
        ``key``, then captured and replayed; a copy of the output."""
        return self.call(key, fn)
