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

The kernel wrappers count launches on the host (``ops.pool.LAUNCHES`` and
the others). A capture runs the wrappers once and launches nothing, so
``StepGraphs`` takes back what the capture counted and adds it on every
replay: the counts stay launches.
"""

from __future__ import annotations

import ctypes
import time
from typing import Any, Callable, NamedTuple

import torch

from ..ops import block_sparse, hamming, hub_pool, pool

# The wrappers' launch counters: (module, attribute).
COUNTERS = ((pool, "LAUNCHES"), (pool, "BWD_LAUNCHES"), (pool, "SEGMENT_LAUNCHES"),
            (pool, "PLAN_LAUNCHES"), (hamming, "LAUNCHES"))
_COUNTER_NAMES = ("gather_pool", "gather_pool_bwd", "gather_pool_bwd_segment",
                  "segment_plan", "hamming_distance")


def read_counts() -> tuple[int, ...]:
    return tuple(getattr(m, a) for m, a in COUNTERS)


def _set_counts(values) -> None:
    for (m, a), v in zip(COUNTERS, values):
        setattr(m, a, v)


def rung(pool_mats) -> str:
    """The pooling rung of a trainer's operators, one word a layer
    (``dense``, ``hub``, ``block``), or ``gather`` where there are none."""
    words = ["hub" if isinstance(pm, hub_pool.HubPool)
             else "block" if isinstance(pm, block_sparse.BlockPool) else "dense"
             for pm in pool_mats]
    return ",".join(words) or "gather"


def tensors(obj: Any) -> list[torch.Tensor]:
    """Every tensor in nested dicts, lists and tuples (named tuples too)."""
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        obj = [obj[k] for k in sorted(obj)]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in tensors(x)]
    return []


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


def _kernel_nodes(raw_graph: int) -> tuple[int, int]:
    """(kernel nodes, all nodes) of a captured ``cudaGraph_t``, read with
    libcuda's ``cuGraphGetNodes`` and ``cuGraphNodeGetType``."""
    cuda = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    rc = rc or cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    if rc:
        raise RuntimeError(f"cuGraphGetNodes failed (CUresult {rc})")
    kernels, kind = 0, ctypes.c_int(0)
    for i in range(n.value):
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]), ctypes.byref(kind)) == 0:
            kernels += kind.value == 0          # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels, n.value


class Captured(NamedTuple):
    graph: Any                      # torch.cuda.CUDAGraph
    inputs: tuple                   # static input buffers, filled before each replay
    output: torch.Tensor            # static output, rewritten by each replay
    counts: tuple[int, ...]         # the wrappers' launches a replay makes


class StepGraphs:
    """The graphs of one trainer on ``device``; ``generator`` is the CUDA
    generator the step draws from; ``log`` gets one ``step_graph`` event a
    capture. All graphs share one memory pool: they replay one at a time on
    one stream, and each output is copied out before the next replay."""

    def __init__(self, device: torch.device, generator: torch.Generator, log):
        self.device = device
        self.generator = generator
        self.log = log
        self.graphs: dict[tuple, Captured] = {}
        self.warm: set[tuple] = set()       # keys whose eager first call ran
        self.addresses: tuple | None = None
        self.pool = None
        self.pool_bytes = 0                 # reserved memory the captures added

    def drop(self) -> None:
        """Forget every graph (their memory returns to the allocator)."""
        self.graphs.clear()
        self.warm.clear()
        self.addresses = None
        self.pool = None
        self.pool_bytes = 0

    def check(self, state: Any, generator: torch.Generator) -> None:
        """Drops the graphs when the tensors of ``state`` (what the graphs
        read) no longer lie where they lay at capture, or the step draws
        from another generator than the one registered with them."""
        addresses = tuple(t.data_ptr() for t in tensors(state))
        if addresses != self.addresses or generator is not self.generator:
            self.drop()
            self.addresses, self.generator = addresses, generator

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
                g = self._capture(key, step, (q_blk[s], p_blk[s]), generator=True)
            g.inputs[0].copy_(q_blk[s])
            g.inputs[1].copy_(p_blk[s])
            self._replay(g)
            losses[s] = g.output
        return losses

    def embed(self, fn: Callable, key: tuple) -> torch.Tensor:
        """``fn()`` (the embedding pass): eager on the first call under
        ``key``, then captured and replayed; a copy of the output."""
        g = self.graphs.get(key)
        if g is None and key not in self.warm:
            self.warm.add(key)
            return fn()
        if g is None:
            g = self._capture(key, fn, (), generator=False)
        self._replay(g)
        return g.output.clone()

    def _replay(self, g: Captured) -> None:
        g.graph.replay()
        _set_counts(c + d for c, d in zip(read_counts(), g.counts))

    def _capture(self, key: tuple, fn: Callable, inputs: tuple, generator: bool) -> Captured:
        static = tuple(x.clone() for x in inputs)
        before = read_counts()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator:
            graph.register_generator_state(self.generator)
        # Empty the cache first (the capture does too) so that the growth of
        # reserved memory is the pool's.
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = fn(*static)
            graph.instantiate()
        except Exception as e:
            self.drop()
            raise RuntimeError(f"capturing the {key[0]} graph {key} failed: {e}") from e
        finally:
            counted = read_counts()
            _set_counts(before)
        seconds = time.perf_counter() - t0
        grown = torch.cuda.memory_reserved(self.device) - reserved
        self.pool_bytes += grown
        kernels, nodes = _kernel_nodes(graph.raw_cuda_graph())
        counts = tuple(c - b for c, b in zip(counted, before))
        self.log.log("step_graph", key=list(key), kernels=kernels, nodes=nodes,
                     capture_seconds=seconds, pool_bytes_added=grown,
                     pool_bytes=self.pool_bytes,
                     launches={n: c for n, c in zip(_COUNTER_NAMES, counts) if c})
        g = Captured(graph, static, out, counts)
        self.graphs[key] = g
        return g
