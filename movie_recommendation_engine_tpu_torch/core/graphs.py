"""CUDA graphs: capture a program once per static key, replay it.

The JAX package compiles each of its hot programs once per static signature
(the train step per ``num_hard``, each search per batch bucket and ``k``)
and then runs it with one dispatch. Run op by op from Python, the port's
counterparts launch tens to hundreds of kernels from the host, and the host,
not the card, sets their pace. A CUDA graph is this card's counterpart of a
jitted program with static shapes: captured once for each static key, it
reads its inputs at fixed addresses and replays with one host call.

``GraphCache`` holds what the trainer's ``StepGraphs``
(``train/step_graph.py``), the indexes' ``SearchGraphs`` and the
``ProgramGraphs`` share: one graph per key in one memory pool, the keys
whose eager first call ran, the addresses of what the graphs read (a change
drops them), the capture itself, which logs one event per graph, and
``call``: the first call under a key eager, the second captured, every call
from then on a replay on its inputs copied into the static buffers, its
outputs copied out. ``SearchGraphs`` runs one search program per (query
rows, ``k``, the index's static form); ``ProgramGraphs`` runs JAX's other
jitted programs, one graph per static key: the trainer's neighbourhood
refresh, the validation ranks, ``recommend`` and k-means.

The kernel wrappers count launches on the host (``ops.pool.LAUNCHES`` and
the others). A capture runs the wrappers once and launches nothing, so the
cache takes back what the capture counted and adds it on every replay: the
counts stay launches.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..ops import hamming, pool

# The wrappers' launch counters: (module, attribute).
COUNTERS = ((pool, "LAUNCHES"), (pool, "BWD_LAUNCHES"), (pool, "SEGMENT_LAUNCHES"),
            (pool, "PLAN_LAUNCHES"), (hamming, "LAUNCHES"))
COUNTER_NAMES = ("gather_pool", "gather_pool_bwd", "gather_pool_bwd_segment",
                 "segment_plan", "hamming_distance")


def read_counts() -> tuple[int, ...]:
    return tuple(getattr(m, a) for m, a in COUNTERS)


def set_counts(values) -> None:
    for (m, a), v in zip(COUNTERS, values):
        setattr(m, a, v)


def tensors(obj: Any) -> list[torch.Tensor]:
    """Every tensor in nested dicts, lists and tuples (named tuples too)."""
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        obj = [obj[k] for k in sorted(obj)]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in tensors(x)]
    return []


def kernel_nodes(raw_graph: int) -> tuple[int, int]:
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


def copies(out: Any) -> Any:
    """A copy of a tensor, or a tuple of copies of a tuple's tensors."""
    if torch.is_tensor(out):
        return out.clone()
    return tuple(o.clone() for o in out)


class Captured(NamedTuple):
    graph: Any                      # torch.cuda.CUDAGraph
    inputs: tuple                   # static input buffers, filled before each replay
    output: Any                     # static output(s), rewritten by each replay
    counts: tuple[int, ...]         # the wrappers' launches a replay makes


class GraphCache:
    """The graphs of one owner on ``device``, all in one memory pool (they
    replay one at a time on one stream, and each output is copied out before
    the next replay). ``event`` names the log event of a capture; each goes
    to ``events`` and, when ``log`` is set, to ``log.log``."""

    def __init__(self, device: torch.device, log, event: str):
        self.device = device
        self.log = log
        self.event = event
        self.events: list[dict] = []
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

    def check_addresses(self, addresses: tuple) -> None:
        """Drops the graphs when what they read no longer lies where it lay
        at capture (``addresses`` is the owner's record of it)."""
        if addresses != self.addresses:
            self.drop()
            self.addresses = addresses

    def replay(self, g: Captured) -> None:
        g.graph.replay()
        set_counts(c + d for c, d in zip(read_counts(), g.counts))

    def capture(self, key: tuple, fn: Callable, inputs: tuple,
                generator: torch.Generator | None = None) -> Captured:
        """Captures ``fn(*static)`` on clones of ``inputs`` (the static
        buffers) and keeps it under ``key``; ``generator`` is registered with
        the graph. A failure drops every graph and raises."""
        static = tuple(x.clone() for x in inputs)
        before = read_counts()
        try:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            if generator is not None:
                graph.register_generator_state(generator)
            # Empty the cache first (the capture does too) so that the growth
            # of reserved memory is the pool's.
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, pool=self.pool):
                out = fn(*static)
            graph.instantiate()
        except Exception as e:
            self.drop()
            raise RuntimeError(f"capturing the {key[0]} graph {key} failed: {e}") from e
        finally:
            counted = read_counts()
            set_counts(before)
        seconds = time.perf_counter() - t0
        grown = torch.cuda.memory_reserved(self.device) - reserved
        self.pool_bytes += grown
        kernels, nodes = kernel_nodes(graph.raw_cuda_graph())
        counts = tuple(c - b for c, b in zip(counted, before))
        event = dict(key=list(key), kernels=kernels, nodes=nodes,
                     capture_seconds=seconds, pool_bytes_added=grown,
                     pool_bytes=self.pool_bytes,
                     launches={n: c for n, c in zip(COUNTER_NAMES, counts) if c})
        self.events.append(event)
        if self.log is not None:
            self.log.log(self.event, **event)
        g = Captured(graph, static, out, counts)
        self.graphs[key] = g
        return g

    def call(self, key: tuple, fn: Callable, inputs: tuple = (),
             generator: torch.Generator | None = None) -> Any:
        """``fn(*inputs)``: eager on the first call under ``key``; on the
        second captured (``generator`` registered), then replayed; every
        replay copies ``inputs`` into the static buffers first and returns
        copies of the static outputs (``copies``)."""
        g = self.graphs.get(key)
        if g is None and key not in self.warm:
            self.warm.add(key)
            return fn(*inputs)
        if g is None:
            g = self.capture(key, fn, inputs, generator=generator)
        for static, x in zip(g.inputs, inputs):
            static.copy_(x)
        self.replay(g)
        return copies(g.output)


def on_device(device: torch.device, x, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (an array, a list or a tensor) as ``dtype`` on ``device``. Host
    data reach the card through a pinned buffer and a copy that does not
    wait (the pinned allocator keeps the buffer until the copy has run), so
    a caller enqueues without a host sync."""
    if torch.is_tensor(x) and x.device == device:
        return x.to(dtype)
    host = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=dtype)
    if device.type == "cpu":
        return host.cpu()
    if host.device.type == "cpu":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def queries_on(device: torch.device, queries) -> torch.Tensor:
    """``queries`` as f32 on ``device`` (``on_device``)."""
    return on_device(device, queries, torch.float32)


class SearchGraphs(GraphCache):
    """One search graph per key (the method and its static form, query rows,
    ``k``) of one index. The first call under a key runs eager; the next
    captures and every later one replays: its queries copied into the static
    [Q, D] buffer, the graph replayed, copies of its static outputs
    returned. A lock keeps two threads from sharing the static buffers."""

    def __init__(self, device: torch.device, log=None):
        super().__init__(device, log, "search_graph")
        self.lock = threading.Lock()

    def search(self, key: tuple, fn: Callable, queries, reads: tuple, graphed: bool):
        """``fn(q [Q, D] f32) -> (distances, ids)`` on ``queries``: eager
        unless ``graphed``, else graphed under ``(key[0], Q, *key[1:])``.
        ``reads`` are the tensors the search reads besides the queries: their
        addresses and shapes, as at capture, keep the graphs."""
        q = queries_on(self.device, queries)
        if not graphed:
            return fn(q)
        key = (key[0], int(q.shape[0]), *key[1:])
        with self.lock:
            self.check_addresses(tuple((t.data_ptr(), tuple(t.shape)) for t in reads))
            return self.call(key, fn, (q,))


class ProgramGraphs(GraphCache):
    """One graph per static key of JAX's other jitted programs: the
    trainer's neighbourhood refresh (``sampling/random_walk.py``), the
    validation ranks and ``recommend`` (``evaluation/metrics.py``) and
    k-means (``retrieval/ivf.py``). ``run`` is ``call`` under a lock, with
    each key's own record of what its graph reads besides its inputs (the
    addresses and shapes of ``reads`` and the generator registered with
    it): a change drops that key's graph alone. Logs ``program_graph``."""

    def __init__(self, device: torch.device, log=None):
        super().__init__(device, log, "program_graph")
        self.lock = threading.Lock()
        self.reads: dict[tuple, tuple] = {}

    def drop(self) -> None:
        super().drop()
        self.reads.clear()

    def run(self, key: tuple, fn: Callable, inputs: tuple = (), reads: tuple = (),
            generator: torch.Generator | None = None) -> Any:
        """``fn(*inputs)`` under ``key`` (``call``); ``generator`` is what
        ``fn`` draws from."""
        seen = (id(generator), *((t.data_ptr(), tuple(t.shape)) for t in reads))
        with self.lock:
            if self.reads.get(key, seen) != seen:
                self.graphs.pop(key, None)
                self.warm.discard(key)
            self.reads[key] = seen
            return self.call(key, fn, inputs, generator)


def use_graphs(graphs: ProgramGraphs | None, graphed: bool | None,
               device: torch.device) -> bool:
    """Whether a program runs through ``graphs``: ``graphed`` if given,
    else when ``graphs`` is given and the program runs on ``cuda``."""
    if graphed is None:
        return graphs is not None and device.type == "cuda"
    if graphed and graphs is None:
        raise ValueError("graphed=True needs graphs= (a core.graphs.ProgramGraphs)")
    return graphed
