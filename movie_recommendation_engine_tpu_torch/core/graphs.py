"""CUDA graphs: capture a program once per static key, replay it.

The JAX package compiles each of its hot programs once per static signature
(the train step per ``num_hard``, each search per batch bucket and ``k``)
and then runs it with one dispatch. Run op by op from Python, the port's
counterparts launch tens to hundreds of kernels from the host, and the host,
not the card, sets their pace. A CUDA graph is this card's counterpart of a
jitted program with static shapes: captured once for each static key, it
reads its inputs at fixed addresses and replays with one host call.

Every graphed program of the port runs through ``GraphCache.run``: the
trainers' steps, embedding passes and HSTU's user encoding
(``train/loop.py``), the indexes' searches (``SearchGraphs``, one graph per
query rows, ``k`` and the index's static form), and JAX's other jitted
programs: the trainer's neighbourhood refresh, the validation ranks,
``recommend`` and k-means. The first call under a key runs eager, the second
captures, every later one replays on its inputs copied into the static
buffers. A graph must never replay against stale addresses: ``run`` checks
the record of what the graph reads (``GraphCache._check``) and drops the
graphs that read what moved. One pool holds a cache's graphs, and each
capture logs one event.

The kernel wrappers count launches on the host (``ops.pool.LAUNCHES`` and
the others). A capture runs the wrappers once and launches nothing, so the
cache takes back what the capture counted and adds it on every replay: the
counts stay launches.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Any, Callable, Hashable, NamedTuple

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


def tensors(obj: Any, generators: bool = False) -> list:
    """Every tensor in nested dicts, lists and tuples (named tuples too),
    and with ``generators`` every ``torch.Generator`` among them."""
    if torch.is_tensor(obj) or (generators and type(obj) is torch.Generator):
        return [obj]
    if isinstance(obj, dict):
        obj = [obj[k] for k in sorted(obj)]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in tensors(x, generators)]
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
    copies nothing and returns False. What a graph read then still lies
    where it lay."""
    if dst is None or not _same_structure(dst, src):
        return False
    for d, s in zip(tensors(dst), tensors(src)):
        if d.data_ptr() != s.data_ptr():
            d.copy_(s)
    return True


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
    to ``events`` and, when ``log`` is set, to ``log.log``. ``programs`` is
    a second cache (its own pool) that ``drop`` drops too: the trainer's
    per-epoch programs beside its steps.

    ``run`` is the one way a program runs through a cache, and ``_check``
    the one rule for what drops a graph: each graph belongs to a record of
    what it reads besides its inputs (each tensor's address, shape and
    dtype, and each generator), kept from capture. When what lies there now
    differs, every graph of that record is dropped, with the eager runs
    that warmed their keys; the pool goes with the last graph."""

    def __init__(self, device: torch.device, log=None, event: str = "program_graph",
                 programs: GraphCache | None = None):
        self.device = device
        self.log = log
        self.event = event
        self.programs = programs
        self.events: list[dict] = []
        self.graphs: dict[tuple, Captured] = {}
        self.warm: dict[tuple, Hashable] = {}      # keys whose eager first call ran: their record
        self.records: dict[Hashable, tuple] = {}   # what each record's graphs read
        self.lock = threading.RLock()              # one caller at a time on the static buffers
        self.pool = None
        self.pool_bytes = 0                 # reserved memory the captures added

    def drop(self, programs: bool = True) -> None:
        """Forget every graph (their memory returns to the allocator) and,
        with ``programs``, those of ``programs``."""
        with self.lock:
            self.graphs.clear()
            self.warm.clear()
            self.records.clear()
            self.pool = None
            self.pool_bytes = 0
        if programs and self.programs is not None:
            self.programs.drop()

    def _check(self, record: Hashable, reads: Any) -> None:
        """Drops the graphs of ``record`` when ``reads`` no longer lie where
        they lay when the record was taken, and takes it anew."""
        now = tuple(x if type(x) is torch.Generator else (x.data_ptr(), x.shape, x.dtype)
                    for x in tensors(reads, generators=True))
        if self.records.get(record, now) != now:
            for key in [k for k, r in self.warm.items() if r == record]:
                del self.warm[key]
                self.graphs.pop(key, None)
            if not self.graphs:
                self.pool = None
                self.pool_bytes = 0
        self.records[record] = now

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

    def run(self, key: tuple, fn: Callable, inputs: tuple = (), reads: Any = None,
            record: Hashable = None, generator: torch.Generator | None = None,
            copy: bool = True) -> Any:
        """``fn(*inputs)`` under ``key``: eager on the first call, captured
        on the second (``generator``, what ``fn`` draws from, registered with
        the graph), then replayed, ``inputs`` copied into the static buffers
        first. Returns copies of the static outputs (``copies``), or with
        ``copy=False`` the outputs themselves, which the next replay
        rewrites.

        ``record`` (by default the key alone) names what the graph reads
        besides its inputs; graphs of one record drop together. ``reads``,
        those tensors and generators, are checked first when given
        (``_check``): a caller that runs one key over many rows passes them
        with the first."""
        record = key if record is None else record
        with self.lock:
            if reads is not None:
                self._check(record, reads)
            g = self.graphs.get(key)
            if g is None and key not in self.warm:
                self.warm[key] = record
                return fn(*inputs)
            if g is None:
                g = self.capture(key, fn, inputs, generator)
            for static, x in zip(g.inputs, inputs):
                static.copy_(x)
            self.replay(g)
            return copies(g.output) if copy else g.output


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
    ``k``) of one index, every one of them on the index's record."""

    def __init__(self, device: torch.device, log=None):
        super().__init__(device, log, "search_graph")

    def search(self, key: tuple, fn: Callable, queries, reads: tuple, graphed: bool):
        """``fn(q [Q, D] f32) -> (distances, ids)`` on ``queries``: eager
        unless ``graphed``, else ``run`` under ``(key[0], Q, *key[1:])``, its
        queries copied into the static [Q, D] buffer. ``reads`` are the
        tensors the search reads besides the queries."""
        q = queries_on(self.device, queries)
        if not graphed:
            return fn(q)
        return self.run((key[0], int(q.shape[0]), *key[1:]), fn, (q,), reads=reads,
                        record="index")


def use_graphs(graphs: GraphCache | None, graphed: bool | None,
               device: torch.device) -> bool:
    """Whether a program runs through ``graphs``: ``graphed`` if given,
    else when ``graphs`` is given and the program runs on ``cuda``."""
    if graphed is None:
        return graphs is not None and device.type == "cuda"
    if graphed and graphs is None:
        raise ValueError("graphed=True needs graphs= (a core.graphs.GraphCache)")
    return graphed
