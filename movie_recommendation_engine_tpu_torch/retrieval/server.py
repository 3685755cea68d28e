"""Production serving: a batched recommendation server over the indexes.

Port of ``movie_recommendation_engine_tpu/retrieval/server.py``: a
persistent process that answers movie-to-movie and history-to-movie
recommendation queries with batched device searches.

Design:

- One worker thread owns the device. Front-end threads enqueue requests;
  the worker drains the queue, packs queries into ONE device search call,
  and resolves per-request futures. Batching amortizes the per-search
  launch and host-sync cost over the requests of a batch.
- Batches are padded up to a fixed set of **bucket sizes** (powers of two up
  to ``max_batch``), and ``k`` is fixed per server (``max_k`` + exclusion
  headroom) and sliced per request, so the searches run a handful of shapes.
  Where JAX's server compiles each bucket before it takes traffic, this one
  captures each bucket's CUDA graph (an index with ``graphed`` set: every
  single-device index on ``cuda``): the warm-up searches each bucket twice,
  the first call eager, the second captured; requests replay. A batch whose
  exclusions need a larger pow2 ``search_k`` runs eager on that key's first
  use and is captured at its second. Each capture logs ``search_graph`` (a
  ``MetricsLogger`` on stdout, as the trainer's) and is kept on
  ``index.graphs.events``.
- The worker's program spans (``core.logging.span``, recorded while the
  recorder is on): ``server.wait`` (queue empty), ``server.linger`` (first
  request seen to batch taken) and ``server.batch`` (batch taken to every
  answer set; children ``server.pack``, ``server.search`` through the copy
  back, ``server.answer``), which carries its requests' ``ids`` and
  ``submitted_ns``: a request's queue wait is its submit time to its
  batch's start. ``ServerStats`` keeps the queue wait and the batch's
  service time of every request, always.

Query forms:
- by item: embedding row of ``movie_idx`` (self excluded from results);
- by history: L2-normalized mean of the history rows — the classic
  user-as-centroid query (history items excluded from results);
- by raw vector.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from ..core.logging import MetricsLogger, span
from .bench import make_index


def _buckets(max_batch: int) -> list[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


@dataclass
class _Request:
    query: np.ndarray            # [D] f32
    k: int
    exclude: np.ndarray          # int32 item indices to drop from results
    id: int                      # the server's count of submits, from 1
    future: Future = field(default_factory=Future)
    t_submit_ns: int = field(default_factory=time.time_ns)   # the spans' clock


class ServerStats:
    """Latency / batching counters (thread-safe, lock held by caller).
    Bounded ring buffers — a persistent server must not grow without limit.
    Per request: latency (submit to its batch's search copied back), queue
    wait (submit to its batch taken, linger included) and service (its
    batch taken to every answer of the batch set)."""

    WINDOW = 10_000

    def __init__(self):
        self.num_requests = 0
        self.num_batches = 0
        self.latencies_ms: deque[float] = deque(maxlen=self.WINDOW)
        self.queue_ms: deque[float] = deque(maxlen=self.WINDOW)
        self.service_ms: deque[float] = deque(maxlen=self.WINDOW)
        self.batch_sizes: deque[int] = deque(maxlen=self.WINDOW)

    def snapshot(self) -> dict:
        lat = np.asarray(self.latencies_ms or [0.0])
        queue = np.asarray(self.queue_ms or [0.0])
        service = np.asarray(self.service_ms or [0.0])
        return {
            "num_requests": self.num_requests,
            "num_batches": self.num_batches,
            "mean_batch_size": float(np.mean(self.batch_sizes or [0])),
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p95": float(np.percentile(lat, 95)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "queue_ms_p50": float(np.percentile(queue, 50)),
            "queue_ms_p99": float(np.percentile(queue, 99)),
            "service_ms_p50": float(np.percentile(service, 50)),
            "service_ms_p99": float(np.percentile(service, 99)),
        }


class BatchingRecommender:
    """Batched retrieval server core (protocol-agnostic; see ``serve_http``).

    Construct with the item embedding matrix, then ``recommend_by_item`` /
    ``recommend_by_history`` / ``recommend_by_vector`` from any thread.
    ``planes`` / ``init_idx`` inject LSH hyperplanes and IVF k-means' initial
    rows (``make_index``).
    """

    def __init__(self, embeddings: np.ndarray, method: str = "exact",
                 cfg=None, max_batch: int = 64, max_wait_ms: float = 2.0,
                 max_k: int = 100, exclusion_headroom: int = 16,
                 warmup: bool = True, device=None, planes=None, init_idx=None):
        self.emb = np.asarray(embeddings, dtype=np.float32)
        self.dim = int(self.emb.shape[1])
        self.ntotal = int(self.emb.shape[0])
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_k = int(min(max_k, self.ntotal))
        # Baseline over-fetch so post-hoc exclusion doesn't starve typical
        # requests; batches whose exclude lists exceed the headroom get a
        # larger pow2-bucketed search_k in _execute (still a bounded shape set).
        self._search_k = min(self.max_k + exclusion_headroom, self.ntotal)
        self._bucket_sizes = _buckets(self.max_batch)

        self.index = make_index(method, self.dim, cfg, device=device,
                                planes=planes, init_idx=init_idx)
        self.index.build(self.emb)
        if self.index.graphed:
            self.index.graphs.log = MetricsLogger()
        self.method = method

        self._queue: list[_Request] = []
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._stats = ServerStats()
        self._closed = False
        if warmup:
            # Run every batch bucket at the baseline search_k BEFORE accepting
            # traffic, so that one-time costs (kernel build and load,
            # allocator growth, graph capture) stay out of request latencies:
            # once, and on a graphed index a second time, which captures.
            z = np.zeros((1, self.dim), np.float32)
            for b in self._bucket_sizes:
                for _ in range(2 if self.index.graphed else 1):
                    d, i = self.index.search(np.repeat(z, b, axis=0), k=self._search_k)
                    d.cpu(), i.cpu()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- public API ---------------------------------------------------------

    def recommend_by_item(self, movie_idx: int, k: int = 10):
        if not 0 <= movie_idx < self.ntotal:
            raise IndexError(f"movie_idx {movie_idx} out of range [0, {self.ntotal})")
        return self.submit(self.emb[movie_idx], k,
                           exclude=np.asarray([movie_idx])).result()

    def recommend_by_history(self, movie_idxs, k: int = 10):
        idxs = np.asarray(movie_idxs, dtype=np.int64)
        if idxs.size == 0:
            raise ValueError("history is empty")
        if idxs.min() < 0 or idxs.max() >= self.ntotal:
            raise IndexError("history contains out-of-range movie_idx")
        q = self.emb[idxs].mean(axis=0)
        q /= max(float(np.linalg.norm(q)), 1e-12)
        return self.submit(q, k, exclude=idxs).result()

    def recommend_by_vector(self, vector, k: int = 10):
        return self.submit(np.asarray(vector, np.float32), k,
                           exclude=np.asarray([], np.int64)).result()

    def submit(self, query: np.ndarray, k: int, exclude: np.ndarray) -> Future:
        if query.shape != (self.dim,):
            raise ValueError(f"query must be [{self.dim}], got {query.shape}")
        if int(k) < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        k = int(min(k, self.max_k))
        req = _Request(query.astype(np.float32), k,
                       np.asarray(exclude, np.int64), next(self._ids))
        with self._not_empty:
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.append(req)
            self._not_empty.notify()
        return req.future

    def stats(self) -> dict:
        with self._lock:
            return self._stats.snapshot()

    def reset_stats(self) -> None:
        """Zero the latency/batching counters (e.g. between load-test runs
        so each concurrency level reports its own batching behavior)."""
        with self._lock:
            self._stats = ServerStats()

    def close(self) -> None:
        with self._not_empty:
            self._closed = True
            self._not_empty.notify()
        self._worker.join(timeout=10)

    # -- worker -------------------------------------------------------------

    def _take_batch(self) -> tuple[list[_Request], int]:
        """Block until >=1 request, then linger up to ``max_wait_s`` to let a
        batch accumulate (never lingers when the bucket is already full).
        Returns the batch and when it was taken (``time.time_ns``)."""
        with self._not_empty:
            if not self._queue and not self._closed:
                with span("server.wait"):
                    while not self._queue and not self._closed:
                        self._not_empty.wait(timeout=0.1)
            if self._closed and not self._queue:
                return [], 0
            with span("server.linger"):
                deadline = self._queue[0].t_submit_ns + int(self.max_wait_s * 1e9)
                while (len(self._queue) < self.max_batch and not self._closed
                       and (remaining := deadline - time.time_ns()) > 0):
                    self._not_empty.wait(timeout=remaining / 1e9)
                batch, self._queue = (self._queue[: self.max_batch],
                                      self._queue[self.max_batch:])
                return batch, time.time_ns()

    def _run(self) -> None:
        while True:
            batch, taken_ns = self._take_batch()
            if not batch:
                return
            try:
                self._execute(batch, taken_ns)
            except Exception as e:  # resolve futures; never kill the worker
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _execute(self, batch: list[_Request], taken_ns: int) -> None:
        n = len(batch)
        with span("server.batch", start_ns=taken_ns) as sp:
            if sp.recorded:
                sp.attrs["ids"] = [r.id for r in batch]
                sp.attrs["submitted_ns"] = [r.t_submit_ns for r in batch]
            with span("server.pack"):
                bucket = next(b for b in self._bucket_sizes if b >= n)
                q = np.zeros((bucket, self.dim), np.float32)
                q[:n] = np.stack([r.query for r in batch])
                # Over-fetch enough that exclusion can't starve any request
                # in the batch; pow2-bucket the occasional large-exclude
                # searches so the set of search shapes stays bounded.
                need = max(r.k + len(r.exclude) for r in batch)
                search_k = (self._search_k if need <= self._search_k
                            else min(_next_pow2(need), self.ntotal))
            with span("server.search"):
                d, i = self.index.search(q, k=search_k)
                d, i = d.cpu().numpy(), i.cpu().numpy()   # host copy = sync
            now = time.time_ns()
            with span("server.answer"):
                for row, r in enumerate(batch):
                    idx, dist = i[row], d[row]
                    keep = ~np.isin(idx, r.exclude) & (idx >= 0)
                    idx, dist = idx[keep][: r.k], dist[keep][: r.k]
                    r.future.set_result(
                        {"indices": idx.tolist(),
                         # All indexes return distances (smaller = closer);
                         # expose score = -distance like cli recommend's
                         # non-exact path.
                         "scores": (-dist).tolist()}
                    )
        service_ms = (time.time_ns() - taken_ns) / 1e6
        with self._lock:
            self._stats.num_requests += n
            self._stats.num_batches += 1
            self._stats.batch_sizes.append(n)
            self._stats.latencies_ms.extend((now - r.t_submit_ns) / 1e6 for r in batch)
            self._stats.queue_ms.extend((taken_ns - r.t_submit_ns) / 1e6 for r in batch)
            self._stats.service_ms.extend([service_ms] * n)


# ---------------------------------------------------------------------------
# HTTP front-end (stdlib only)
# ---------------------------------------------------------------------------

def make_http_server(rec: BatchingRecommender, host: str = "127.0.0.1",
                     port: int = 8321, movie_ids=None, titles=None):
    """ThreadingHTTPServer with:
    GET  /health                     -> {"status": "ok", "ntotal": N, ...}
    GET  /stats                      -> latency / batching stats
    GET  /recommend?movie_id=X&k=10  -> top-k for one item (external movieId)
    POST /recommend  {"movie_id": X} | {"history": [X, ...]}, optional "k"
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    id_to_idx = ({int(m): i for i, m in enumerate(movie_ids)}
                 if movie_ids is not None else None)

    def to_idx(movie_id: int) -> int:
        if id_to_idx is None:
            return int(movie_id)
        if int(movie_id) not in id_to_idx:
            raise KeyError(f"unknown movieId {movie_id}")
        return id_to_idx[int(movie_id)]

    def render(out: dict) -> dict:
        if movie_ids is not None:
            out["movie_ids"] = [int(movie_ids[i]) for i in out["indices"]]
        if titles is not None:
            out["titles"] = [titles[i] for i in out["indices"]]
        return out

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/health":
                return self._send(200, {"status": "ok", "ntotal": rec.ntotal,
                                        "method": rec.method, "dim": rec.dim})
            if u.path == "/stats":
                return self._send(200, rec.stats())
            if u.path == "/recommend":
                qs = parse_qs(u.query)
                try:
                    idx = to_idx(int(qs["movie_id"][0]))
                    k = int(qs.get("k", ["10"])[0])
                    return self._send(200, render(rec.recommend_by_item(idx, k)))
                except (KeyError, ValueError, IndexError, TypeError) as e:
                    return self._send(400, {"error": str(e)})
                except Exception as e:  # worker/index failure — report, don't
                    return self._send(500, {"error": str(e)})  # drop the conn
            return self._send(404, {"error": "not found"})

        def do_POST(self):
            if urlparse(self.path).path != "/recommend":
                return self._send(404, {"error": "not found"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("request body must be a JSON object")
                k = int(body.get("k", 10))
                if "history" in body:
                    idxs = [to_idx(m) for m in body["history"]]
                    out = rec.recommend_by_history(idxs, k)
                elif "movie_id" in body:
                    out = rec.recommend_by_item(to_idx(body["movie_id"]), k)
                elif "vector" in body:
                    out = rec.recommend_by_vector(body["vector"], k)
                else:
                    raise ValueError("need movie_id, history, or vector")
                return self._send(200, render(out))
            except (KeyError, ValueError, IndexError, TypeError) as e:
                # Malformed input of any shape (k=null -> TypeError, history
                # not a list -> TypeError, ...) is a client error.
                return self._send(400, {"error": str(e)})
            except Exception as e:
                return self._send(500, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)
