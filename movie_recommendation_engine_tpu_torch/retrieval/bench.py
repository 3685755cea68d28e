"""Index factory honoring ``SearchConfig``, and the ANN benchmark harness:
latency + recall@k for exact / LSH / IVF.

Port of ``movie_recommendation_engine_tpu/retrieval/bench.py`` (the
reference's ``benchmark_search_methods``) for every method: ``exact``,
``lsh``, ``lsh_rerank``, ``ivf`` and the row-sharded ``sharded_exact`` and
``sharded_ivf`` (``retrieval/sharded.py``; every rank of the process group
builds and searches together). A search is timed on the host clock from the call to its results on the
host (the copy waits for the device), after one warm-up call that is not
counted (it pays the kernels' build and load).
"""

from __future__ import annotations

import sys
import time
from typing import Any

import numpy as np
import torch

from ..core.device import resolve_device
from .exact import ExactIndex
from .ivf import WeakANDIndex
from .lsh import LSHIndex
from .sharded import ShardedExactIndex, ShardedIVFIndex

NAMES = {
    "exact": "Exact (Brute Force)",
    "lsh": "Locality-Sensitive Hashing",
    "lsh_rerank": "LSH + exact rerank (fused shortlist)",
    "ivf": "Weak AND (IVF)",
    "sharded_exact": "Exact (row-sharded over the process group)",
    "sharded_ivf": "Weak AND (IVF, row-sharded over the process group)",
}


def _mesh(cfg):
    """The mesh of ``cfg.mesh.mesh_shape`` for a sharded index, else None
    (every rank of the process group, or this process alone)."""
    if cfg is None or cfg.mesh.mesh_shape is None:
        return None
    from ..parallel.mesh import make_mesh

    return make_mesh(tuple(cfg.mesh.mesh_shape))


def make_index(method: str, dim: int, cfg=None, seed: int = 0, device=None,
               planes=None, init_idx=None):
    """An unbuilt index on ``device``. ``planes`` injects LSH hyperplanes,
    ``init_idx`` the IVF k-means' initial rows. The sharded methods split
    the corpus over the model axis of ``cfg.mesh.mesh_shape``, else over
    every rank."""
    if method == "exact":
        return ExactIndex(dim, device=device)
    if method == "sharded_exact":
        return ShardedExactIndex(dim, mesh=_mesh(cfg), device=device)
    if method in ("lsh", "lsh_rerank"):
        bits = cfg.search.lsh_bits if cfg else 256
        tables = cfg.search.lsh_tables if cfg else 16
        rerank = cfg.search.lsh_rerank if cfg else 0
        if method == "lsh_rerank" and rerank <= 0:
            rerank = 100   # the JAX package's default shortlist for this method
        return LSHIndex(dim, num_bits=bits, num_tables=tables, seed=seed,
                        rerank=rerank, planes=planes, device=device)
    if method in ("ivf", "sharded_ivf"):
        kw = dict(num_partitions=cfg.search.ivf_partitions if cfg else 100,
                  candidates_factor=cfg.search.ivf_factor if cfg else 0,
                  nprobe=cfg.search.ivf_nprobe if cfg else 20, seed=seed,
                  balance_factor=cfg.search.ivf_balance_factor if cfg else 4.0,
                  device=device, init_idx=init_idx)
        if method == "sharded_ivf":
            return ShardedIVFIndex(dim, mesh=_mesh(cfg), **kw)
        return WeakANDIndex(dim, **kw)
    raise ValueError(f"unknown search method: {method}")


def _sync(index) -> None:
    """Wait for the last artifact the build computes: the device, then a
    copy of one row to the host."""
    built = getattr(index, "_sigs_pm", None)
    for name in ("_sigs", "_emb"):
        if built is None:
            built = getattr(index, name, None)
    if built.is_cuda:
        torch.cuda.synchronize(built.device)
    built[:1].cpu()


def _timed_search(index, queries, k: int, repeats: int = 3):
    d, i = index.search(queries, k)
    d, i = d.cpu().numpy(), i.cpu().numpy()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        d, i = index.search(queries, k)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        times.append(time.perf_counter() - t0)
    return d, i, min(times), times


def benchmark_search_methods(embeddings, queries, k: int = 10,
                             methods: list[str] | None = None, cfg=None,
                             repeats: int = 3, device=None, planes=None,
                             init_idx=None) -> dict[str, dict[str, Any]]:
    """Build each method's index on ``device`` and time its search of
    ``queries``: the best and median of ``repeats`` searches, the build
    time, the index size, and recall@k against ``exact`` when it is among
    the methods. Progress goes to stderr."""
    device = resolve_device(device)
    emb = torch.as_tensor(embeddings, dtype=torch.float32, device=device)
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    dim = int(emb.shape[1])
    methods = methods or ["exact", "lsh", "ivf"]

    results: dict[str, dict[str, Any]] = {}
    for method in methods:
        print(f"[bench] {method}: building index ...", file=sys.stderr, flush=True)
        index = make_index(method, dim, cfg, device=device, planes=planes, init_idx=init_idx)
        t0 = time.perf_counter()
        index.build(emb)
        _sync(index)
        build_time = time.perf_counter() - t0
        print(f"[bench] {method}: built in {build_time:.1f}s; searching ...",
              file=sys.stderr, flush=True)
        d, i, search_time, all_times = _timed_search(index, q, k, repeats)
        print(f"[bench] {method}: search ok ({search_time:.4f}s best)",
              file=sys.stderr, flush=True)
        nq = max(q.shape[0], 1)
        results[method] = {
            "distances": d,
            "indices": i,
            "search_time": search_time,   # best of repeats (reference parity)
            "search_time_per_query_ms": search_time / nq * 1e3,
            "p50_search_time_per_query_ms": float(np.median(all_times)) / nq * 1e3,
            "build_time": build_time,
            "index_size": index.ntotal,
            "method": NAMES[method],
        }

    if "exact" in results:
        exact_idx = results["exact"]["indices"]
        for method, data in results.items():
            if method == "exact":
                continue
            recall = 0.0
            for row in range(exact_idx.shape[0]):
                e = set(exact_idx[row].tolist())
                m = set(int(x) for x in data["indices"][row].tolist() if x >= 0)
                recall += len(e & m) / k
            data["recall"] = recall / max(exact_idx.shape[0], 1)
    return results


def print_benchmark(results: dict[str, dict[str, Any]], k: int = 10) -> None:
    print("\nBenchmark Results:\n-----------------")
    for method, data in results.items():
        print(f"{data['method']}:")
        print(f"  Search time: {data['search_time']:.6f} seconds "
              f"({data['search_time_per_query_ms']:.4f} ms/query)")
        print(f"  Index size: {data['index_size']} vectors")
        if "recall" in data:
            print(f"  recall@{k}: {data['recall']:.4f}")
