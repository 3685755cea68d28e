"""Graph builders: bipartite user-movie and item co-occurrence graphs.

Vectorized host-side replacements for the reference's builders:
- bipartite graph: reference ``data/graph_builder.py:22-57`` / ``data/dataset.py:91-123``
- item-similarity (co-occurrence) graph: reference ``data/graph_builder.py:59-116``
  (the O(sum n_u^2) per-user pair loop at :84-96 runs in the native counter
  ``cpp/cooc.cc``, or as numpy pair generation with np.unique-based counting).

Node-id convention (matching the reference, ``data/dataset.py:106``):
movies occupy indices [0, num_movies); users are offset by num_movies.
"""

from __future__ import annotations

import time

import numpy as np

from ..core.logging import MetricsLogger
from .csr import CSRGraph, csr_from_edge_index


def build_bipartite_graph(
    user_idx: np.ndarray,
    movie_idx: np.ndarray,
    ratings: np.ndarray,
    num_movies: int,
    num_users: int,
) -> CSRGraph:
    """Bidirectional user<->movie graph; edge weight = rating.

    Mirrors reference ``data/graph_builder.py:22-57``: user indices offset by
    ``num_movies``, each interaction becomes two directed edges.
    """
    u = np.asarray(user_idx, dtype=np.int64) + num_movies
    m = np.asarray(movie_idx, dtype=np.int64)
    r = np.asarray(ratings, dtype=np.float32)
    edge_index = np.stack([
        np.concatenate([u, m]),
        np.concatenate([m, u]),
    ])
    edge_weights = np.concatenate([r, r])
    return csr_from_edge_index(edge_index, edge_weights, num_nodes=num_movies + num_users)


def build_item_similarity_graph(
    user_idx: np.ndarray,
    movie_idx: np.ndarray,
    num_movies: int,
    threshold: int = 5,
    max_items_per_user: int | None = None,
    logger: MetricsLogger | None = None,
) -> CSRGraph:
    """Item graph from per-user co-occurrence counts (threshold-filtered).

    Same semantics as reference ``data/graph_builder.py:59-116``: for every
    user, every unordered pair of their rated movies contributes 1 to that
    pair's co-occurrence count; pairs with count >= threshold become
    bidirectional edges weighted by the count.

    ``max_items_per_user`` optionally caps the per-user item list (uniformly
    subsampled) to bound the O(sum n_u^2) pair blow-up on power users; None
    reproduces the reference exactly. Without a cap the native counter
    (``utils/cooc_native``) counts when it builds, as JAX's builder does;
    otherwise ``cooccurrence_counts`` (numpy, its plain version). ``logger``
    receives a ``cooc`` event naming the route.
    """
    u = np.asarray(user_idx, dtype=np.int64)
    m = np.asarray(movie_idx, dtype=np.int64)
    order = np.argsort(u, kind="stable")
    u_s, m_s = u[order], m[order]

    t0 = time.perf_counter()
    route, reason = "numpy", None
    if max_items_per_user is not None:
        reason = "max_items_per_user"
    else:
        from ..utils import cooc_native
        from ..utils.native import BuildError

        try:
            i, j, counts = cooc_native.count_cooccurrence(u_s, m_s, num_movies, threshold)
            route = "native"
        except BuildError as e:
            reason = str(e)
    if route == "numpy":
        i, j, counts = cooccurrence_counts(u_s, m_s, num_movies, threshold,
                                           max_items_per_user)
    if logger is not None:
        logger.log("cooc", route=route, reason=reason, pairs=int(i.shape[0]),
                   seconds=time.perf_counter() - t0)
    edge_index = np.stack([
        np.concatenate([i, j]).astype(np.int64),
        np.concatenate([j, i]).astype(np.int64),
    ])
    w = np.concatenate([counts, counts]).astype(np.float32)
    return csr_from_edge_index(edge_index, w, num_nodes=num_movies)


def cooccurrence_counts(u_s: np.ndarray, m_s: np.ndarray, num_movies: int,
                        threshold: int, max_items_per_user: int | None = None):
    """(i, j, count) of the movie pairs i < j rated by at least
    ``threshold`` common users; ``u_s`` ascending, ``m_s`` aligned."""
    # Group boundaries per user.
    boundaries = np.flatnonzero(np.diff(u_s)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [u_s.shape[0]]])

    pair_keys: list[np.ndarray] = []
    rng = np.random.default_rng(0)
    for s, e in zip(starts, ends):
        items = m_s[s:e]
        if max_items_per_user is not None and items.shape[0] > max_items_per_user:
            items = rng.choice(items, size=max_items_per_user, replace=False)
        n = items.shape[0]
        if n < 2:
            continue
        ii, jj = np.triu_indices(n, k=1)
        a, b = items[ii], items[jj]
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        keep_pairs = lo != hi   # duplicate ratings must not create self-loops
        pair_keys.append((lo * num_movies + hi)[keep_pairs])

    keys = np.concatenate(pair_keys) if pair_keys else np.zeros(0, np.int64)
    uniq, counts = np.unique(keys, return_counts=True)
    keep = counts >= threshold
    uniq, counts = uniq[keep], counts[keep]
    return uniq // num_movies, uniq % num_movies, counts
