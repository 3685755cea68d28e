"""Index factory honoring ``SearchConfig``.

Port of ``make_index`` from ``movie_recommendation_engine_tpu/retrieval/
bench.py`` for the methods ``exact``, ``lsh`` and ``lsh_rerank``. The
benchmark harness, IVF and the sharded indexes are not ported yet.
"""

from __future__ import annotations

from .exact import ExactIndex
from .lsh import LSHIndex


def make_index(method: str, dim: int, cfg=None, seed: int = 0, device=None,
               planes=None):
    """An unbuilt index on ``device``. ``planes`` injects LSH hyperplanes."""
    if method == "exact":
        return ExactIndex(dim, device=device)
    if method in ("lsh", "lsh_rerank"):
        bits = cfg.search.lsh_bits if cfg else 256
        tables = cfg.search.lsh_tables if cfg else 16
        rerank = cfg.search.lsh_rerank if cfg else 0
        if method == "lsh_rerank" and rerank <= 0:
            rerank = 100   # the JAX package's default shortlist for this method
        return LSHIndex(dim, num_bits=bits, num_tables=tables, seed=seed,
                        rerank=rerank, planes=planes, device=device)
    if method in ("ivf", "sharded_exact", "sharded_ivf"):
        raise NotImplementedError(
            f"search method {method!r} is not ported yet (ROADMAP queue 1)")
    raise ValueError(f"unknown search method: {method}")
