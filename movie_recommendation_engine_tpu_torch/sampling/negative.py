"""Negative sampling: shared random negatives, rank-window hard negatives and
the curriculum schedule.

Port of ``movie_recommendation_engine_tpu/sampling/negative.py``. Random
negatives are distinct movies shared across the batch. Hard negatives: per
query, run walks, rank the visited nodes by visit count (descending), keep
the rank window [min_rank, max_rank) of movie nodes, and pick ``num_hard``
of them without replacement by the largest uniform noise; random movies fill
any shortfall. With the default walk budget (100 walks of length 2, at most
200 visited nodes, ``min_rank = 2000``) the window is always empty and every
hard negative is a random movie, as in the JAX package and its reference.

Draws come from a ``torch.Generator``. The walk uniforms, the selection noise
and the fallback ids can be passed in instead, so that tests feed JAX's.
"""

from __future__ import annotations

import torch

from .random_walk import DeviceGraph, _run_length_counts, random_walks


def sample_random_negatives(num_movies: int, num_samples: int,
                            generator: torch.Generator | None = None,
                            device=None) -> torch.Tensor:
    """[num_samples] distinct movie indices, int32."""
    perm = torch.randperm(num_movies, generator=generator, device=device)
    return perm[:num_samples].to(torch.int32)


def _top(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row and their positions, the lower position
    first among equal values (``lax.top_k``'s order; ``torch.topk`` leaves
    the order of ties undefined)."""
    values, pos = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], pos[:, :k]


def sample_hard_negatives(graph: DeviceGraph, query_nodes: torch.Tensor,
                          num_hard: int, num_movies: int, num_walks: int = 100,
                          walk_length: int = 2, min_rank: int = 2000,
                          max_rank: int = 5000, n_iters: int = 16,
                          generator: torch.Generator | None = None,
                          uniforms: torch.Tensor | None = None,
                          noise: torch.Tensor | None = None,
                          fallback: torch.Tensor | None = None) -> torch.Tensor:
    """[B, num_hard] hard-negative movie indices, int32.

    ``uniforms`` ([walk_length, B * num_walks]) drive the walks, ``noise``
    ([B, hi - min_rank] in [0, 1), hi = min(max_rank, num_walks *
    walk_length)) the selection, ``fallback`` ([B, num_hard] movie ids) the
    shortfall; each not given is drawn from ``generator``."""
    device = graph.indptr.device
    b = query_nodes.shape[0]
    if fallback is None:
        fallback = torch.randint(0, num_movies, (b, num_hard), generator=generator,
                                 device=device, dtype=torch.int32)
    hi = min(max_rank, num_walks * walk_length)
    if min_rank >= hi:
        return fallback.to(torch.int32)      # the window is empty

    visited = random_walks(graph, query_nodes, num_walks, walk_length, n_iters,
                           generator=generator, uniforms=uniforms)
    v = torch.sort(visited.long(), dim=1).values
    top_counts, pos = _top(_run_length_counts(v, graph.sentinel), hi)
    window_nodes = v.gather(1, pos)[:, min_rank:hi]
    valid = (top_counts[:, min_rank:hi] > 0) & (window_nodes < num_movies)
    if noise is None:
        noise = torch.rand(window_nodes.shape, generator=generator, device=device)
    score = torch.where(valid, noise, -torch.inf)
    kk = min(num_hard, window_nodes.shape[1])
    top_scores, sel = _top(score, kk)
    chosen = window_nodes.gather(1, sel)
    chosen_ok = torch.isfinite(top_scores)
    if kk < num_hard:
        chosen = torch.nn.functional.pad(chosen, (0, num_hard - kk))
        chosen_ok = torch.nn.functional.pad(chosen_ok, (0, num_hard - kk))
    return torch.where(chosen_ok, chosen, fallback.long()).to(torch.int32)


def curriculum_num_hard(epoch: int, max_hard: int = 6) -> int:
    """0 before epoch 1, then ``min(epoch, max_hard)``."""
    return 0 if epoch < 1 else min(epoch, max_hard)
