"""Genre-similarity fallback evaluation.

Mirrors reference ``evaluate_model_genre_similarity`` (run.py:254-328): when
no interaction-derived test pairs exist, build synthetic positive pairs from
genre overlap — for each of up to 1000 sampled movies, pick a random other
movie sharing at least one genre — then run the standard HR@k/MRR evaluation
against them.
"""

from __future__ import annotations

import numpy as np

from .metrics import evaluate_embeddings


def genre_similarity_pairs(
    genres: list[str],
    sample_size: int = 1000,
    seed: int = 42,
) -> np.ndarray:
    """[P, 2] (movie_idx, similar_movie_idx) pairs sharing >= 1 genre."""
    n = len(genres)
    genre_sets = [set(g.split("|")) - {""} for g in genres]
    # Inverted index: genre -> movie indices.
    by_genre: dict[str, list[int]] = {}
    for i, gs in enumerate(genre_sets):
        for g in gs:
            by_genre.setdefault(g, []).append(i)

    rng = np.random.default_rng(seed)
    sampled = rng.choice(n, size=min(sample_size, n), replace=False)
    pairs = []
    for i in sampled:
        gs = genre_sets[i]
        if not gs:
            continue
        g = list(gs)[rng.integers(0, len(gs))]
        candidates = by_genre.get(g, [])
        if len(candidates) < 2:
            continue
        j = candidates[rng.integers(0, len(candidates))]
        tries = 0
        while j == i and tries < 10:
            j = candidates[rng.integers(0, len(candidates))]
            tries += 1
        if j != i:
            pairs.append([i, j])
    if not pairs:
        return np.zeros((0, 2), dtype=np.int64)
    return np.asarray(pairs, dtype=np.int64)


def evaluate_genre_similarity(
    embeddings,
    genres: list[str],
    k_values=(10, 50, 100, 500),
    mrr_scale: float = 100.0,
    sample_size: int = 1000,
    seed: int = 42,
) -> dict[str, float]:
    pairs = genre_similarity_pairs(genres, sample_size=sample_size, seed=seed)
    return evaluate_embeddings(embeddings, pairs, k_values=k_values,
                               mrr_scale=mrr_scale)
