"""Frozen copy of the port's synthetic MovieLens-shaped generator.

``movie_recommendation_engine_tpu_torch/graph/synthetic.py`` as it stood when
the benchmark was written, numpy only: the benchmark's corpora are data, and
a later change to the program's generator must not change them. A CPU test
(``benchmarks/tests/test_benchmarks_corpus.py``) holds this copy equal to the program's
on one seed.

Movies with genre/title/year metadata, users with power-law activity,
timestamped ratings and tags; raw ids are non-contiguous (movie ids stride 3,
user ids stride 7).
"""

from __future__ import annotations

import numpy as np

GENRES = [
    "Action", "Adventure", "Animation", "Children", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "IMAX",
    "Musical", "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]

_TITLE_WORDS = [
    "Midnight", "Return", "Shadow", "Garden", "Last", "First", "Lost", "City",
    "Dream", "Storm", "River", "Golden", "Silent", "Broken", "Hidden", "Iron",
    "Crimson", "Winter", "Summer", "Star", "Moon", "Fire", "Stone", "Glass",
    "Echo", "Paper", "Velvet", "Electric", "Neon", "Savage",
]


def generate(
    num_movies: int = 2000,
    num_users: int = 5000,
    num_ratings: int = 100_000,
    seed: int = 0,
    with_tags: bool = True,
) -> dict[str, np.ndarray | list[str]]:
    """Returns a dict with the columns the CSV loaders would produce:

    - movie_ids [M], titles [M] (with "(YYYY)" suffixes), genres [M] ('|'-joined)
    - rating_user_ids [R], rating_movie_ids [R], rating_values [R],
      rating_timestamps [R]
    - tag_user_ids / tag_movie_ids / tag_values (if with_tags)

    Raw ids are deliberately non-contiguous (movie ids stride 3, user ids
    stride 7) to exercise the id->index mapping paths
    (reference data/dataset.py:77-89).
    """
    rng = np.random.default_rng(seed)

    movie_ids = np.arange(1, num_movies + 1) * 3
    user_ids = np.arange(1, num_users + 1) * 7

    years = rng.integers(1930, 2020, size=num_movies)
    titles = []
    for i in range(num_movies):
        w = rng.choice(len(_TITLE_WORDS), size=2, replace=False)
        titles.append(
            f"{_TITLE_WORDS[w[0]]} {_TITLE_WORDS[w[1]]} {i} ({years[i]})"
        )
    genre_strs = []
    for i in range(num_movies):
        k = int(rng.integers(1, 4))
        gs = rng.choice(len(GENRES), size=k, replace=False)
        genre_strs.append("|".join(GENRES[g] for g in sorted(gs)))

    # Power-law popularity / activity (Zipf-ish via Pareto).
    movie_pop = rng.pareto(1.2, size=num_movies) + 1.0
    movie_pop /= movie_pop.sum()
    user_act = rng.pareto(1.2, size=num_users) + 1.0
    user_act /= user_act.sum()

    # Latent taste structure: each movie's primary cluster is its first
    # genre; each user prefers 1-3 genres. A user's ratings draw mostly
    # (80%) from popular movies inside their preferred genres — giving the
    # co-engagement graph real, learnable structure aligned with the genre
    # content features (without it, positives are popularity noise and no
    # recommender can beat chance).
    primary = np.array(
        [GENRES.index(g.split("|")[0]) for g in genre_strs], dtype=np.int64
    )
    cluster_movies = [np.flatnonzero(primary == c) for c in range(len(GENRES))]
    cluster_pop = [
        movie_pop[m] / movie_pop[m].sum() if m.size else None
        for m in cluster_movies
    ]
    user_num_prefs = rng.integers(1, 4, size=num_users)
    user_prefs = [
        rng.choice(len(GENRES), size=k, replace=False) for k in user_num_prefs
    ]

    r_user = rng.choice(num_users, size=num_ratings, p=user_act)
    r_movie = np.empty(num_ratings, dtype=np.int64)
    in_pref = rng.random(num_ratings) < 0.8
    # Off-preference draws: global popularity.
    off = ~in_pref
    r_movie[off] = rng.choice(num_movies, size=int(off.sum()), p=movie_pop)
    # In-preference draws: popularity within one of the user's genres.
    idx_in = np.flatnonzero(in_pref)
    chosen_cluster = np.array([
        user_prefs[u][rng.integers(0, len(user_prefs[u]))] for u in r_user[idx_in]
    ])
    for c in range(len(GENRES)):
        sel = idx_in[chosen_cluster == c]
        if sel.size == 0:
            continue
        movies_c, pop_c = cluster_movies[c], cluster_pop[c]
        if movies_c.size == 0:
            r_movie[sel] = rng.choice(num_movies, size=sel.size, p=movie_pop)
        else:
            r_movie[sel] = movies_c[rng.choice(movies_c.size, size=sel.size, p=pop_c)]

    # Ratings: higher for in-preference movies (MovieLens-like half steps).
    base = np.where(
        in_pref,
        rng.normal(4.0, 0.7, size=num_ratings),
        rng.normal(3.0, 1.0, size=num_ratings),
    )
    r_value = np.round(np.clip(base, 0.5, 5.0) * 2.0) / 2.0
    r_ts = rng.integers(8.0e8, 1.6e9, size=num_ratings)

    # Deduplicate (user, movie) pairs keeping the first occurrence, like real
    # MovieLens which has at most one rating per (user, movie).
    key = r_user.astype(np.int64) * num_movies + r_movie
    _, first = np.unique(key, return_index=True)
    first.sort()
    r_user, r_movie, r_value, r_ts = (
        r_user[first], r_movie[first], r_value[first], r_ts[first]
    )

    out: dict[str, np.ndarray | list[str]] = {
        "movie_ids": movie_ids,
        "titles": titles,
        "genres": genre_strs,
        "rating_user_ids": user_ids[r_user],
        "rating_movie_ids": movie_ids[r_movie],
        "rating_values": r_value.astype(np.float32),
        "rating_timestamps": r_ts.astype(np.int64),
    }

    if with_tags:
        num_tags = max(1, len(first) // 20)
        t_sel = rng.choice(len(first), size=num_tags, replace=False)
        tag_vocab = [w.lower() for w in _TITLE_WORDS] + [g.lower() for g in GENRES]
        out["tag_user_ids"] = out["rating_user_ids"][t_sel]
        out["tag_movie_ids"] = out["rating_movie_ids"][t_sel]
        out["tag_values"] = np.array(
            [tag_vocab[i] for i in rng.integers(0, len(tag_vocab), size=num_tags)]
        )
    return out
