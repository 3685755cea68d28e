"""Dataset ingest: the synthetic generator -> packed arrays.

Copy of ``movie_recommendation_engine_tpu/graph/dataset.py`` for
``data.source="synthetic"``: filters users with fewer than
``min_interactions`` ratings (``data/dataset.py:56-58``), builds contiguous
id<->idx maps (``data/dataset.py:77-89``), and exposes vectorized
graph/split/feature construction. The MovieLens CSV reader (pandas plus the
native ratings parser) is not ported yet (ROADMAP queue 1, "movielens
ingest").
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import Config
from . import builders, split as split_mod, synthetic
from .csr import CSRGraph


@dataclass
class MovieLensData:
    """Packed, index-mapped dataset."""

    # Interactions (index space, contiguous).
    user_idx: np.ndarray       # [R] int64 in [0, num_users)
    movie_idx: np.ndarray      # [R] int64 in [0, num_movies)
    ratings: np.ndarray        # [R] float32
    timestamps: np.ndarray     # [R] int64

    # Id maps.
    movie_ids: np.ndarray      # [num_movies] raw movieId per index
    user_ids: np.ndarray       # [num_users] raw userId per index

    # Movie metadata aligned to movie index (may be empty strings).
    titles: list[str] = field(default_factory=list)
    genres: list[str] = field(default_factory=list)

    # Optional tag text joined per movie index ('' when absent).
    movie_tags: list[str] = field(default_factory=list)

    # Optional external ids from links.csv, aligned to movie index; -1 where
    # missing (the reference loads links_df when present,
    # data/dataset.py:67-70 — unused downstream there too, kept for parity).
    imdb_ids: np.ndarray | None = None   # [num_movies] int64 or None
    tmdb_ids: np.ndarray | None = None   # [num_movies] int64 or None

    @property
    def num_movies(self) -> int:
        return int(self.movie_ids.shape[0])

    @property
    def num_users(self) -> int:
        return int(self.user_ids.shape[0])

    @property
    def num_nodes(self) -> int:
        """Bipartite node count: movies [0, M) then users [M, M+U)."""
        return self.num_movies + self.num_users

    @property
    def num_interactions(self) -> int:
        return int(self.user_idx.shape[0])

    def movie_id_to_idx(self) -> dict[int, int]:
        return {int(mid): i for i, mid in enumerate(self.movie_ids)}

    # ---- graph construction -------------------------------------------------

    def build_bipartite_graph(self) -> CSRGraph:
        return builders.build_bipartite_graph(
            self.user_idx, self.movie_idx, self.ratings,
            self.num_movies, self.num_users,
        )

    def build_item_similarity_graph(
        self, threshold: int = 5, max_items_per_user: int | None = None
    ) -> CSRGraph:
        return builders.build_item_similarity_graph(
            self.user_idx, self.movie_idx, self.num_movies,
            threshold=threshold, max_items_per_user=max_items_per_user,
        )

    def temporal_split(self, val_ratio: float = 0.1, test_ratio: float = 0.2):
        return split_mod.temporal_split(
            self.user_idx, self.movie_idx, self.ratings, self.timestamps,
            val_ratio=val_ratio, test_ratio=test_ratio,
        )


def _map_and_filter(
    rating_user_ids: np.ndarray,
    rating_movie_ids: np.ndarray,
    rating_values: np.ndarray,
    rating_timestamps: np.ndarray,
    min_interactions: int,
    subset_fraction: float | None,
    seed: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Subsample -> min-interaction filter -> contiguous id maps.

    Order matters and follows the reference pipeline: the subsample happens
    first (run.py:48 samples ratings_df before anything else reads it is
    actually after load/filter — reference filters in load_data then samples
    in process_data; we do filter -> sample identically), then id maps are
    built from the surviving ratings in first-appearance order
    (pd.unique semantics, data/dataset.py:80-86).
    """
    uids = np.asarray(rating_user_ids)
    mids = np.asarray(rating_movie_ids)
    vals = np.asarray(rating_values, dtype=np.float32)
    ts = np.asarray(rating_timestamps, dtype=np.int64)

    # Filter users with < min_interactions ratings (data/dataset.py:56-58).
    uniq_u, inv_u, counts = np.unique(uids, return_inverse=True, return_counts=True)
    keep = counts[inv_u] >= min_interactions
    uids, mids, vals, ts = uids[keep], mids[keep], vals[keep], ts[keep]

    # Optional ratings subsample (run.py:48; honored via config flags).
    if subset_fraction is not None and subset_fraction < 1.0:
        rng = np.random.default_rng(seed)
        n = uids.shape[0]
        sel = rng.permutation(n)[: max(1, int(n * subset_fraction))]
        sel.sort()
        uids, mids, vals, ts = uids[sel], mids[sel], vals[sel], ts[sel]

    # Contiguous maps in first-appearance order (pd.unique-like).
    movie_ids, movie_first = np.unique(mids, return_index=True)
    movie_ids = mids[np.sort(movie_first)]
    user_ids, user_first = np.unique(uids, return_index=True)
    user_ids = uids[np.sort(user_first)]

    movie_lut = {int(v): i for i, v in enumerate(movie_ids)}
    user_lut = {int(v): i for i, v in enumerate(user_ids)}
    movie_idx = np.fromiter((movie_lut[int(v)] for v in mids), dtype=np.int64, count=mids.shape[0])
    user_idx = np.fromiter((user_lut[int(v)] for v in uids), dtype=np.int64, count=uids.shape[0])
    return user_idx, movie_idx, vals, ts, movie_ids, user_ids


def _attach_metadata(
    data_movie_ids: np.ndarray,
    all_movie_ids: np.ndarray,
    titles: list[str],
    genres: list[str],
) -> tuple[list[str], list[str]]:
    lut = {int(mid): i for i, mid in enumerate(all_movie_ids)}
    out_t, out_g = [], []
    for mid in data_movie_ids:
        i = lut.get(int(mid))
        out_t.append(titles[i] if i is not None else "")
        out_g.append(genres[i] if i is not None else "")
    return out_t, out_g


def _join_tags(
    data_movie_ids: np.ndarray,
    tag_movie_ids: np.ndarray | None,
    tag_values: np.ndarray | None,
) -> list[str]:
    """Per-movie concatenated tag text (feature_extractor.py:176-184)."""
    m = data_movie_ids.shape[0]
    if tag_movie_ids is None or tag_values is None or len(tag_movie_ids) == 0:
        return [""] * m
    lut = {int(mid): i for i, mid in enumerate(data_movie_ids)}
    buckets: list[list[str]] = [[] for _ in range(m)]
    for mid, tag in zip(tag_movie_ids, tag_values):
        i = lut.get(int(mid))
        # Filter only true missing values (float NaN stringifies to "nan");
        # a substring test would drop real tags like "nanotechnology".
        tag_s = str(tag)
        if i is not None and tag_s != "nan":
            buckets[i].append(tag_s)
    return [" ".join(b) for b in buckets]


def load_synthetic(cfg: Config) -> MovieLensData:
    raw = synthetic.generate(
        num_movies=cfg.data.synthetic_num_movies,
        num_users=cfg.data.synthetic_num_users,
        num_ratings=cfg.data.synthetic_num_ratings,
        seed=(cfg.data.synthetic_seed if cfg.data.synthetic_seed >= 0
              else cfg.train.seed),
    )
    return _from_columns(raw, cfg)


def load_movielens_csv(cfg: Config) -> MovieLensData:
    """Not ported yet: the JAX reader needs pandas and the native ratings
    parser (``utils/ingest_native``)."""
    raise NotImplementedError(
        "data.source='movielens' is not ported to the PyTorch package yet "
        "(ROADMAP queue 1, 'movielens ingest'); use data.source='synthetic'"
    )


def _from_columns(raw: dict, cfg: Config) -> MovieLensData:
    subset = cfg.data.data_subset_fraction if cfg.data.use_data_subset else None
    user_idx, movie_idx, vals, ts, movie_ids, user_ids = _map_and_filter(
        raw["rating_user_ids"], raw["rating_movie_ids"],
        raw["rating_values"], raw["rating_timestamps"],
        cfg.data.min_interactions, subset, cfg.train.seed,
    )
    titles, genres = _attach_metadata(
        movie_ids, np.asarray(raw["movie_ids"]), list(raw["titles"]), list(raw["genres"])
    )
    movie_tags = _join_tags(movie_ids, raw.get("tag_movie_ids"), raw.get("tag_values"))
    imdb_ids = tmdb_ids = None
    if raw.get("link_movie_ids") is not None:
        lut = {int(mid): i for i, mid in enumerate(raw["link_movie_ids"])}
        m = movie_ids.shape[0]
        imdb_ids = np.full(m, -1, dtype=np.int64)
        tmdb_ids = np.full(m, -1, dtype=np.int64)
        for out_i, mid in enumerate(movie_ids):
            i = lut.get(int(mid))
            if i is not None:
                imdb_ids[out_i] = raw["link_imdb"][i]
                tmdb_ids[out_i] = raw["link_tmdb"][i]
    return MovieLensData(
        user_idx=user_idx, movie_idx=movie_idx, ratings=vals, timestamps=ts,
        movie_ids=movie_ids, user_ids=user_ids,
        titles=titles, genres=genres, movie_tags=movie_tags,
        imdb_ids=imdb_ids, tmdb_ids=tmdb_ids,
    )


def load(cfg: Config) -> MovieLensData:
    if cfg.data.source == "synthetic":
        return load_synthetic(cfg)
    return load_movielens_csv(cfg)
