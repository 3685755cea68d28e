"""Dataset ingest: MovieLens CSVs (or the synthetic generator) -> packed arrays.

Port of ``movie_recommendation_engine_tpu/graph/dataset.py``: filters users
with fewer than ``min_interactions`` ratings (``data/dataset.py:56-58``),
builds contiguous id<->idx maps (``data/dataset.py:77-89``), and exposes
vectorized graph/split/feature construction. The JAX package reads the CSVs
with pandas; this one has no pandas, so ``ratings.csv`` goes through the
native parser (``utils/ingest_native``, with a stdlib reader as its plain
version) and the other three files through the stdlib ``csv`` module, which
gives the fields pandas' ``read_csv`` defaults give: its NA strings read as
missing, quoted fields unquoted, integer columns parsed as integers.
"""

from __future__ import annotations

import csv
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..config import Config
from ..core.logging import MetricsLogger
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
        self, threshold: int = 5, max_items_per_user: int | None = None,
        logger: MetricsLogger | None = None,
    ) -> CSRGraph:
        return builders.build_item_similarity_graph(
            self.user_idx, self.movie_idx, self.num_movies,
            threshold=threshold, max_items_per_user=max_items_per_user, logger=logger,
        )

    def temporal_split(self, val_ratio: float = 0.1, test_ratio: float = 0.2):
        return split_mod.temporal_split(
            self.user_idx, self.movie_idx, self.ratings, self.timestamps,
            val_ratio=val_ratio, test_ratio=test_ratio,
        )

    def histories(self, window: int) -> split_mod.Histories:
        """Every user's ratings in time order, as leave-two-out windows of
        ``window`` items (``graph/split.leave_two_out``)."""
        return split_mod.leave_two_out(self.user_idx, self.movie_idx, self.timestamps,
                                       self.num_users, window)


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
    movie_ids, movie_idx = _first_appearance(mids)
    user_ids, user_idx = _first_appearance(uids)
    return user_idx, movie_idx, vals, ts, movie_ids, user_ids


def _first_appearance(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(the distinct values of ``x`` in order of first appearance, the int64
    index of each element among them): the JAX package's per-row dict
    lookups, vectorized."""
    uniq, first, inv = np.unique(x, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(order.shape[0], np.int64)
    rank[order] = np.arange(order.shape[0])
    return uniq[order], rank[inv.reshape(-1)]


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


# pandas' ``read_csv`` default NA strings (``pandas._libs.parsers.STR_NA_VALUES``):
# the JAX loader reads the CSVs with pandas, where a field equal to one of
# them (quoted or not) is missing.
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


def _read_columns(path: str, names: tuple[str, ...]) -> list[list[str]]:
    """The named columns of a CSV with a header row, as unquoted strings."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = csv.reader(f)
        header = next(rows)
        pos = [header.index(n) for n in names]
        cols: list[list[str]] = [[] for _ in names]
        for row in rows:
            if not row:
                continue
            for col, p in zip(cols, pos):
                col.append(row[p])
    return cols


def _int_or(values: list[str], missing: int) -> np.ndarray:
    """int64 column; NA strings -> ``missing`` (pandas' NaN, then fillna)."""
    return np.array([missing if v in NA_STRINGS else int(v) for v in values], np.int64)


def read_ratings_python(path: str):
    """The native parser's plain version: (user ids int32, movie ids int32,
    ratings f32, timestamps int64) read with the stdlib ``csv`` module."""
    u, m, r, t = _read_columns(path, ("userId", "movieId", "rating", "timestamp"))
    return (np.array(u, np.int64).astype(np.int32), np.array(m, np.int64).astype(np.int32),
            np.array(r, np.float64).astype(np.float32), np.array(t, np.int64))


def _read_ratings(path: str, threads: int, logger: MetricsLogger | None):
    """``ratings.csv`` through the native parser with ``threads`` threads,
    or through ``read_ratings_python`` when the parser does not build; logs
    the route (``ingest``)."""
    from ..utils import ingest_native, native

    t0 = time.perf_counter()
    route, reason = "native", None
    try:
        cols = ingest_native.read_ratings_csv(path, num_threads=threads)
    except native.BuildError as e:
        route, reason = "python", str(e)
        cols = read_ratings_python(path)
    if logger is not None:
        logger.log("ingest", route=route, reason=reason, rows=int(cols[0].shape[0]),
                   threads=threads if route == "native" else 1,
                   seconds=time.perf_counter() - t0)
    return cols


def load_movielens_csv(cfg: Config, logger: MetricsLogger | None = None) -> MovieLensData:
    """Load movies / ratings / tags / links CSVs from ``cfg.data.data_dir``
    (reference ``data/dataset.py:41-75``). The four files load concurrently
    on a pool of ``min(train.num_workers, 4)`` threads, and the ratings
    parser uses ``train.num_workers`` threads. ``tags.csv`` and ``links.csv``
    are optional."""
    d = cfg.data.data_dir
    workers = max(int(cfg.train.num_workers), 1)

    def load_movies():
        ids, titles, genres = _read_columns(os.path.join(d, "movies.csv"),
                                            ("movieId", "title", "genres"))
        return (np.array(ids, np.int64), ["" if t in NA_STRINGS else t for t in titles],
                ["" if g in NA_STRINGS else g for g in genres])

    def load_tags():
        path = os.path.join(d, "tags.csv")
        if not os.path.exists(path):
            return None
        ids, tags = _read_columns(path, ("movieId", "tag"))
        # A missing tag is "nan", as pandas' astype(str) of NaN; _join_tags
        # drops it.
        return np.array(ids, np.int64), np.array(
            ["nan" if t in NA_STRINGS else t for t in tags], dtype=object)

    def load_links():
        path = os.path.join(d, "links.csv")
        if not os.path.exists(path):
            return None
        ids, imdb, tmdb = _read_columns(path, ("movieId", "imdbId", "tmdbId"))
        return np.array(ids, np.int64), _int_or(imdb, -1), _int_or(tmdb, -1)

    with ThreadPoolExecutor(max_workers=min(workers, 4)) as pool:
        f_movies = pool.submit(load_movies)
        f_ratings = pool.submit(_read_ratings, os.path.join(d, "ratings.csv"), workers, logger)
        f_tags = pool.submit(load_tags)
        f_links = pool.submit(load_links)
        movie_ids, titles, genres = f_movies.result()
        ratings_cols = f_ratings.result()
        tag_cols = f_tags.result()
        link_cols = f_links.result()

    raw: dict = {
        "movie_ids": movie_ids,
        "titles": titles,
        "genres": genres,
        "rating_user_ids": ratings_cols[0],
        "rating_movie_ids": ratings_cols[1],
        "rating_values": ratings_cols[2],
        "rating_timestamps": ratings_cols[3],
    }
    if tag_cols is not None:
        raw["tag_movie_ids"], raw["tag_values"] = tag_cols
    if link_cols is not None:
        raw["link_movie_ids"], raw["link_imdb"], raw["link_tmdb"] = link_cols
    return _from_columns(raw, cfg)


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


def load(cfg: Config, logger: MetricsLogger | None = None) -> MovieLensData:
    """``data.source``: "synthetic" (the generator) or "movielens" (the CSVs
    in ``data.data_dir``; ``logger`` receives the ``ingest`` event)."""
    if cfg.data.source == "synthetic":
        return load_synthetic(cfg)
    return load_movielens_csv(cfg, logger)
