"""Per-user temporal train/val/test split, fully vectorized.

Reference semantics (``data/dataset.py:172-248``): for each user, sort their
ratings by timestamp; the last ``max(1, int(n*test_ratio))`` go to test, the
previous ``max(1, int(n*val_ratio))`` to val, the remainder to train. Each
split carries its own bidirectional edge_index/edge_weights and
``positive_pairs = [user_idx + num_movies, movie_idx]`` rows
(``data/dataset.py:239``).

The reference implements this as a Python loop over every user
(``data/dataset.py:193-203``) — one of its host hot spots (SURVEY.md §3.1).
Here it is one argsort + rank arithmetic over all ratings at once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SplitData:
    """One split's tensors (mirrors the dict built at data/dataset.py:242-246)."""

    user_idx: np.ndarray      # [P] int64 (NOT offset)
    movie_idx: np.ndarray     # [P] int64
    ratings: np.ndarray       # [P] float32
    timestamps: np.ndarray    # [P] int64

    def positive_pairs(self, num_movies: int) -> np.ndarray:
        """[P, 2] rows of (user_idx + num_movies, movie_idx)."""
        return np.stack([self.user_idx + num_movies, self.movie_idx], axis=1)

    @property
    def num_interactions(self) -> int:
        return int(self.user_idx.shape[0])


def temporal_split(
    user_idx: np.ndarray,
    movie_idx: np.ndarray,
    ratings: np.ndarray,
    timestamps: np.ndarray,
    val_ratio: float = 0.1,
    test_ratio: float = 0.2,
) -> tuple[SplitData, SplitData, SplitData]:
    u = np.asarray(user_idx, dtype=np.int64)
    m = np.asarray(movie_idx, dtype=np.int64)
    r = np.asarray(ratings, dtype=np.float32)
    t = np.asarray(timestamps, dtype=np.int64)

    # Sort by (user, timestamp); stable to match pandas sort_values.
    order = np.lexsort((t, u))
    u_s, m_s, r_s, t_s = u[order], m[order], r[order], t[order]

    n = u_s.shape[0]
    # Group sizes and per-row position within the group.
    change = np.empty(n, dtype=bool)
    if n:
        change[0] = True
        change[1:] = u_s[1:] != u_s[:-1]
    group_id = np.cumsum(change) - 1
    group_start_rows = np.flatnonzero(change)
    sizes = np.diff(np.concatenate([group_start_rows, [n]]))
    pos = np.arange(n) - group_start_rows[group_id]          # 0-based within group
    size_of_row = sizes[group_id]
    pos_from_end = size_of_row - 1 - pos                      # 0 = newest

    n_test = np.maximum(1, (size_of_row * test_ratio).astype(np.int64))
    n_val = np.maximum(1, (size_of_row * val_ratio).astype(np.int64))

    is_test = pos_from_end < n_test
    is_val = (~is_test) & (pos_from_end < n_test + n_val)
    # Reference train slice is iloc[:-(n_test+n_val)] — everything older.
    is_train = ~(is_test | is_val)

    def take(mask: np.ndarray) -> SplitData:
        return SplitData(u_s[mask], m_s[mask], r_s[mask], t_s[mask])

    return take(is_train), take(is_val), take(is_test)


def corated_item_pairs(
    user_idx: np.ndarray,
    movie_idx: np.ndarray,
    ratings: np.ndarray,
    min_rating: float = 4.0,
    max_pairs_per_user: int = 50,
    max_pairs: int | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Item-item positive pairs: movies co-rated >= min_rating by one user.

    This is how the reference builds *real* evaluation pairs when the split's
    user-movie pairs can't be used directly (``run.py:184-237``, loop capped at
    50 pairs per user at run.py:217). Also the canonical source of training
    pairs for the true PinSage objective (items related by co-engagement,
    README:130-145).

    Returns [P, 2] int64 (query_movie, positive_movie).
    """
    u = np.asarray(user_idx, dtype=np.int64)
    m = np.asarray(movie_idx, dtype=np.int64)
    r = np.asarray(ratings, dtype=np.float32)
    keep = r >= min_rating
    u, m = u[keep], m[keep]
    order = np.argsort(u, kind="stable")
    u_s, m_s = u[order], m[order]
    boundaries = np.flatnonzero(np.diff(u_s)) + 1
    starts = np.concatenate([[0], boundaries]) if u_s.size else np.array([], dtype=np.int64)
    ends = np.concatenate([boundaries, [u_s.shape[0]]]) if u_s.size else np.array([], dtype=np.int64)

    rng = np.random.default_rng(seed)
    out: list[np.ndarray] = []
    total = 0
    for s, e in zip(starts, ends):
        items = m_s[s:e]
        n = items.shape[0]
        if n < 2:
            continue
        ii, jj = np.triu_indices(n, k=1)
        if ii.shape[0] > max_pairs_per_user:
            sel = rng.choice(ii.shape[0], size=max_pairs_per_user, replace=False)
            ii, jj = ii[sel], jj[sel]
        out.append(np.stack([items[ii], items[jj]], axis=1))
        total += ii.shape[0]
        if max_pairs is not None and total >= max_pairs:
            break
    if not out:
        return np.zeros((0, 2), dtype=np.int64)
    pairs = np.concatenate(out, axis=0)
    if max_pairs is not None and pairs.shape[0] > max_pairs:
        pairs = pairs[rng.permutation(pairs.shape[0])[:max_pairs]]
    return pairs
