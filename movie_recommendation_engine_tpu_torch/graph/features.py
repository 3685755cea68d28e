"""Movie content-feature pipeline.

Semantics match reference ``data/feature_extractor.py:21-198``:
- genre one-hot, scaled by 2.0 (:111-121)
- release year parsed from the "(YYYY)" title suffix, normalized by /2020 (:123-138)
- title TF-IDF (max 100 features, min_df 5, english stop words) (:140-163)
- tag TF-IDF (max 200 features, min_df 3, english stop words) (:165-198)
- hstack -> reorder by movie index -> StandardScaler -> PCA to feature_dim (:89-102)

TF-IDF runs host-side (sklearn when available, an in-repo vectorizer
otherwise). Standardize+PCA also run host-side in numpy (``numpy.linalg.eigh``
on the covariance): the covariance build is a one-off [F, F] matmul, and a
host eigendecomposition keeps the whole feature pipeline backendless.

Copy of ``movie_recommendation_engine_tpu/graph/features.py`` without its
unused JAX imports. Features match the JAX package only where both take the
same TF-IDF branch: a machine without sklearn uses ``_tfidf_fallback``.

Also provides the dummy visual-feature generator
(feature_extractor.py:200-220) and the simple genre+year-dummies variant
(data/dataset.py:125-170).
"""

from __future__ import annotations

import re

import numpy as np

from .synthetic import GENRES as _CANON_GENRES

_YEAR_RE = re.compile(r"\((\d{4})\)$")
_YEAR_STRIP_RE = re.compile(r"\s*\(\d{4}\)$")

# Minimal english stop word handling for the fallback vectorizer.
_FALLBACK_STOP = {
    "the", "a", "an", "of", "and", "in", "on", "to", "for", "at", "by",
    "with", "is", "it", "its", "from", "as", "or", "be",
}


def genre_onehot(genres: list[str], weight: float = 2.0) -> tuple[np.ndarray, list[str]]:
    """'|'-split one-hot like pd.get_dummies (feature_extractor.py:116-121)."""
    vocab: dict[str, int] = {}
    for g in genres:
        for tok in g.split("|"):
            if tok and tok not in vocab:
                vocab[tok] = len(vocab)
    # Stable alphabetical order like get_dummies columns.
    names = sorted(vocab)
    col = {n: i for i, n in enumerate(names)}
    out = np.zeros((len(genres), len(names)), dtype=np.float32)
    for r, g in enumerate(genres):
        for tok in g.split("|"):
            if tok:
                out[r, col[tok]] = weight
    return out, names


def year_feature(titles: list[str], norm: float = 2020.0) -> np.ndarray:
    """[M, 1] year/norm, 0 when missing (feature_extractor.py:123-138)."""
    years = np.zeros((len(titles), 1), dtype=np.float32)
    for i, t in enumerate(titles):
        m = _YEAR_RE.search(t.strip())
        if m:
            years[i, 0] = float(m.group(1))
    if years.max() > 0:
        years = years / norm
    return years


def strip_year(title: str) -> str:
    return _YEAR_STRIP_RE.sub("", title)


def tfidf(
    docs: list[str], max_features: int, min_df: int
) -> np.ndarray | None:
    """TF-IDF with sklearn semantics (smooth idf, l2 row norm, english
    stop words); falls back to an in-repo vectorizer with the same formula
    when sklearn is unavailable. Returns None when no vocabulary survives
    (the reference skips the block in that case, feature_extractor.py:158-163).
    """
    try:
        from sklearn.feature_extraction.text import TfidfVectorizer

        vec = TfidfVectorizer(
            max_features=max_features, min_df=min_df, stop_words="english"
        )
        try:
            return vec.fit_transform(docs).toarray().astype(np.float32)
        except ValueError:
            return None
    except ImportError:
        return _tfidf_fallback(docs, max_features, min_df)


def _tfidf_fallback(docs: list[str], max_features: int, min_df: int) -> np.ndarray | None:
    token_re = re.compile(r"(?u)\b\w\w+\b")
    doc_tokens = [
        [t for t in token_re.findall(d.lower()) if t not in _FALLBACK_STOP]
        for d in docs
    ]
    df: dict[str, int] = {}
    for toks in doc_tokens:
        for t in set(toks):
            df[t] = df.get(t, 0) + 1
    vocab = [t for t, c in df.items() if c >= min_df]
    if not vocab:
        return None
    # Keep the max_features highest-document-frequency terms (sklearn rule).
    vocab.sort(key=lambda t: (-df[t], t))
    vocab = sorted(vocab[:max_features])
    col = {t: i for i, t in enumerate(vocab)}
    n, v = len(docs), len(vocab)
    tf = np.zeros((n, v), dtype=np.float32)
    for r, toks in enumerate(doc_tokens):
        for t in toks:
            if t in col:
                tf[r, col[t]] += 1.0
    idf = np.log((1.0 + n) / (1.0 + np.array([df[t] for t in vocab]))) + 1.0
    x = tf * idf[None, :]
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return (x / norms).astype(np.float32)


def standardize_pca(features: np.ndarray, out_dim: int, seed: int = 0,
                    standardize: bool = True) -> np.ndarray:
    """[StandardScaler +] PCA (feature_extractor.py:89-102 semantics).

    ``standardize=True`` reproduces the reference exactly (per-column scale
    to unit variance before PCA). Measured effects cut both ways: on raw
    feature-cosine retrieval it equalizes informative genre columns with
    near-constant TF-IDF noise columns (HR@10 of feature cosine drops ~3x on
    structured synthetic data), but on *trained* ml1m quality with PCA active
    it slightly helps (HR@10 0.0485 -> 0.0532, RESULTS.md ablation
    2026-08-20). Default stays center-only (``standardize=False``,
    FeatureConfig.standardize) for the retrieval-robustness reason; enabling
    it is worth trying whenever feature_dim < raw width.

    One-time host-side featurization: the eigendecomposition runs in numpy
    (LAPACK), as in the JAX package, so both give the same features; the
    projection matmul is cheap either way (F is a few hundred).
    """
    x = np.asarray(features, dtype=np.float64)
    mean = x.mean(axis=0, keepdims=True)
    if standardize:
        std = x.std(axis=0, keepdims=True)
        std[std == 0] = 1.0
        xs = (x - mean) / std
    else:
        xs = x - mean
    n = xs.shape[0]
    cov = (xs.T @ xs) / max(n - 1, 1)
    eigvals, eigvecs = np.linalg.eigh(cov)         # ascending order
    top = eigvecs[:, ::-1][:, :out_dim]            # principal components
    # Sign convention: make the largest-|.| loading positive per component
    # (matches sklearn's deterministic svd_flip up to data-degenerate ties).
    idx = np.argmax(np.abs(top), axis=0)
    signs = np.sign(top[idx, np.arange(top.shape[1])])
    signs[signs == 0] = 1.0
    top = top * signs[None, :]
    return (xs @ top).astype(np.float32)


def extract_movie_features(
    titles: list[str],
    genres: list[str],
    movie_tags: list[str] | None,
    feature_dim: int = 128,
    genre_weight: float = 2.0,
    year_norm: float = 2020.0,
    title_tfidf_max: int = 100,
    title_tfidf_min_df: int = 5,
    tag_tfidf_max: int = 200,
    tag_tfidf_min_df: int = 3,
    seed: int = 0,
    standardize: bool = False,
) -> np.ndarray:
    """Full pipeline -> [num_movies, feature_dim] float32.

    If the combined raw width is <= feature_dim, features are zero-padded to
    feature_dim instead of PCA-reduced (the reference only reduces when the
    raw width exceeds the target, feature_extractor.py:90).
    """
    parts: list[np.ndarray] = []
    g, _ = genre_onehot(genres, weight=genre_weight)
    if g.size:
        parts.append(g)
    parts.append(year_feature(titles, norm=year_norm))
    t = tfidf([strip_year(x) for x in titles], title_tfidf_max, title_tfidf_min_df)
    if t is not None:
        parts.append(t)
    if movie_tags is not None and any(movie_tags):
        tg = tfidf(movie_tags, tag_tfidf_max, tag_tfidf_min_df)
        if tg is not None:
            parts.append(tg)
    combined = np.hstack(parts).astype(np.float32)
    if feature_dim < combined.shape[1]:
        return standardize_pca(combined, feature_dim, seed=seed,
                               standardize=standardize)
    if feature_dim > combined.shape[1]:
        pad = np.zeros((combined.shape[0], feature_dim - combined.shape[1]), np.float32)
        combined = np.hstack([combined, pad])
    return combined


def simple_movie_features(
    titles: list[str],
    genres: list[str],
    feature_dim: int = 128,
    seed: int = 0,
) -> np.ndarray:
    """The dataset-internal simple variant (data/dataset.py:125-170):
    genre one-hot (unweighted) + per-year dummy columns, projected to
    ``feature_dim`` by a random (untrained) linear map when wider — matching
    the reference's untrained nn.Linear projection at data/dataset.py:161-164.
    """
    g, _ = genre_onehot(genres, weight=1.0)
    years = []
    for t in titles:
        m = _YEAR_RE.search(t.strip())
        years.append(m.group(1) if m else "")
    uniq = sorted({y for y in years if y})
    col = {y: i for i, y in enumerate(uniq)}
    yd = np.zeros((len(titles), len(uniq)), dtype=np.float32)
    for r, y in enumerate(years):
        if y:
            yd[r, col[y]] = 1.0
    combined = np.hstack([g, yd]).astype(np.float32) if g.size else yd
    if feature_dim < combined.shape[1]:
        rng = np.random.default_rng(seed)
        fan_in = combined.shape[1]
        bound = 1.0 / np.sqrt(fan_in)
        w = rng.uniform(-bound, bound, (fan_in, feature_dim)).astype(np.float32)
        b = rng.uniform(-bound, bound, feature_dim).astype(np.float32)
        return combined @ w + b
    if feature_dim > combined.shape[1]:
        pad = np.zeros((combined.shape[0], feature_dim - combined.shape[1]), np.float32)
        combined = np.hstack([combined, pad])
    return combined


def create_visual_features(num_movies: int, feature_dim: int = 128, seed: int = 0) -> np.ndarray:
    """Random unit-norm placeholder visual features
    (feature_extractor.py:200-220)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((num_movies, feature_dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def node_feature_table(movie_features: np.ndarray, num_users: int) -> np.ndarray:
    """[num_nodes, F] with zero rows for users (data/dataset.py:258-263)."""
    f = movie_features.shape[1]
    users = np.zeros((num_users, f), dtype=np.float32)
    return np.concatenate([movie_features.astype(np.float32), users], axis=0)
