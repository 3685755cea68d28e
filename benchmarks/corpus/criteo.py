"""A click corpus in MLPerf's preprocessed multi-hot layout, written once per
checkout: the frozen generator of the DLRM-DCNv2 cell's data.

A configuration's ``corpus`` fixes it as a dataset is fixed: the samples of
each split, the bag sizes and the rows held of each table, the id law and
the seed. The first run in a checkout generates it and writes, under
``benchmarks/.cache/criteo/<key>/``, per split ``<split>_dense.npy``,
``<split>_sparse_multi_hot.npz`` (one [n, K_f] int32 array per feature,
key ``str(f)``) and ``<split>_labels.npy``, the files the port's reader
(``graph/criteo.py``) loads; every run then loads them through it. The
directory is written under a temporary name and renamed when complete.

A seeded stand-in for Criteo 1TB, nothing fetched:

- dense features: per column a log-normal (its own location and scale),
  then ``log1p``, as MLPerf's preprocessing logs the raw counts;
- ids: a bag's first id follows a Zipf law of exponent ``zipf_s`` over a
  seeded permutation of the table's held rows (its rank drawn from the
  continuous law's inverse, floored); its other K_f - 1 ids are uniform
  over the held rows (the "uniform" multi-hot expansion of MLPerf's
  synthetic multi-hot data). Each table's permutation is the same in
  every split, so the held-out samples meet the same popular rows;
- labels: Bernoulli, the log-odds a fixed linear function of the dense
  features plus a seeded weight of each bag's first id, shifted so that
  the clicks average ``click_rate`` (Criteo's ~3.4%).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")
SPLITS = ("train", "val")


def corpus_dir(corpus: dict) -> str:
    key = hashlib.sha256(json.dumps(corpus, sort_keys=True).encode()).hexdigest()[:16]
    return os.path.join(CACHE, "criteo", key)


def files(d: str, split: str) -> list[str]:
    return [os.path.join(d, f"{split}_{name}") for name in
            ("dense.npy", "sparse_multi_hot.npz", "labels.npy")]


def _zipf_ranks(rng: np.random.Generator, n: int, rows: int, s: float) -> np.ndarray:
    """``n`` ranks in [0, rows): the floor of the continuous Zipf(s) law on
    [1, rows + 1) drawn by its inverse, less 1."""
    u = rng.random(n)
    top = (rows + 1.0) ** (1.0 - s)
    x = (1.0 - u * (1.0 - top)) ** (1.0 / (1.0 - s))
    return np.clip(np.floor(x).astype(np.int64) - 1, 0, rows - 1)


def _tables(corpus: dict) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per table, the permutation of its held rows and its rows' click
    weights, from the corpus seed alone (shared by the splits)."""
    out = []
    for f, rows in enumerate(corpus["rows_held"]):
        rng = np.random.default_rng([corpus["seed"], 1, f])
        out.append((rng.permutation(rows).astype(np.int32),
                    rng.normal(0.0, corpus["id_weight"], rows).astype(np.float32)))
    return out


def generate(corpus: dict, split: str, tables) -> tuple:
    """(dense [n, F_dense] f32, per feature [n, K_f] int32 ids, labels [n]
    f32) of ``split``."""
    n = corpus[f"{split}_samples"]
    k_dense = corpus["dense_features"]
    rng = np.random.default_rng([corpus["seed"], 2, SPLITS.index(split)])
    law = np.random.default_rng([corpus["seed"], 0])
    loc, scale = law.uniform(0.0, 4.0, k_dense), law.uniform(0.5, 2.0, k_dense)
    coef = law.normal(0.0, 0.5, k_dense) / k_dense ** 0.5
    dense = np.log1p(rng.lognormal(loc, scale, (n, k_dense))).astype(np.float32)
    z = (dense - np.log1p(np.exp(loc))) @ coef
    sparse = []
    for (perm, weight), k, rows in zip(tables, corpus["bag_sizes"], corpus["rows_held"]):
        ids = np.empty((n, k), np.int32)
        ids[:, 0] = perm[_zipf_ranks(rng, n, rows, corpus["zipf_s"])]
        if k > 1:
            ids[:, 1:] = rng.integers(0, rows, (n, k - 1), dtype=np.int32)
        z += weight[ids[:, 0]]
        sparse.append(ids)
    # The shift that makes the clicks average click_rate, by bisection on
    # the first 2**18 samples.
    lo, hi, head = -30.0, 30.0, z[:1 << 18]
    for _ in range(60):
        mid = (lo + hi) / 2
        if np.mean(1.0 / (1.0 + np.exp(-(head + mid)))) < corpus["click_rate"]:
            lo = mid
        else:
            hi = mid
    p = 1.0 / (1.0 + np.exp(-(z + lo)))
    labels = (rng.random(n) < p).astype(np.float32)
    return dense, sparse, labels


def _write(d: str, split: str, dense, sparse, labels) -> None:
    p_dense, p_sparse, p_labels = files(d, split)
    np.save(p_dense, dense)
    np.savez(p_sparse, **{str(f): s for f, s in enumerate(sparse)})
    np.save(p_labels, labels)


def ensure(corpus: dict) -> tuple[str, float | None]:
    """The directory of ``corpus``'s arrays (``seed``, ``dense_features``,
    ``bag_sizes``, ``rows_held``, ``train_samples``, ``val_samples``,
    ``zipf_s``, ``click_rate``, ``id_weight``), and the seconds spent
    generating and writing them in this call (None when they were there)."""
    d = corpus_dir(corpus)
    if all(os.path.exists(p) for s in SPLITS for p in files(d, s)):
        return d, None
    t0 = time.perf_counter()
    tmp = f"{d}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tables = _tables(corpus)
    for split in SPLITS:
        _write(tmp, split, *generate(corpus, split, tables))
    shutil.rmtree(d, ignore_errors=True)
    os.replace(tmp, d)
    return d, time.perf_counter() - t0
