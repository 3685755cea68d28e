"""ctypes bridge to the native ratings parser (``cpp/ingest.cc``).

Port of ``movie_recommendation_engine_tpu/utils/ingest_native.py``, built by
``utils/native.py`` into the port's own build directory. A failed build
raises ``native.BuildError``; ``graph/dataset.py`` then reads the file with
its stdlib reader.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native

FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")


def _lib() -> ctypes.CDLL:
    lib = native.library("ingest", FLAGS)
    lib.ingest_count_rows.restype = ctypes.c_longlong
    lib.ingest_count_rows.argtypes = [ctypes.c_char_p]
    lib.ingest_parse_ratings_mt.restype = ctypes.c_longlong
    lib.ingest_parse_ratings_mt.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_longlong,
        ctypes.c_int,
    ]
    return lib


def read_ratings_csv(path: str, num_threads: int = 1):
    """-> (user_ids int32[N], movie_ids int32[N], ratings f32[N],
    timestamps int64[N]) of a ``userId,movieId,rating,timestamp`` file with
    a header; malformed rows are skipped. ``num_threads`` > 1 parses line
    ranges in parallel, rows in file order."""
    lib = _lib()
    cap = lib.ingest_count_rows(path.encode())
    if cap < 0:
        raise FileNotFoundError(path)
    cap = max(cap + 1, 1)
    users = np.empty(cap, np.int32)
    movies = np.empty(cap, np.int32)
    ratings = np.empty(cap, np.float32)
    ts = np.empty(cap, np.int64)
    n = lib.ingest_parse_ratings_mt(
        path.encode(),
        users.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        movies.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ratings.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cap,
        max(int(num_threads), 1),
    )
    if n < 0:
        raise OSError(f"native parse failed for {path}")
    return users[:n], movies[:n], ratings[:n], ts[:n]
