"""ctypes bridge to the native co-occurrence counter (``cpp/cooc.cc``).

Port of ``movie_recommendation_engine_tpu/utils/cooc_native.py``, built by
``utils/native.py``. A failed build raises ``native.BuildError``;
``graph/builders.build_item_similarity_graph`` then counts in numpy.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native

FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def _lib() -> ctypes.CDLL:
    lib = native.library("cooc", FLAGS)
    lib.cooc_count.restype = ctypes.c_void_p
    lib.cooc_count.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ]
    lib.cooc_num_edges.restype = ctypes.c_longlong
    lib.cooc_num_edges.argtypes = [ctypes.c_void_p]
    lib.cooc_fill.restype = None
    lib.cooc_fill.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
    ]
    lib.cooc_free.restype = None
    lib.cooc_free.argtypes = [ctypes.c_void_p]
    return lib


def count_cooccurrence(user_idx_sorted: np.ndarray, movie_idx: np.ndarray,
                       num_movies: int, threshold: int):
    """-> (src int32[E], dst int32[E], count f32[E]) of the movie pairs
    src < dst rated by at least ``threshold`` common users.
    ``user_idx_sorted`` must be ascending, ``movie_idx`` in [0, num_movies)."""
    lib = _lib()
    u = np.ascontiguousarray(user_idx_sorted, dtype=np.int64)
    m = np.ascontiguousarray(movie_idx, dtype=np.int64)
    if u.shape != m.shape:
        raise ValueError(f"user and movie columns differ in shape: {u.shape}, {m.shape}")
    handle = lib.cooc_count(
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        u.shape[0], num_movies, threshold, 0,
    )
    if not handle:
        raise MemoryError("cooc_count failed")
    try:
        e = lib.cooc_num_edges(handle)
        src = np.empty(e, np.int32)
        dst = np.empty(e, np.int32)
        w = np.empty(e, np.float32)
        if e:
            lib.cooc_fill(
                handle,
                src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
    finally:
        lib.cooc_free(handle)
    return src, dst, w
