"""Click samples in MLPerf's preprocessed multi-hot Criteo layout
(``data.source="criteo"``), the data of ``model.arch="dlrm_dcnv2"``.

A directory holds, per split (``train``, ``val`` and optionally ``test``):

- ``<split>_dense.npy``: [n, 13] float32 dense features, already ``log(x + 1)``;
- ``<split>_sparse_multi_hot.npz``: one [n, K_f] int32 id array per
  categorical feature f, under the key ``str(f)``;
- ``<split>_labels.npy``: [n] clicks (0 or 1, any numeric dtype).

These are the arrays MLPerf's reference materializes from Criteo 1TB
(dense, one multi-hot id array per feature, labels); the file names are the
port's. Every id of feature f must lie in ``[0, rows_f)``, the rows held of
table f (``model.dlrm_rows_held``); ``load`` checks it and the bag sizes
against ``model.dlrm_bag_sizes``.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np

SPLITS = ("train", "val", "test")


class ClickSplit(NamedTuple):
    dense: np.ndarray            # [n, dense] float32
    sparse: list[np.ndarray]     # per feature [n, K_f] int32
    labels: np.ndarray           # [n] float32

    @property
    def size(self) -> int:
        return int(self.labels.shape[0])


class CriteoData(NamedTuple):
    """The splits of a click corpus (``test`` may be None)."""

    train: ClickSplit
    val: ClickSplit
    test: ClickSplit | None
    data_dir: str


def paths(data_dir: str, split: str) -> dict[str, str]:
    return {k: os.path.join(data_dir, f"{split}_{k}.{ext}")
            for k, ext in (("dense", "npy"), ("sparse_multi_hot", "npz"), ("labels", "npy"))}


def write_split(data_dir: str, split: str, dense: np.ndarray, sparse: list[np.ndarray],
                labels: np.ndarray) -> None:
    """One split's three files in the layout ``load`` reads."""
    os.makedirs(data_dir, exist_ok=True)
    p = paths(data_dir, split)
    np.save(p["dense"], np.ascontiguousarray(dense, np.float32))
    np.savez(p["sparse_multi_hot"],
             **{str(f): np.ascontiguousarray(s, np.int32) for f, s in enumerate(sparse)})
    np.save(p["labels"], np.asarray(labels))


def read_split(data_dir: str, split: str, bag_sizes: tuple[int, ...],
               rows: tuple[int, ...]) -> ClickSplit:
    """One split, checked against the model's bag sizes and rows held."""
    p = paths(data_dir, split)
    dense = np.load(p["dense"]).astype(np.float32, copy=False)
    labels = np.load(p["labels"]).astype(np.float32, copy=False)
    with np.load(p["sparse_multi_hot"]) as z:
        if len(z.files) != len(bag_sizes):
            raise ValueError(f"{p['sparse_multi_hot']}: {len(z.files)} features, the model "
                             f"has {len(bag_sizes)}")
        sparse = [z[str(f)].astype(np.int32, copy=False) for f in range(len(bag_sizes))]
    n = labels.shape[0]
    if dense.ndim != 2 or dense.shape[0] != n:
        raise ValueError(f"{split}: dense {dense.shape} against {n} labels")
    for f, (s, k, r) in enumerate(zip(sparse, bag_sizes, rows)):
        if s.shape != (n, k):
            raise ValueError(f"{split}: feature {f} has ids {s.shape}, expected ({n}, {k})")
        if n and (int(s.min()) < 0 or int(s.max()) >= r):
            raise ValueError(f"{split}: feature {f}'s ids leave [0, {r}), its rows held")
    return ClickSplit(dense, sparse, labels)


def load(cfg, logger=None) -> CriteoData:
    """The splits in ``data.data_dir`` for ``cfg``'s model (``test`` None
    where its files are absent); ``logger`` gets the ``ingest`` event."""
    from ..models.dlrm import dims

    dm = dims(cfg)
    t0 = time.perf_counter()
    d = cfg.data.data_dir
    splits = {s: read_split(d, s, dm.bags, dm.rows) if s != "test"
              or os.path.exists(paths(d, s)["labels"]) else None for s in SPLITS}
    if splits["train"].dense.shape[1] != dm.dense:
        raise ValueError(f"{d}: {splits['train'].dense.shape[1]} dense features, the model "
                         f"has {dm.dense}")
    data = CriteoData(splits["train"], splits["val"], splits["test"], d)
    if logger is not None:
        logger.log("ingest", source="criteo", seconds=time.perf_counter() - t0,
                   **{f"{s}_samples": v.size for s, v in splits.items() if v is not None})
    return data
