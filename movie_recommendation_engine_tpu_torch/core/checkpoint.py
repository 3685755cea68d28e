"""Reading the JAX package's checkpoints, and embedding files.

A JAX checkpoint is one ``.npz`` of flattened pytree leaves (keys such as
``params/convs/0/self/w``, ``opt/m/...``, ``rng``) plus a ``.meta.json``
sidecar holding the sorted keys and metadata (epoch, best metric, plateau
state, config). This module reads that format with numpy alone and carries
the weights into the port's parameter dict (``params_from_jax``).
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _sidecar_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def load_flat(path: str) -> dict[str, np.ndarray]:
    """All leaves of a checkpoint, by their ``/``-joined key path."""
    with np.load(_npz_path(path)) as data:
        return {k: data[k] for k in data.files}


def load_meta(path: str) -> dict[str, Any]:
    with open(_sidecar_path(path)) as f:
        return json.load(f)["meta"]


def params_from_jax(flat: dict[str, np.ndarray], device) -> dict[str, Any]:
    """The port's params from flattened JAX params.

    ``flat`` maps key paths to arrays, either a whole checkpoint (keys under
    ``params/``; ``opt/`` and ``rng`` are skipped) or a flattened
    ``pinsage.init_params`` tree (keys like ``convs/0/self/w``). Every leaf
    is carried over as f32, ``neigh`` too (only the edge forward reads it)."""
    tree: dict[str, Any] = {}
    whole_checkpoint = any(k.startswith("params/") for k in flat)
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        elif whole_checkpoint:
            continue                      # optimizer state, rng
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.tensor(np.asarray(arr), dtype=torch.float32,
                                       device=device)
    if not {"input_proj", "convs", "output_proj"} <= set(tree):
        raise ValueError(f"not a PinSage parameter tree: top-level keys {sorted(tree)}")
    convs = tree["convs"]
    tree["convs"] = [convs[str(i)] for i in range(len(convs))]
    return tree


def save_embeddings(path: str, embeddings: np.ndarray, movie_ids: np.ndarray) -> None:
    """Persist item embeddings + raw-id mapping (same file as the JAX
    package's ``save_embeddings``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(_npz_path(path), embeddings=np.asarray(embeddings),
             movie_ids=np.asarray(movie_ids))


def load_embeddings(path: str) -> tuple[np.ndarray, np.ndarray]:
    with np.load(_npz_path(path)) as d:
        return d["embeddings"], d["movie_ids"]
