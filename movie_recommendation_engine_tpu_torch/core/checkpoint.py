"""Checkpoints in the JAX package's format, and embedding files.

A checkpoint is one ``.npz`` of flattened tree leaves (keys such as
``params/convs/0/self/w``, ``opt/step``, ``opt/mu/...``, ``opt/nu/...``,
``rng``) plus a ``.meta.json`` sidecar holding the sorted keys and metadata
(epoch, best metric, plateau state, config, tag). This module reads and
writes that format with numpy alone, and carries weights between the port's
parameter dict and JAX's leaf names (``params_from_jax``, ``params_to_jax``),
so that either package resumes from the other's checkpoint.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from . import tree


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _sidecar_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def save_flat(path: str, flat: dict[str, np.ndarray], meta: dict[str, Any] | None = None) -> None:
    """``flat`` (key path -> array) as ``<path>.npz`` and its sidecar."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(_npz_path(path), **flat)
    with open(_sidecar_path(path), "w") as f:
        json.dump({"keys": sorted(flat), "meta": meta or {}}, f, indent=2, default=str)


def save_pytree(path: str, params_tree: Any, meta: dict[str, Any] | None = None) -> None:
    """A tree of tensors or arrays, under the key paths ``core.tree.flatten``
    gives (JAX's own)."""
    save_flat(path, {k: _numpy(v) for k, v in tree.flatten(params_tree).items()}, meta)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


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
    whole_checkpoint = any(k.startswith("params/") for k in flat)
    leaves = {}
    for key, arr in flat.items():
        if key.startswith("params/"):
            key = key[len("params/"):]
        elif whole_checkpoint:
            continue                      # optimizer state, rng
        leaves[key] = torch.tensor(np.asarray(arr), dtype=torch.float32, device=device)
    params = tree.unflatten(leaves)
    if not isinstance(params, dict) or not {"input_proj", "convs", "output_proj"} <= set(params):
        raise ValueError("not a PinSage parameter tree: top-level keys "
                         f"{sorted(params) if isinstance(params, dict) else params}")
    return params


def params_to_jax(params: dict[str, Any]) -> dict[str, np.ndarray]:
    """Flattened f32 numpy leaves under JAX's key paths (``convs/0/self/w``),
    the inverse of ``params_from_jax``."""
    return {k: _numpy(v).astype(np.float32) for k, v in tree.flatten(params).items()}


def save_embeddings(path: str, embeddings: np.ndarray, movie_ids: np.ndarray) -> None:
    """Persist item embeddings + raw-id mapping (same file as the JAX
    package's ``save_embeddings``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(_npz_path(path), embeddings=np.asarray(embeddings),
             movie_ids=np.asarray(movie_ids))


def load_embeddings(path: str) -> tuple[np.ndarray, np.ndarray]:
    with np.load(_npz_path(path)) as d:
        return d["embeddings"], d["movie_ids"]
