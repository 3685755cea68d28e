"""Reference PyTorch checkpoints (``.pt``) into the port's parameter tree.

Port of ``movie_recommendation_engine_tpu/utils/torch_import.py``: a
checkpoint saved by the reference's training loop (train.py:102-112, a dict
with ``model_state_dict``) maps straight onto the port's PinSage params.
``nn.Linear`` stores ``weight`` as [out, in]; the port keeps ``w`` [in, out],
so weights are transposed. ``lin_self`` / ``lin_neigh`` / ``lin_update``
become a conv's ``self`` / ``neigh`` / ``update``.
"""

from __future__ import annotations

from typing import Any

import torch


def params_from_torch_state_dict(sd: dict[str, Any], device="cpu") -> dict:
    """A reference ``model_state_dict`` (tensor or ndarray values) -> params
    (f32 tensors on ``device``)."""
    def tensor(key):
        return torch.as_tensor(sd[key], dtype=torch.float32, device=device)

    def lin(prefix):
        return {"w": tensor(f"{prefix}.weight").t().contiguous(), "b": tensor(f"{prefix}.bias")}

    conv_ids = sorted({int(k.split(".")[1]) for k in sd if k.startswith("convs.")})
    return {
        "input_proj": lin("input_proj"),
        "convs": [{"self": lin(f"convs.{i}.lin_self"),
                   "neigh": lin(f"convs.{i}.lin_neigh"),
                   "update": lin(f"convs.{i}.lin_update")} for i in conv_ids],
        "output_proj": lin("output_proj"),
    }


def load_torch_checkpoint(path: str, device="cpu") -> tuple[dict, dict]:
    """A reference ``.pt`` checkpoint -> (params, metadata: its other keys
    but the optimizer state). Loaded with ``weights_only=True``: tensors
    and plain containers, no arbitrary pickled objects."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" not in ck:            # a bare state dict
        return params_from_torch_state_dict(ck, device), {}
    sd = ck["model_state_dict"]
    meta = {k: v for k, v in ck.items()
            if k not in ("model_state_dict", "optimizer_state_dict")}
    return params_from_torch_state_dict(sd, device), meta
