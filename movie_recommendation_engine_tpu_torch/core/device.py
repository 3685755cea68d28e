"""Device resolution for the port's entry points.

Every entry point (``api.Engine``, ``train.trainer.Trainer``, the indexes, the
CLI) runs on ``cuda`` unless the caller passes ``device="cpu"``. A request for
CUDA on a machine without it raises: nothing silently carries on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
