"""Top-k in ``jax.lax.top_k``'s order.

``torch.topk`` leaves the order of equal values undefined; JAX puts the
lower index first, and orders floats totally (-0.0 below +0.0, a NaN above
+inf or below -inf by its sign). Every float ranking of the port that stands
in for a ``lax.top_k`` goes through ``top_k``, so two rows with equal scores
(duplicate embeddings, equal distances) come back in JAX's order.

``top_k`` ranks one unique int64 key per entry with ``torch.topk``: the
value mapped to an int32 that orders as the float's total order, times N,
plus the index (or N - 1 - index when ``largest``, so the lower index still
wins). That costs a selection, not the full sort of every row.
"""

from __future__ import annotations

import torch


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor that orders as ``x`` in JAX's total order (int32
    for floats of up to 32 bits, int64 for float64)."""
    if not x.is_floating_point():
        return x
    if x.dtype == torch.float64:
        bits, mag = x.view(torch.int64), 0x7FFFFFFFFFFFFFFF
    else:
        bits, mag = x.float().view(torch.int32), 0x7FFFFFFF
    # A negative float's value bits grow as it falls: flip them.
    return bits ^ ((bits >> (bits.element_size() * 8 - 1)) & mag)


def top_k(x: torch.Tensor, k: int, largest: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(values [.., k], indices [.., k] int64) of the k largest (``largest``)
    or smallest values along the last dim, the lower index first among equal
    values. Float64 is ranked by a stable sort of its ordered bits (they do
    not fit the key); integers must satisfy |x| * N < 2**62."""
    if x.dtype == torch.float64:
        idx = torch.sort(_ordered(x), dim=-1, descending=largest, stable=True).indices
        idx = idx[..., :k]
        return x.gather(-1, idx), idx
    n = x.shape[-1]
    pos = torch.arange(n, device=x.device)
    low = n - 1 - pos if largest else pos
    key = torch.add(low, _ordered(x), alpha=n)
    top = torch.topk(key, k, dim=-1, largest=largest, sorted=True).values
    idx = top.remainder(n)
    if largest:
        idx = n - 1 - idx
    return x.gather(-1, idx), idx
