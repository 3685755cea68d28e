"""Model FLOPs of HSTU's training, from what an epoch really holds: the
real positions (not padding), each history's causal triangle of
attention pairs, and the supervised positions. Padding is not counted, so a
jagged or packed step that skips it reads a higher share of the peak."""

from __future__ import annotations

from .roofline import BF16_TENSOR_FLOPS_PER_S

__all__ = ["BF16_TENSOR_FLOPS_PER_S", "train_flops"]


def train_flops(d: int, blocks: int, heads: int, dqk: int, dv: int, negatives: int,
                real_slots: int, attn_pairs: int, positions: int) -> int:
    """Forward and backward (3x the forward) of: per block, ``f1`` [d, 2H(dv
    + dqk)] and ``f2`` [H dv, d] at every real position and, per head,
    ``Q K^T`` and ``A V`` over every attention pair (a position and one at
    or before it, in the same history); then the (1 + ``negatives``)-logit
    dot products of every supervised position."""
    f1 = 2 * real_slots * d * 2 * heads * (dv + dqk)
    f2 = 2 * real_slots * heads * dv * d
    attention = 2 * attn_pairs * heads * (dqk + dv)
    loss = 2 * positions * (1 + negatives) * d
    return 3 * (blocks * (f1 + f2 + attention) + loss)
