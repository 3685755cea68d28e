"""Model FLOPs and byte bounds of DLRM-DCNv2's training, from the model's
shapes and what the window's epochs counted (the benchmark's yardstick: a
later change to the program cannot move it).

``train_flops`` counts the dense part's matmuls alone (the bottom MLP, the
cross layers' two low-rank products, the top MLP), a multiply-add as 2, and
the backward as twice the forward; the bags, the element-wise work and the
optimizers are left out. ``bag_bytes`` is the least traffic of the
gather-pool forward and of the compact segment backward of a set of bags,
from ``roofline.gather_pool_bound`` and ``gather_pool_bwd_bound``'s byte
counts: each counts the table rows its calls must read (or write) at the
distinct rows the calls reached, never at the rows they might reach, so a
share of this bound is never overstated.
"""

from __future__ import annotations

from .roofline import BF16_TENSOR_FLOPS_PER_S, HBM_BYTES_PER_S

__all__ = ["BF16_TENSOR_FLOPS_PER_S", "HBM_BYTES_PER_S", "forward_flops", "train_flops",
           "bag_fwd_bytes", "bag_bwd_bytes"]


def forward_flops(dense: int, bottom: list, width: int, rank: int, cross_layers: int,
                  top: list) -> int:
    """The dense part's matmul FLOPs of one sample's forward: the bottom MLP
    from ``dense`` inputs, ``cross_layers`` low-rank layers ([width, rank]
    then [rank, width]) and the top MLP from ``width`` inputs."""
    def chain(n_in, widths):
        dims = [n_in, *widths]
        return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))

    return chain(dense, bottom) + cross_layers * 2 * 2 * width * rank + chain(width, top)


def train_flops(samples: int, *shape) -> int:
    """Forward and backward (3x the forward) of ``samples`` samples at the
    shape ``forward_flops`` takes."""
    return 3 * samples * forward_flops(*shape)


def bag_fwd_bytes(calls: int, batch: int, bags: list, d: int, rows_read: int) -> int:
    """The gather-pool forward's bytes over ``calls`` sets of one bag a
    feature of ``batch`` samples, K_f ids each, f32 tables of width ``d``:
    per call the ids and weights (8 bytes a slot) and the f32 output, and
    over them all the ``rows_read`` distinct rows their calls reached."""
    return calls * (batch * sum(bags) * 8 + len(bags) * batch * d * 4) + rows_read * d * 4


def bag_bwd_bytes(calls: int, batch: int, bags: list, d: int, rows_written: int) -> int:
    """The compact segment backward's bytes over the same calls: per call
    the f32 cotangent and the ids and weights, and over them all the
    ``rows_written`` distinct rows whose gradient they wrote."""
    return calls * (len(bags) * batch * d * 4 + batch * sum(bags) * 8) + rows_written * d * 4


def bound_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
