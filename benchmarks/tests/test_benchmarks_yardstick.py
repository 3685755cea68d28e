"""The copied bounds and the FLOP counter against hand counts."""

import pytest

from benchmarks.yardstick import roofline as y
from movie_recommendation_engine_tpu_torch.core import roofline as program


def test_copied_bounds_equal_the_programs_at_small_shapes():
    for args in ((100, 64, 30, 8, 2), (59393, 256, 4596, 16, 2)):
        assert y.gather_pool_bound(*args) == program.gather_pool_bound(*args)
        assert y.gather_pool_bwd_bound(*args) == program.gather_pool_bwd_bound(*args)
    assert y.hamming_bound(64, 4000, 16, 8) == program.hamming_bound(64, 4000, 16, 8)


def test_gather_pool_bound_by_hand():
    # 10 rows of 4 bf16, 3 pooled rows of 2 slots: bytes 10*4*2 + 3*2*8 + 3*4*4.
    b = y.gather_pool_bound(10, 4, 3, 2, 2)
    assert b["bytes"] == 80 + 48 + 48 and b["flops"] == 2 * 3 * 2 * 4
    assert b["ms"] == pytest.approx(max(176 / y.HBM_BYTES_PER_S, 48 / y.FP32_OPS_PER_S) * 1e3)


def test_pinsage_forward_flops_by_hand():
    # rows 5, batch rows 3, F 2, H 4, E 3, K 2, two layers:
    # input 5*2*2*4 = 80; a conv over n rows n*(2*2*4 + 2*4*4 + 2*8*4) = n*112;
    # output 3*2*4*3 = 72.
    assert y.pinsage_forward_flops(5, 3, 2, 4, 3, 2, 2) == 80 + 5 * 112 + 3 * 112 + 72


def test_train_step_flops_by_hand():
    # B 2, R 3, H 1: 2*2 + 3 + 2 = 9 rows embedded; NCE 2*2*(1+3+1)*3 = 60.
    fwd = y.pinsage_forward_flops(5, 9, 2, 4, 3, 2, 2) + 60
    assert y.train_step_flops(5, 2, 4, 3, 2, 2, 3, 1) == 3 * fwd

