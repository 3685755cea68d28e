"""Bounds of the port's kernels on an H100 (``core/roofline.py``), checked
against the arithmetic written out by hand."""

import pytest

from movie_recommendation_engine_tpu_torch.core import roofline


def test_hamming_bound_at_the_largest_bucket_is_the_tensor_core_route():
    b = roofline.hamming_bound(64, 4000, 16, 8, sm_clock_mhz=1980)
    us = {r: ms * 1e3 for r, ms in b["routes"].items()}
    # One POPC per word: 64 * 4000 * 16 * 8 = 32.8M at 16 * 132 * 1.98e9 /s.
    assert us["popc_per_word"] == pytest.approx(7.836, abs=5e-3)
    # Carry-save: half the popcounts (3.92 us); 20 int32 ops per table,
    # 81.9M at 64 * 132 * 1.98e9 /s, bind.
    assert us["carry_save"] == pytest.approx(4.897, abs=5e-3)
    # 0/1 int8 products: 2 * 64 * 4000 * 16 * 256 ops at 1,979 TOP/s.
    assert us["int8_tensor_core"] == pytest.approx(1.060, abs=5e-3)
    assert b["route"] == "int8_tensor_core" and b["by"] == "operations"
    assert b["ms"] == min(b["routes"].values())
    assert b["bytes_ms"] * 1e3 == pytest.approx(0.928, abs=5e-3)


def test_hamming_bound_at_one_query_is_bytes():
    # (1 + 4000) * 512 B of signatures + 4000 * 4 B of distances at 3.35 TB/s.
    b = roofline.hamming_bound(1, 4000, 16, 8, sm_clock_mhz=1980)
    assert b["by"] == "bytes"
    assert b["bytes"] == 2_064_512
    assert b["ms"] * 1e3 == pytest.approx(0.616, abs=5e-3)
    assert all(ms == b["ms"] for ms in b["routes"].values())


@pytest.mark.parametrize("words", [5, 8])
def test_hamming_bound_is_never_above_any_route(words):
    b = roofline.hamming_bound(16, 4000, 16, words)
    assert b["ms"] == min(b["routes"].values()) >= b["bytes_ms"]
    if words % 8:
        assert b["routes"]["carry_save"] == b["routes"]["popc_per_word"]


def test_hamming_bound_follows_the_clock():
    slow = roofline.hamming_bound(64, 4000, 16, 8, sm_clock_mhz=990)
    fast = roofline.hamming_bound(64, 4000, 16, 8, sm_clock_mhz=1980)
    assert slow["routes"]["popc_per_word"] == pytest.approx(2 * fast["routes"]["popc_per_word"])
    assert slow["bytes_ms"] == fast["bytes_ms"]


def test_gather_pool_bound_is_bytes_at_the_serving_shape():
    b = roofline.gather_pool_bound(4000, 256, 4000, 50, table_bytes=2)
    assert b["by"] == "bytes" and b["bytes"] == 7_744_000
    assert b["ms"] == pytest.approx(7_744_000 / 3.35e12 * 1e3)


def test_gather_pool_l2_bytes_at_the_serving_shape():
    import torch

    from movie_recommendation_engine_tpu_torch.ops import pool

    n = b = 3980
    pairs, out = b * 50 * 8, b * 256 * 4
    # direct: every one of the B * K gathered 512-byte row segments.
    direct = roofline.gather_pool_l2_bytes("direct", n, 256, b, 50, 2)
    assert direct == b * 50 * 512 + pairs + out == 107_555_520
    # resident: the table once per row group (8), ids and weights once per
    # slice (16).
    p = pool.plan(n, 256, b, 50, torch.bfloat16, route="resident")
    resident = roofline.gather_pool_l2_bytes("resident", n, 256, b, 50, 2, p)
    assert (p.groups, p.slices) == (8, 16)
    assert resident == 8 * n * 512 + 16 * pairs + out == 45_849_600
    # Both move at least what the bound counts.
    assert min(direct, resident) >= roofline.gather_pool_bound(n, 256, b, 50, 2)["bytes"]
    with pytest.raises(ValueError):
        roofline.gather_pool_l2_bytes("fast", n, 256, b, 50, 2)
