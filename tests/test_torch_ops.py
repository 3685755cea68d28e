"""PyTorch port, kernel modules: ``ops/pool.py`` and ``ops/hamming.py``.

The plain PyTorch versions (what the wrappers run on CPU tensors) are held
against the JAX package's Pallas kernels in interpret mode. Tests marked
``cuda`` hold the CUDA kernels against the plain versions on the card; they
skip on a machine without one. On the card (no JAX there) run them with
``python -m pytest tests/test_torch_ops.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch.ops import hamming as t_hamming
from movie_recommendation_engine_tpu_torch.ops import pool as t_pool


@pytest.fixture(scope="module")
def jax_ops():
    pytest.importorskip("jax")
    from movie_recommendation_engine_tpu.ops.pallas import hamming, pool

    return hamming, pool


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _bf16_round(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def _pool_inputs(seed, n, d, b, k, limit):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    # Ids span negatives, the valid range, the masked band [limit, n) and
    # the sentinel n; the first row also hits the ragged last rows.
    nbrs = rng.integers(-2, n + 1, (b, k)).astype(np.int32)
    nbrs[0, :3] = [n - 1, n - 2, limit - 1]
    w = rng.random((b, k)).astype(np.float32)
    return table, nbrs, w


def _pool_ref(table, nbrs, w, limit):
    valid = (nbrs >= 0) & (nbrs < limit)
    rows = table[np.clip(nbrs, 0, limit - 1)].astype(np.float64)
    return np.einsum("bk,bkd->bd", np.where(valid, w, 0.0), rows)


# (n, d, b, k, limit, dtype): f32 and bf16 tables, D = 128 and D with a
# tail (not a multiple of 8), a ragged N, valid_limit below N.
POOL_CASES = [
    (96, 128, 19, 11, 96, "float32"),
    (35, 128, 9, 5, 35, "bfloat16"),
    (37, 100, 7, 6, 30, "bfloat16"),
    (29, 37, 5, 4, 29, "float32"),
]


@pytest.mark.parametrize("n,d,b,k,limit,dtype", POOL_CASES)
def test_gather_pool_plain_matches_pallas(jax_ops, n, d, b, k, limit, dtype):
    import jax.numpy as jnp

    _, j_pool = jax_ops
    table, nbrs, w = _pool_inputs(0, n, d, b, k, limit)
    if dtype == "bfloat16":
        table = _bf16_round(table)  # both sides read the same bf16 values
    ref = _pool_ref(table, nbrs, w, limit)
    got = t_pool.gather_pool(torch.from_numpy(table).to(getattr(torch, dtype)),
                             torch.from_numpy(nbrs), torch.from_numpy(w), limit)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    jax_out = j_pool.gather_pool(jnp.asarray(table, dtype=getattr(jnp, dtype)),
                                 jnp.asarray(nbrs), jnp.asarray(w),
                                 valid_limit=limit, tile_b=4, interpret=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jax_out), ref, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), atol=1e-5)


def test_gather_pool_rejects_bad_limit():
    table = torch.zeros(4, 8)
    nbrs = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        t_pool.gather_pool(table, nbrs, torch.ones(2, 3), valid_limit=5)
    with pytest.raises(ValueError):
        t_pool.gather_pool(table, nbrs, torch.ones(2, 2), valid_limit=4)


def _random_sigs(rng, rows, tw):
    return rng.integers(0, 2**32, (rows, tw), dtype=np.uint32)


# (q, n, t, w): ragged Q and N against the JAX tile sizes, 1-word tables.
HAMMING_CASES = [(5, 37, 3, 2), (9, 9, 2, 1), (6, 64, 4, 2)]


@pytest.mark.parametrize("q,n,t,w", HAMMING_CASES)
def test_hamming_plain_matches_pallas_exactly(jax_ops, q, n, t, w):
    import jax.numpy as jnp

    j_ham, _ = jax_ops
    rng = np.random.default_rng(q * 100 + n)
    qsig, sigs = _random_sigs(rng, q, t * w), _random_sigs(rng, n, t * w)
    sigs[: min(q, n)] = qsig[: min(q, n)]      # zero distances on a diagonal
    ref = np.asarray(j_ham.hamming_distance(
        jnp.asarray(qsig), jnp.asarray(sigs), num_tables=t, words=w,
        tile_q=8, tile_n=16, interpret=True))
    got = t_hamming.hamming_distance(torch.from_numpy(qsig.view(np.int32)),
                                     torch.from_numpy(sigs.view(np.int32)), t, w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_hamming_topk_matches_pallas_with_ties(jax_ops):
    """Integer distances tie constantly; the indices must come out in
    ``lax.top_k``'s order (smaller index first among equal distances)."""
    import jax.numpy as jnp

    j_ham, _ = jax_ops
    rng = np.random.default_rng(7)
    t, w, k = 2, 1, 12
    qsig, sigs = _random_sigs(rng, 4, t * w), _random_sigs(rng, 50, t * w)
    sigs[10:20] = sigs[5]                       # ten exact duplicates
    d_ref, i_ref = j_ham.hamming_topk(jnp.asarray(qsig), jnp.asarray(sigs), k,
                                      num_tables=t, words=w, interpret=True)
    d, i = t_hamming.hamming_topk(torch.from_numpy(qsig.view(np.int32)),
                                  torch.from_numpy(sigs.view(np.int32)), k, t, w)
    assert len(set(np.asarray(d_ref).ravel().tolist())) < k * 4  # ties present
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

# Serving shape (N = B = 4000, K = 50, D = 256 bf16) plus edge shapes:
# f32, a D with a tail (scalar path), tiny D, K above one warp.
CUDA_POOL_CASES = POOL_CASES + [
    (4000, 256, 4000, 50, 4000, "bfloat16"),
    (4000, 256, 777, 50, 3000, "float32"),
    (50, 3, 10, 70, 50, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,b,k,limit,dtype", CUDA_POOL_CASES)
def test_gather_pool_kernel_matches_plain(cuda, n, d, b, k, limit, dtype):
    table, nbrs, w = _pool_inputs(1, n, d, b, k, limit)
    t = torch.from_numpy(table).to(cuda, getattr(torch, dtype))
    nb, ww = torch.from_numpy(nbrs).to(cuda), torch.from_numpy(w).to(cuda)
    before = t_pool.LAUNCHES
    got = t_pool.gather_pool(t, nb, ww, limit)
    torch.cuda.synchronize()
    assert t_pool.LAUNCHES == before + 1
    ref = t_pool.gather_pool_plain(t, nb, ww, limit)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


_BF16_ROWS_2CH = t_pool.max_resident_rows(256, 50, torch.bfloat16, chunks=2)
_BF16_ROWS_MAX = t_pool.max_resident_rows(256, 50, torch.bfloat16)

# Shapes the resident route takes: the serving shape in bf16 and f32, slices
# of 4, 2 and 1 chunks, K = 70, a D that is not a whole number of slices,
# valid_limit below N, and N at and just past the two-chunk slice's limit
# and at the route's own limit.
RESIDENT_CASES = [
    (3980, 256, 3980, 50, 3980, "bfloat16"),
    (3980, 256, 3980, 50, 3980, "float32"),
    (500, 64, 300, 70, 450, "bfloat16"),
    (3980, 200, 997, 50, 3980, "bfloat16"),
    (4000, 256, 777, 50, 3000, "float32"),
    (_BF16_ROWS_2CH, 256, 700, 50, _BF16_ROWS_2CH, "bfloat16"),
    (_BF16_ROWS_2CH + 1, 256, 700, 50, _BF16_ROWS_2CH + 1, "bfloat16"),
    (_BF16_ROWS_MAX, 256, 600, 50, _BF16_ROWS_MAX, "bfloat16"),
    (96, 128, 19, 11, 96, "float32"),
]


def _cuda_pool_inputs(cuda, seed, n, d, b, k, limit, dtype):
    table, nbrs, w = _pool_inputs(seed, n, d, b, k, limit)
    return (torch.from_numpy(table).to(cuda, getattr(torch, dtype)),
            torch.from_numpy(nbrs).to(cuda), torch.from_numpy(w).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,b,k,limit,dtype", RESIDENT_CASES)
def test_gather_pool_resident_matches_plain_and_direct(cuda, n, d, b, k, limit, dtype):
    """The resident route within 1e-4 of the plain version, and bitwise
    equal to the direct route (both sum over k in order with fmaf)."""
    t, nb, ww = _cuda_pool_inputs(cuda, 3, n, d, b, k, limit, dtype)
    assert t_pool.plan(limit, d, b, k, t.dtype, route="resident").route == "resident"
    before = t_pool.LAUNCHES
    res = t_pool.gather_pool(t, nb, ww, limit, route="resident")
    direct = t_pool.gather_pool(t, nb, ww, limit, route="direct")
    torch.cuda.synchronize()
    assert t_pool.LAUNCHES == before + 2
    torch.testing.assert_close(res, t_pool.gather_pool_plain(t, nb, ww, limit),
                               atol=1e-4, rtol=0)
    assert torch.equal(res, direct)


@pytest.mark.cuda
def test_gather_pool_resident_raises_where_plan_refuses(cuda):
    t, nb, ww = _cuda_pool_inputs(cuda, 4, _BF16_ROWS_MAX + 1, 256, 64, 50,
                                  _BF16_ROWS_MAX + 1, "bfloat16")
    with pytest.raises(ValueError, match="shared memory"):
        t_pool.gather_pool(t, nb, ww, _BF16_ROWS_MAX + 1, route="resident")
    t, nb, ww = _cuda_pool_inputs(cuda, 5, 37, 100, 7, 6, 30, "bfloat16")
    with pytest.raises(ValueError, match="16-byte"):
        t_pool.gather_pool(t, nb, ww, 30, route="resident")


@pytest.mark.cuda
def test_gather_pool_kernel_unaligned_table(cuda):
    """A table view that is not 16-byte aligned takes the scalar path."""
    table, nbrs, w = _pool_inputs(2, 65, 128, 33, 9, 64)
    base = torch.from_numpy(table).to(cuda, torch.bfloat16).reshape(-1)
    t = base[1:].reshape(-1)[: 64 * 128].reshape(64, 128)
    assert t.data_ptr() % 16 != 0
    nb = torch.from_numpy(nbrs).clamp(max=64).to(cuda)
    ww = torch.from_numpy(w).to(cuda)
    got = t_pool.gather_pool(t, nb, ww, 64)
    torch.testing.assert_close(got, t_pool.gather_pool_plain(t, nb, ww, 64),
                               atol=1e-4, rtol=0)


# Every server batch bucket at the serving shape; off-tile Q and N crossed
# with (T, W) on the vector path (W = 8, 1 and 2 rows per warp), the scalar
# path (W = 1, 5; T = 1 and 3 lanes of 4) and the other vector widths.
HAMMING_BUCKETS = [(q, 4000, 16, 8) for q in (1, 2, 4, 8, 16, 32, 64)]
HAMMING_OFF_TILE = [(q, n, t, w) for q in (3, 17, 65, 200) for n in (1, 37, 129, 4001)
                    for t, w in ((1, 1), (3, 5), (16, 8), (32, 8))]
CUDA_HAMMING_CASES = (HAMMING_CASES + HAMMING_BUCKETS + HAMMING_OFF_TILE
                      + [(33, 129, 3, 5), (20, 300, 8, 4), (5, 77, 4, 16), (2, 50, 40, 8),
                         # above 48 KB of shared memory: scalar and vector paths
                         (40, 77, 4, 100), (33, 50, 96, 16)])


def _cuda_sigs(cuda, seed, q, n, t, w):
    rng = np.random.default_rng(seed)
    qsig = torch.from_numpy(_random_sigs(rng, q, t * w).view(np.int32)).to(cuda)
    sigs = torch.from_numpy(_random_sigs(rng, n, t * w).view(np.int32)).to(cuda)
    sigs[: min(q, n)] = qsig[: min(q, n)]      # zero distances on a diagonal
    return qsig, sigs


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,t,w", CUDA_HAMMING_CASES)
def test_hamming_kernel_matches_plain(cuda, q, n, t, w):
    qsig, sigs = _cuda_sigs(cuda, q + n, q, n, t, w)
    before = t_hamming.LAUNCHES
    got = t_hamming.hamming_distance(qsig, sigs, t, w)
    torch.cuda.synchronize()
    assert t_hamming.LAUNCHES == before + 1
    ref = t_hamming.hamming_distance_plain(qsig, sigs, t, w)
    assert torch.equal(got, ref)
    d, i = t_hamming.hamming_topk(qsig, sigs, min(10, n), t, w)
    d_ref, i_ref = t_hamming.smallest_k(ref, min(10, n))
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)


@pytest.mark.cuda
def test_hamming_kernel_unaligned_signatures(cuda):
    """Views that are not 16-byte aligned take the scalar path."""
    qsig, sigs = _cuda_sigs(cuda, 4, 9, 301, 16, 8)
    flat = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda), sigs.reshape(-1)])
    view = flat[1:].view(301, 128)
    assert view.data_ptr() % 16 != 0
    got = t_hamming.hamming_distance(qsig, view, 16, 8)
    assert torch.equal(got, t_hamming.hamming_distance_plain(qsig, sigs, 16, 8))


@pytest.mark.cuda
def test_hamming_kernel_raises_beyond_its_limits(cuda):
    qsig = torch.zeros((16, 20000), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        t_hamming.hamming_distance(qsig, qsig, 1, 20000)
    with pytest.raises(ValueError, match="contiguous"):
        t_hamming.hamming_distance(qsig[:, ::2], qsig[:, ::2], 1, 10000)


# ---------------------------------------------------------------------------
# The kernels' tiling (pure arithmetic, checked on the CPU)
# ---------------------------------------------------------------------------

def test_pool_plan_at_the_serving_shape():
    """3980 movies x 256 bf16, K = 50. ``plan`` picks ``direct``, the route
    that was faster there on the card; forced, ``resident`` holds a
    16-column (32-byte) slice of every row in shared memory, 16 slices x 8
    row groups = 128 blocks of 16 warps."""
    p = t_pool.plan(3980, 256, 3980, 50, torch.bfloat16)
    assert p == t_pool.Plan("direct", dc=256, chunks=0, slices=1, groups=498,
                            rows_per_group=8, warps=8, smem=8 * 50 * 8, vectorized=True)
    p = t_pool.plan(3980, 256, 3980, 50, torch.bfloat16, route="resident")
    assert p == t_pool.Plan("resident", dc=16, chunks=2, slices=16, groups=8,
                            rows_per_group=512, warps=16,
                            smem=3980 * 32 + 16 * 16 * 50 * 8, vectorized=True)


@pytest.mark.parametrize("n,d,b,k,dtype,aligned", [
    (59392, 256, 59392, 50, torch.bfloat16, True),   # the at-scale corpus
    (3980, 100, 3980, 50, torch.bfloat16, True),     # 200-byte rows: scalar path
    (3980, 256, 3980, 50, torch.bfloat16, False),    # unaligned table
    (3980, 256, 3980, 50, torch.float32, True),      # f32 at the serving shape
    (_BF16_ROWS_MAX, 256, 4000, 50, torch.bfloat16, True),  # resident's largest table
])
def test_pool_plan_picks_direct(n, d, b, k, dtype, aligned):
    p = t_pool.plan(n, d, b, k, dtype, aligned=aligned)
    assert p.route == "direct" and p.groups == -(-b // 8) and p.smem == 8 * k * 8
    assert p.vectorized == (aligned and d * dtype.itemsize % 16 == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,b,k", [
    (3980, 256, 3980, 50), (4000, 256, 4000, 50), (500, 64, 300, 70), (3980, 200, 997, 50),
    (_BF16_ROWS_2CH, 256, 700, 50), (_BF16_ROWS_MAX, 256, 600, 50), (9, 8, 3, 1),
    (2000, 1024, 64, 200)])
def test_pool_plan_resident_tiling_fits(n, d, b, k, dtype):
    """Shared memory within 227 KB, 4..16 warps, the slices cover D, the row
    groups cover B without an empty group, whole passes of 32 / CH rows."""
    try:
        p = t_pool.plan(n, d, b, k, dtype, route="resident")
    except ValueError as e:
        assert "shared memory" in str(e) and n * d * dtype.itemsize > 227 * 1024
        return
    row = p.chunks * 16
    assert p.smem == n * row + p.warps * (32 // p.chunks) * (((k + 1) | 3) - 1) * 8 <= 227 * 1024
    assert 4 <= p.warps <= 16 and p.chunks in (1, 2, 4)
    assert p.dc * dtype.itemsize == row and p.slices == -(-d * dtype.itemsize // row)
    assert p.rows_per_group % (32 // p.chunks) == 0
    assert p.groups * p.rows_per_group >= b > (p.groups - 1) * p.rows_per_group
    assert p.groups * p.slices <= 132 or p.groups == 1


def test_pool_plan_resident_limits():
    bf16 = torch.bfloat16
    assert t_pool.plan(_BF16_ROWS_2CH, 256, 700, 50, bf16, route="resident").chunks == 2
    assert t_pool.plan(_BF16_ROWS_2CH + 1, 256, 700, 50, bf16, route="resident").chunks == 1
    assert t_pool.plan(_BF16_ROWS_MAX, 256, 700, 50, bf16, route="resident").warps == 4
    assert t_pool.max_resident_rows(256, 50, bf16) == (227 * 1024 - 4 * 32 * 50 * 8) // 16
    assert t_pool.max_resident_rows(100, 50, bf16) == 0
    assert t_pool.max_resident_rows(8, 50, bf16, chunks=2) == 0


def test_pool_plan_raises_beyond_the_kernel_limits():
    bf16 = torch.bfloat16
    with pytest.raises(ValueError, match="shared memory"):
        t_pool.plan(_BF16_ROWS_MAX + 1, 256, 700, 50, bf16, route="resident")
    with pytest.raises(ValueError, match="16-byte"):
        t_pool.plan(3980, 100, 3980, 50, bf16, route="resident")
    t_pool.plan(10, 8, 10, t_pool.MAX_K, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        t_pool.plan(10, 8, 10, t_pool.MAX_K + 1, torch.float32)
    with pytest.raises(ValueError, match="route"):
        t_pool.plan(10, 8, 10, 4, bf16, route="fast")
    with pytest.raises(ValueError, match="2\\*\\*31"):
        t_pool.plan(10, 8, 2**26, 64, bf16)
    with pytest.raises(TypeError):
        t_pool.plan(10, 8, 10, 4, torch.float16)


def test_gather_pool_route_keyword_on_the_cpu():
    """On CPU tensors every route is the plain version; an unknown route
    raises there too."""
    table, nbrs, w = (torch.from_numpy(x) for x in _pool_inputs(6, 40, 16, 9, 5, 33))
    ref = t_pool.gather_pool_plain(table, nbrs, w, 33)
    for route in (None, "direct", "resident"):
        assert torch.equal(t_pool.gather_pool(table, nbrs, w, 33, route=route), ref)
    with pytest.raises(ValueError, match="route"):
        t_pool.gather_pool(table, nbrs, w, 33, route="fast")


@pytest.mark.parametrize("q", [1, 2, 4, 8, 16, 32, 64])
def test_hamming_plan_covers_every_bucket(q):
    p = t_hamming.plan(q, 4000, 16, 8)
    assert p.grid[0] * 32 >= 4000 and p.grid[1] * p.qt >= q
    assert p.grid[1] * p.qt < q + p.qt          # no whole tile of padding
    assert p.wc == 8 and p.smem <= 48 * 1024


def test_hamming_plan_work_scales_with_q():
    """Padded query slots (grid rows x tile) grow with Q: Q = 1 computes one
    query, Q = 64 sixty-four."""
    slots = {}
    for q in (1, 4, 16, 64):
        p = t_hamming.plan(q, 4000, 16, 8)
        slots[q] = p.grid[1] * p.qt
    assert slots == {1: 1, 4: 4, 16: 16, 64: 64}


@pytest.mark.parametrize("t,w,aligned,wc", [
    (1, 1, True, 0), (3, 5, True, 0), (16, 8, False, 0), (32, 8, True, 8),
    (64, 4, True, 4), (2, 16, True, 16), (1, 256, True, 0)])
def test_hamming_plan_paths(t, w, aligned, wc):
    p = t_hamming.plan(17, 4001, t, w, aligned=aligned)
    assert p.wc == wc and p.grid == (126, 1) and p.qt == 32
    assert p.smem == 4 * 32 * (t * w + 32)


def test_hamming_plan_raises_beyond_the_kernel_limits():
    t_hamming.plan(64, 4000, 32, 8)                       # T*W = 256 words is taken
    with pytest.raises(ValueError, match="shared memory"):
        t_hamming.plan(64, 4000, 1, 20000)
    with pytest.raises(ValueError, match="grid"):
        t_hamming.plan(32 * 65536, 10, 16, 8)
    with pytest.raises(ValueError, match="T >= 1"):
        t_hamming.plan(4, 10, 0, 8)
