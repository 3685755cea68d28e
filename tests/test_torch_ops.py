"""PyTorch port, kernel modules: ``ops/pool.py`` and ``ops/hamming.py``.

The plain PyTorch versions (what the wrappers run on CPU tensors) are held
against the JAX package's Pallas kernels in interpret mode, and the
gather-pool gradients (plain, and through ``GatherPoolFunction``) against
``gather_pool_ad``'s: f32 1e-5 (sums in another order), a bf16 ``d_table``
within one bf16 step (2^-7 relative; both round one f32 sum). Tests marked
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


def _pool_grad_inputs(n, d, b, k, limit, dtype):
    table, nbrs, w = _pool_inputs(4, n, d, b, k, limit)
    if dtype == "bfloat16":
        table = _bf16_round(table)
    g = np.random.default_rng(5).standard_normal((b, d)).astype(np.float32)
    return table, nbrs, w, g


def _assert_d_table(got, ref, dtype):
    if dtype == "bfloat16":
        torch.testing.assert_close(got.float(), ref.float(), rtol=2**-7, atol=1e-6)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d,b,k,limit,dtype", POOL_CASES)
def test_gather_pool_grads_match_gather_pool_ad(jax_ops, n, d, b, k, limit, dtype):
    """d_table and d_w, from ``gather_pool_bwd_plain`` and from autograd
    through ``gather_pool``, against ``jax.grad`` of ``gather_pool_ad`` (its
    Pallas forward in interpret mode, its XLA backward)."""
    import jax
    import jax.numpy as jnp

    _, j_pool = jax_ops
    table, nbrs, w, g = _pool_grad_inputs(n, d, b, k, limit, dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def f(t, ww):
        return jnp.sum(j_pool.gather_pool_ad(t, jnp.asarray(nbrs), ww, limit, 4, True) * g)

    ref_t, ref_w = jax.grad(f, argnums=(0, 1))(jnp.asarray(table, jd), jnp.asarray(w))
    ref_t = torch.from_numpy(np.array(ref_t, np.float32)).to(td)
    ref_w = torch.from_numpy(np.array(ref_w))
    tt, nb, ww, gg = (torch.from_numpy(table).to(td), torch.from_numpy(nbrs),
                      torch.from_numpy(w), torch.from_numpy(g))
    d_t, d_w = t_pool.gather_pool_bwd_plain(tt, nb, ww, limit, gg)
    assert d_t.dtype == td and d_w.dtype == torch.float32
    _assert_d_table(d_t, ref_t, dtype)
    torch.testing.assert_close(d_w, ref_w, rtol=1e-5, atol=1e-5)
    tt.requires_grad_()
    ww.requires_grad_()
    out = t_pool.gather_pool(tt, nb, ww, limit)
    assert out.grad_fn is not None
    (out * gg).sum().backward()
    _assert_d_table(tt.grad, ref_t, dtype)
    torch.testing.assert_close(ww.grad, ref_w, rtol=1e-5, atol=1e-5)


def _grads_through(pool_fn, table, nbrs, w, limit, g, wrt):
    t = table.detach().clone().requires_grad_("table" in wrt)
    ww = w.detach().clone().requires_grad_("weights" in wrt)
    out = pool_fn(t, nbrs, ww, limit)
    assert out.requires_grad and out.grad_fn is not None
    (out * g).sum().backward()
    return t.grad, ww.grad


@pytest.mark.parametrize("wrt", [("table",), ("weights",), ("table", "weights")])
def test_gather_pool_autograd_equals_autograd_through_plain(wrt):
    """Where an input requires grad, ``gather_pool`` returns a tensor with a
    gradient, the same one autograd takes through ``gather_pool_plain``; the
    gradient not asked for stays None."""
    table, nbrs, w, g = (torch.from_numpy(x) for x in _pool_grad_inputs(40, 24, 9, 6, 33,
                                                                         "float32"))
    got = _grads_through(t_pool.gather_pool, table, nbrs, w, 33, g, wrt)
    ref = _grads_through(t_pool.gather_pool_plain, table, nbrs, w, 33, g, wrt)
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert t_pool.gather_pool(table.requires_grad_(), nbrs, w, 33).grad_fn is None


def test_gather_pool_bwd_rejects_bad_cotangent():
    table, nbrs, w = torch.zeros(6, 8), torch.zeros(3, 2, dtype=torch.int32), torch.ones(3, 2)
    with pytest.raises(ValueError, match="g must be"):
        t_pool.gather_pool_bwd(table, nbrs, w, 6, torch.zeros(3, 7))
    d_t, d_w = t_pool.gather_pool_bwd(table, nbrs, w, 6, torch.ones(3, 8), need_weights=False)
    assert d_w is None and d_t[0].sum().item() == 6 * 8


# (n, d, b, k): no columns, no output rows.
EMPTY_BWD_CASES = [(6, 0, 3, 4), (6, 8, 0, 4)]


def _empty_bwd(device, n, d, b, k):
    table = torch.ones((n, d), device=device)
    nbrs = torch.zeros((b, k), dtype=torch.int32, device=device)
    w, g = torch.ones((b, k), device=device), torch.ones((b, d), device=device)
    d_t, d_w = t_pool.gather_pool_bwd(table, nbrs, w, n, g)
    assert torch.equal(d_t, torch.zeros((n, d), device=device))
    assert torch.equal(d_w, torch.zeros((b, k), device=device))


@pytest.mark.parametrize("n,d,b,k", EMPTY_BWD_CASES)
def test_gather_pool_bwd_empty_shapes(n, d, b, k):
    """An empty sum is 0: both gradients come back zero, not unset."""
    _empty_bwd("cpu", n, d, b, k)


def test_gather_pool_bwd_limits():
    """The backward kernel's own limits, apart from the forward's routes."""
    t_pool._bwd_limits(10, 8, 10, t_pool.MAX_K)
    with pytest.raises(ValueError, match="shared memory"):
        t_pool._bwd_limits(10, 8, 10, t_pool.MAX_K + 1)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        t_pool._bwd_limits(10, 8, 2**26, 64)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        t_pool._bwd_limits(10, 2**31, 10, 4)
    t_pool._bwd_limits(10, 8, 10, 4, t_pool.MAX_CHUNK)
    with pytest.raises(ValueError, match="chunk=.*shared memory"):
        t_pool._bwd_limits(10, 8, 10, 4, t_pool.MAX_CHUNK + 1)
    nbrs = torch.zeros(3, 2, dtype=torch.int32)
    for chunk in (0, t_pool.MAX_CHUNK + 1):
        with pytest.raises(ValueError, match="chunk"):
            t_pool.segment_layout(nbrs, 4, chunk)


# ---------------------------------------------------------------------------
# The segment route: the walk table's transpose and the sum in its order
# ---------------------------------------------------------------------------

def _skewed_walk(seed, n, b, k, limit):
    """Walk-shaped ids: Zipf-distributed over a permutation of the rows, so a
    few hub ids take most slots and many take none; the last quarter of each
    row is the masked sentinel n, as a walk table's short rows are."""
    rng = np.random.default_rng(seed)
    nbrs = rng.permutation(limit)[np.minimum(rng.zipf(1.5, (b, k)) - 1, limit - 1)]
    nbrs[:, k - k // 4:] = n
    table = rng.standard_normal((n, 24)).astype(np.float32)
    return table, nbrs.astype(np.int32), rng.random((b, k)).astype(np.float32)


def _hub_padded(seed, n, b, k, real_max):
    """Hub-residual-shaped ids: each row's first 1..``real_max`` slots real
    (skewed ids, weights in (0, 1]), the rest padding with id 0 and weight
    0, as both hub builders write it; some real slots hit id 0 too."""
    rng = np.random.default_rng(seed)
    nbrs = rng.permutation(n)[np.minimum(rng.zipf(1.5, (b, k)) - 1, n - 1)]
    w = (1.0 - rng.random((b, k))).astype(np.float32)
    pad = np.arange(k)[None, :] >= rng.integers(1, real_max + 1, b)[:, None]
    nbrs[pad], w[pad] = 0, 0.0
    table = rng.standard_normal((n, 24)).astype(np.float32)
    return table, nbrs.astype(np.int32), w


def _with_zero_weights(seed, inputs, share=0.25):
    """``inputs`` with about ``share`` of the weights set to exactly 0,
    on ids in range and out of it."""
    table, nbrs, w = inputs
    w = np.where(np.random.default_rng(seed).random(w.shape) < share, 0.0, w)
    return table, nbrs, w.astype(np.float32)


# (inputs, valid_limit, chunk, masked): every POOL_CASES shape with chunks
# of 2 (so ids split), a skewed walk-shaped table at the default chunk (a
# hub id spans more than three chunks), valid_limit below N, and no output
# rows; then layouts built with the weights (``masked``), which leave out
# the slots of weight 0: a hub residual's padding on row 0, and zero weights
# scattered over a walk table and a POOL_CASES shape.
SEGMENT_CASES = {
    **{f"pool_{n}x{d}_b{b}_k{k}_limit{lim}_{dt}": (_pool_inputs(4, n, d, b, k, lim), lim, 2,
                                                   False)
       for n, d, b, k, lim, dt in POOL_CASES},
    "skewed_walk": (_skewed_walk(8, 60, 64, 12, 60), 60, t_pool.SEGMENT_CHUNK, False),
    "skewed_walk_limit_below_n": (_skewed_walk(9, 60, 64, 12, 45), 45, 5, False),
    "no_rows": ((np.zeros((6, 8), np.float32), np.zeros((0, 4), np.int32),
                 np.zeros((0, 4), np.float32)), 6, 3, False),
    "masked_hub_padding": (_hub_padded(11, 60, 64, 8, 3), 60, 4, True),
    "masked_skewed_walk_limit_below_n": (
        _with_zero_weights(12, _skewed_walk(13, 60, 64, 12, 45)), 45, 5, True),
    "masked_pool_37x100_b7_k6_limit30": (
        _with_zero_weights(14, _pool_inputs(15, 37, 100, 7, 6, 30)), 30, 2, True),
}
MASKED_CASES = [c for c, v in SEGMENT_CASES.items() if v[3]]


def _case_layout(case):
    """The case's inputs as tensors and its layout (with the weights where
    the case is masked)."""
    (table, nbrs, w), limit, chunk, masked = SEGMENT_CASES[case]
    nb, ww = torch.from_numpy(nbrs), torch.from_numpy(w)
    lay = t_pool.segment_layout(nb, limit, chunk, weights=ww if masked else None)
    return table, nbrs, w, lay


def _segment_layout_ref(nbrs, limit, chunk, w=None):
    """``segment_layout`` by loops over ids in numpy (with ``w``, the slots
    of weight 0 masked)."""
    flat = nbrs.reshape(-1)
    if w is not None:
        flat = np.where(w.reshape(-1) != 0, flat, limit)
    row_ptr, slots, chunks, splits, parts = [0], [], [], [], 0
    for r in range(limit):
        mine = np.flatnonzero(flat == r)           # ascending; ids outside [0, limit) never match
        start = len(slots)
        slots.extend(mine.tolist())
        row_ptr.append(len(slots))
        pieces = [(start + i, start + min(i + chunk, len(mine)))
                  for i in range(0, len(mine), chunk)] or [(start, start)]
        if len(pieces) == 1:
            chunks.append((r, *pieces[0], -1))
            continue
        splits.append((r, parts, parts + len(pieces)))
        for a, b in pieces:
            chunks.append((r, a, b, parts))
            parts += 1
    return (np.array(row_ptr), np.array(slots, np.int64), np.array(chunks).reshape(-1, 4),
            np.array(splits, np.int64).reshape(-1, 3), parts)


def _plan(lay):
    """A layout's slots, chunks and splits cut to its totals (numpy)."""
    c, s, _ = lay.totals.tolist()
    v = int(lay.row_ptr[-1])
    return lay.slots[:v].numpy(), lay.chunks[:c].numpy(), lay.splits[:s].numpy()


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_layout_matches_numpy(case):
    """Row pointers, slots, chunks, splits and totals as the loops over ids
    make them; the arrays are sized by bounds known from the shape, the
    masked slots sort last in ``slots``, and the rows past the totals are 0
    (``segment_plan_plain``)."""
    _, limit, chunk, masked = SEGMENT_CASES[case]
    _, nbrs, w, got = _case_layout(case)
    row_ptr, slots, chunks, splits, parts = _segment_layout_ref(nbrs, limit, chunk,
                                                                w if masked else None)
    bk = nbrs.size
    assert got.shape == nbrs.shape and (got.limit, got.chunk) == (limit, chunk)
    assert got.totals.tolist() == [len(chunks), len(splits), parts]
    assert got.chunks.shape == (limit + bk // chunk, 4)
    assert got.splits.shape == (min(limit, bk // (chunk + 1)), 3)
    for t in got[3:]:
        assert t.dtype == torch.int32
    np.testing.assert_array_equal(got.row_ptr.numpy(), row_ptr)
    for t, ref in zip(_plan(got), (slots, chunks, splits)):
        np.testing.assert_array_equal(t, ref)
    np.testing.assert_array_equal(np.sort(got.slots.numpy()), np.arange(bk))
    assert not got.chunks[len(chunks):].any() and not got.splits[len(splits):].any()
    if case == "skewed_walk":       # what the case is for: a hub and empty ids
        spans = np.bincount(chunks[:, 0], minlength=limit)
        assert spans.max() > 3 and (chunks[:, 1] == chunks[:, 2]).any()


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_layout_covers_every_valid_slot_once(case):
    """The chunks tile the valid slots in order, each at most ``chunk``
    long; every id in [0, limit) has a chunk; every valid slot (in a masked
    layout: of a nonzero weight) appears once, under its own id, and
    ``row_ptr[limit]`` counts them; every partial is written by one chunk
    and read by its row."""
    _, limit, chunk, masked = SEGMENT_CASES[case]
    _, nbrs, w, lay = _case_layout(case)
    slots, ch, sp = _plan(lay)
    flat = nbrs.reshape(-1)
    valid = (flat >= 0) & (flat < limit)
    if masked:
        assert (valid & (w.reshape(-1) == 0)).any()     # what the case is for
        valid &= w.reshape(-1) != 0
    valid = np.flatnonzero(valid)
    assert int(lay.row_ptr[limit]) == valid.size
    np.testing.assert_array_equal(np.sort(slots), valid)
    assert ch[0, 1] == 0 and ch[-1, 2] == slots.size
    np.testing.assert_array_equal(ch[1:, 1], ch[:-1, 2])
    assert ((ch[:, 2] - ch[:, 1] >= 0) & (ch[:, 2] - ch[:, 1] <= chunk)).all()
    np.testing.assert_array_equal(np.unique(ch[:, 0]), np.arange(limit))
    for row, a, b, _ in ch:
        assert (flat[slots[a:b]] == row).all()
    parts = ch[ch[:, 3] >= 0, 3]
    np.testing.assert_array_equal(parts, np.arange(int(lay.totals[2])))
    for row, p0, p1 in sp:
        np.testing.assert_array_equal(ch[ch[:, 0] == row, 3], np.arange(p0, p1))


@pytest.mark.parametrize("case", SEGMENT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_plain_matches_bwd_plain_and_gather_pool_ad(jax_ops, case, dtype):
    """``gather_pool_bwd_segment_plain``'s d_table against
    ``gather_pool_bwd_plain`` (``index_add_``) and ``jax.grad`` of
    ``gather_pool_ad`` (Pallas forward in interpret mode): f32 1e-5, bf16
    one step (each rounds one f32 sum, taken in another order)."""
    import jax
    import jax.numpy as jnp

    _, j_pool = jax_ops
    table, nbrs, w, lay = _case_layout(case)
    limit = lay.limit
    if dtype == "bfloat16":
        table = _bf16_round(table)
    b, d = nbrs.shape[0], table.shape[1]
    g = np.random.default_rng(5).standard_normal((b, d)).astype(np.float32)
    td = getattr(torch, dtype)
    tt, nb, ww, gg = (torch.from_numpy(table).to(td), torch.from_numpy(nbrs),
                      torch.from_numpy(w), torch.from_numpy(g))
    got = t_pool.gather_pool_bwd_segment_plain(tt, nb, ww, limit, gg, lay)
    assert got.dtype == td and got.shape == tt.shape
    ref, _ = t_pool.gather_pool_bwd_plain(tt, nb, ww, limit, gg, need_weights=False)
    _assert_d_table(got, ref, dtype)
    if b == 0:
        assert not got.float().any()
        return

    def f(t):
        return jnp.sum(j_pool.gather_pool_ad(t, jnp.asarray(nbrs), jnp.asarray(w), limit,
                                             4, True) * g)

    j_ref = jax.grad(f)(jnp.asarray(table, getattr(jnp, dtype)))
    _assert_d_table(got, torch.from_numpy(np.array(j_ref, np.float32)).to(td), dtype)


@pytest.mark.parametrize("case", MASKED_CASES)
def test_masked_layout_changes_only_the_rows_of_zero_weights(case):
    """A layout built with the weights sums every row that held no slot of
    weight 0 exactly as the layout without them (the same slots in the same
    chunks), bitwise; the rows that did differ by rounding at most."""
    table, nbrs, w, masked = _case_layout(case)
    limit, chunk = masked.limit, masked.chunk
    nb = torch.from_numpy(nbrs)
    full = t_pool.segment_layout(nb, limit, chunk)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (nbrs.shape[0], table.shape[1])).astype(np.float32))
    args = (torch.from_numpy(table), nb, torch.from_numpy(w), limit, g)
    got = t_pool.gather_pool_bwd_segment_plain(*args, masked)
    ref = t_pool.gather_pool_bwd_segment_plain(*args, full)
    flat, wf = nbrs.reshape(-1), w.reshape(-1)
    touched = np.zeros(table.shape[0], bool)
    touched[flat[(flat >= 0) & (flat < limit) & (wf == 0)]] = True
    assert touched.any() and not touched.all()
    assert torch.equal(got[~touched], ref[~touched])
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_masked_layout_keeps_the_padding_off_row_zero():
    """A hub residual at scale (over 10k padding slots, id 0, weight 0): the
    layout built without the weights gives row 0 one split of at least
    padding / chunk partials, all summed by one warp of pass 2; built with
    them, no split row has more partials than the most real slots of an id
    need."""
    _, nbrs, w = _hub_padded(16, 4000, 4000, 8, 3)
    pad = int((w == 0).sum())
    assert pad >= 10_000
    nb, ww = torch.from_numpy(nbrs), torch.from_numpy(w)
    chunk = t_pool.SEGMENT_CHUNK

    def most_partials(lay):
        _, _, sp = _plan(lay)
        return int((sp[:, 2] - sp[:, 1]).max(initial=0))

    real_max = int(np.bincount(nbrs[w != 0], minlength=4000).max())
    assert most_partials(t_pool.segment_layout(nb, 4000)) >= pad // chunk
    assert most_partials(t_pool.segment_layout(nb, 4000, weights=ww)) <= -(-real_max // chunk)


def test_segment_layout_checks_its_weights():
    nbrs = torch.zeros(3, 2, dtype=torch.int32)
    for bad in (torch.ones(3, 3), torch.ones(2, 2)):
        with pytest.raises(ValueError, match="weights must be"):
            t_pool.segment_layout(nbrs, 4, weights=bad)


def test_gather_pool_bwd_routes_and_layouts_are_checked():
    """``route=`` takes "segment" or "atomic" only, a layout only with
    "segment", and a layout built for another shape or limit raises (in the
    forward and in the backward); on CPU tensors both routes are
    ``gather_pool_bwd_plain``."""
    table, nbrs, w, g = (torch.from_numpy(x) for x in _pool_grad_inputs(40, 24, 9, 6, 33,
                                                                         "float32"))
    ref = t_pool.gather_pool_bwd_plain(table, nbrs, w, 33, g)
    lay = t_pool.segment_layout(nbrs, 33)
    for route, layout in (("segment", None), ("segment", lay), ("atomic", None)):
        got = t_pool.gather_pool_bwd(table, nbrs, w, 33, g, route=route, layout=layout)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError, match="route"):
        t_pool.gather_pool_bwd(table, nbrs, w, 33, g, route="fast")
    with pytest.raises(ValueError, match="segment route"):
        t_pool.gather_pool_bwd(table, nbrs, w, 33, g, route="atomic", layout=lay)
    for wrong in (t_pool.segment_layout(nbrs, 32), t_pool.segment_layout(nbrs[:8], 33)):
        with pytest.raises(ValueError, match="layout was built for"):
            t_pool.gather_pool_bwd(table, nbrs, w, 33, g, layout=wrong)
        with pytest.raises(ValueError, match="layout was built for"):
            t_pool.gather_pool(table.requires_grad_(), nbrs, w, 33, bwd_layout=wrong)


def test_gather_pool_autograd_takes_a_bwd_layout():
    """``gather_pool(..., bwd_layout=)`` gives the gradients it gives
    without one."""
    table, nbrs, w, g = (torch.from_numpy(x) for x in _pool_grad_inputs(40, 24, 9, 6, 33,
                                                                         "float32"))
    lay = t_pool.segment_layout(nbrs, 33)
    with_layout = _grads_through(
        lambda t, nb, ww, lim: t_pool.gather_pool(t, nb, ww, lim, bwd_layout=lay),
        table, nbrs, w, 33, g, ("table", "weights"))
    without = _grads_through(t_pool.gather_pool, table, nbrs, w, 33, g, ("table", "weights"))
    assert all(torch.equal(a, b) for a, b in zip(with_layout, without))


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


# The training step's shapes: layer 0 over the whole graph (B = N = 3980),
# the batch layer at epoch 0 (B = 2 * 512 + 500) and with six hard negatives
# per query (B = 1524 + 512 * 6); plus the edge shapes above.
CUDA_BWD_CASES = CUDA_POOL_CASES + [
    (3980, 256, 3980, 50, 3980, "bfloat16"),
    (3980, 256, 1524, 50, 3980, "bfloat16"),
    (3980, 256, 4596, 50, 3980, "bfloat16"),
    (3980, 256, 1524, 50, 3980, "float32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("route", t_pool.BWD_ROUTES)
@pytest.mark.parametrize("n,d,b,k,limit,dtype", CUDA_BWD_CASES)
def test_gather_pool_bwd_kernel_matches_plain(cuda, n, d, b, k, limit, dtype, route):
    """Either route: d_table within 1e-4 (f32; sums in another order, the
    atomic route's in a run-dependent one) or one bf16 step, d_w within
    1e-4; one counted launch per call."""
    table, nbrs, w = _cuda_pool_inputs(cuda, 6, n, d, b, k, limit, dtype)
    g = torch.randn((b, d), generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    before = t_pool.BWD_LAUNCHES
    d_t, d_w = t_pool.gather_pool_bwd(table, nbrs, w, limit, g, route=route)
    torch.cuda.synchronize()
    assert t_pool.BWD_LAUNCHES == before + 1
    r_t, r_w = t_pool.gather_pool_bwd_plain(table, nbrs, w, limit, g)
    assert d_t.dtype == table.dtype and d_w.dtype == torch.float32
    if dtype == "bfloat16":
        torch.testing.assert_close(d_t.float(), r_t.float(), rtol=2**-7, atol=1e-5)
    else:
        torch.testing.assert_close(d_t, r_t, rtol=0, atol=1e-4)
    torch.testing.assert_close(d_w, r_w, rtol=0, atol=1e-4)
    d_t2, none = t_pool.gather_pool_bwd(table, nbrs, w, limit, g, need_weights=False,
                                        route=route)
    assert none is None and d_t2.shape == d_t.shape


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _segment_bitwise(table, nbrs, w, limit, g, chunk=t_pool.SEGMENT_CHUNK, masked=False):
    """The plan kernel's layout (built with the weights where ``masked``)
    equal to the one built on the CPU (plain plan), and the segment
    kernel's d_table (layout built ahead, and built by the call) bitwise
    equal to ``gather_pool_bwd_segment_plain`` and across calls, one
    counted launch each."""
    plans = t_pool.PLAN_LAUNCHES
    lay = t_pool.segment_layout(nbrs, limit, chunk, weights=w if masked else None)
    assert t_pool.PLAN_LAUNCHES == plans + t_pool.PLAN_KERNELS
    cpu = t_pool.segment_layout(nbrs.cpu(), limit, chunk, weights=w.cpu() if masked else None)
    assert torch.equal(lay.totals.cpu(), cpu.totals)
    assert torch.equal(lay.row_ptr.cpu(), cpu.row_ptr)
    for a, b in zip(_plan(lay._replace(**{f: getattr(lay, f).cpu() for f in
                                          ("row_ptr", "slots", "chunks", "splits", "totals")})),
                    _plan(cpu)):
        np.testing.assert_array_equal(a, b)
    before = t_pool.SEGMENT_LAUNCHES
    outs = [t_pool.gather_pool_bwd(table, nbrs, w, limit, g, need_weights=False,
                                   layout=lay)[0] for _ in range(2)]
    if chunk == t_pool.SEGMENT_CHUNK:
        outs.append(t_pool.gather_pool_bwd(table, nbrs, w, limit, g, need_weights=False)[0])
    torch.cuda.synchronize()
    assert t_pool.SEGMENT_LAUNCHES == before + len(outs)
    ref = t_pool.gather_pool_bwd_segment_plain(table, nbrs, w, limit, g, lay)
    assert outs[0].dtype == table.dtype
    for out in outs:
        assert torch.equal(_bits(out), _bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [t_pool.SEGMENT_CHUNK, 3])
@pytest.mark.parametrize("n,d,b,k,limit,dtype", CUDA_BWD_CASES)
def test_gather_pool_bwd_segment_kernel_is_bitwise(cuda, n, d, b, k, limit, dtype, chunk):
    """The segment route against its plain version, bitwise, and from run to
    run, at the default chunk and at chunks of 3 (most ids split)."""
    table, nbrs, w = _cuda_pool_inputs(cuda, 8, n, d, b, k, limit, dtype)
    g = torch.randn((b, d), generator=torch.Generator(cuda).manual_seed(2), device=cuda)
    _segment_bitwise(table, nbrs, w, limit, g, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_pool_bwd_segment_kernel_skewed_and_unaligned(cuda, dtype):
    """A walk-shaped table whose hub spans many chunks (limit below N: the
    rows past it are written as zeros), with an aligned g, and with a g view
    that is not 16-byte aligned (the scalar path)."""
    table, nbrs, w = _skewed_walk(10, 700, 600, 40, 650)
    t = torch.from_numpy(table).to(cuda, getattr(torch, dtype))
    nb, ww = torch.from_numpy(nbrs).to(cuda), torch.from_numpy(w).to(cuda)
    gen = torch.Generator(cuda).manual_seed(3)
    g = torch.randn((600, 24), generator=gen, device=cuda)
    _segment_bitwise(t, nb, ww, 650, g)
    flat = torch.randn(600 * 24 + 1, generator=gen, device=cuda)
    g_view = flat[1:].view(600, 24)
    assert g_view.data_ptr() % 16 != 0
    _segment_bitwise(t, nb, ww, 650, g_view)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_pool_bwd_segment_kernel_on_a_masked_layout(cuda, dtype):
    """A hub-residual-shaped table (padding slots of id 0 and weight 0) and
    a walk table with zero weights scattered over it: the kernel's d_table
    on the layout built with the weights (ahead, and by the call) bitwise
    equal to its plain version on that layout."""
    gen = torch.Generator(cuda).manual_seed(5)
    for (table, nbrs, w), limit in ((_hub_padded(17, 4000, 4000, 16, 6), 4000),
                                    (_with_zero_weights(18, _skewed_walk(19, 700, 600, 40,
                                                                         650)), 650)):
        t = torch.from_numpy(table).to(cuda, getattr(torch, dtype))
        nb, ww = torch.from_numpy(nbrs).to(cuda), torch.from_numpy(w).to(cuda)
        g = torch.randn((nbrs.shape[0], table.shape[1]), generator=gen, device=cuda)
        _segment_bitwise(t, nb, ww, limit, g, masked=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,b,k", EMPTY_BWD_CASES)
def test_gather_pool_bwd_kernel_empty_shapes(cuda, n, d, b, k):
    """The CUDA twin of ``test_gather_pool_bwd_empty_shapes`` (no launch)."""
    _empty_bwd(cuda, n, d, b, k)


@pytest.mark.cuda
@pytest.mark.parametrize("wrt", [("table",), ("weights",), ("table", "weights")])
def test_gather_pool_autograd_on_the_card(cuda, wrt):
    """The CUDA twin of ``test_gather_pool_autograd_equals_autograd_through_plain``:
    forward and backward kernels, one launch each."""
    table, nbrs, w = _cuda_pool_inputs(cuda, 7, 500, 64, 300, 20, 450, "float32")
    g = torch.randn((300, 64), generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    before = (t_pool.LAUNCHES, t_pool.BWD_LAUNCHES)
    got = _grads_through(t_pool.gather_pool, table, nbrs, w, 450, g, wrt)
    torch.cuda.synchronize()
    assert (t_pool.LAUNCHES, t_pool.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref = _grads_through(t_pool.gather_pool_plain, table, nbrs, w, 450, g, wrt)
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_gather_pool_autograd_through_bwd_layout_on_the_card(cuda):
    """``GatherPoolFunction`` with a layout built ahead: the table's gradient
    is the segment kernel's, bitwise equal to its plain version and to the
    gradient without a layout (built in the backward)."""
    table, nbrs, w = _cuda_pool_inputs(cuda, 9, 500, 64, 300, 20, 450, "bfloat16")
    g = torch.randn((300, 64), generator=torch.Generator(cuda).manual_seed(4), device=cuda)
    lay = t_pool.segment_layout(nbrs, 450)
    before = t_pool.SEGMENT_LAUNCHES
    with_layout, _ = _grads_through(
        lambda t, nb, ww, lim: t_pool.gather_pool(t, nb, ww, lim, bwd_layout=lay),
        table, nbrs, w, 450, g, ("table",))
    without, _ = _grads_through(t_pool.gather_pool, table, nbrs, w, 450, g, ("table",))
    torch.cuda.synchronize()
    assert t_pool.SEGMENT_LAUNCHES == before + 2
    ref = t_pool.gather_pool_bwd_segment_plain(table, nbrs, w, 450, g, lay)
    assert torch.equal(_bits(with_layout), _bits(ref))
    assert torch.equal(_bits(without), _bits(ref))


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


# ---------------------------------------------------------------------------
# Edge slices: the message sum of the edge forward and the PPR push
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("width", [4, 16])
def test_slice_sum_matches_index_add_and_repeats(request, device, width):
    """``slice_sum`` over ``edge_slices`` (targets in edge order, sliced)
    equals ``slice_sum_plain`` (``index_add_``) to f32 rounding, gives 0 to
    a target without edges, and two calls are bitwise equal; on the card it
    launches the gather-pool kernel once."""
    dev = request.getfixturevalue("cuda") if device == "cuda" else torch.device("cpu")
    rng = np.random.default_rng(width)
    n, e, d = 300, 4000, 64
    src = torch.as_tensor(rng.integers(0, n, e), device=dev)
    dst = torch.as_tensor(rng.integers(0, n - 3, e), device=dev)
    w = torch.as_tensor(rng.random(e).astype(np.float32) * 3, device=dev)
    x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=dev).bfloat16()
    es = t_pool.edge_slices(src, dst, w, n, width)
    assert es.nbrs.shape[1] == width and int(es.slices.sum()) == es.nbrs.shape[0]
    t_pool.LAUNCHES = 0
    got = t_pool.slice_sum(x, es)
    assert t_pool.LAUNCHES == (1 if device == "cuda" else 0)
    ref = t_pool.slice_sum_plain(x, src, dst, w, n)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=2e-5, rtol=1e-5)
    assert (got[-3:] == 0).all()
    again = t_pool.slice_sum(x, es)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
