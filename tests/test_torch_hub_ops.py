"""PyTorch port, the hub and block operators on the card, and the hub
residual's shape in the gather-pool kernels (K = 8).

No JAX here (``test_torch_hub`` holds the operators to the JAX package), so
the file runs on the card too:
``python -m pytest tests/test_torch_hub_ops.py -m cuda --noconftest``. Tests
marked ``cuda`` hold the card's results against the CPU's (plain versions)
and skip on a machine without a card. Tolerances: the gather-pool forward
1e-4 and the segment backward bitwise, as ``test_torch_ops``; operators in
f32 1e-4 (cuBLAS and the CPU sum in other orders), in bf16 compute 2e-2;
slabs built on the card within one step of their dtype of the CPU's (the
row sums add in another order) and bitwise equal from build to build.
"""

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch.ops import block_sparse as t_bsp
from movie_recommendation_engine_tpu_torch.ops import hub_pool as t_hub
from movie_recommendation_engine_tpu_torch.ops import pool as t_pool


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def popularity_tables(n: int, k: int = 50, seed: int = 0):
    """Walk-table-shaped ids and weights: 60% of the slots drawn from a
    Pareto(1.2) popularity, weights ~ popularity^0.45 x lognormal(2.0),
    rows normalized (ids may repeat within a row)."""
    rng = np.random.default_rng(seed)
    pop = rng.pareto(1.2, size=n) + 1.0
    pop /= pop.sum()
    mix = rng.random((n, k)) < 0.60
    nb = np.where(mix, rng.choice(n, size=(n, k), p=pop), rng.integers(0, n, (n, k)))
    w = (pop[nb] * n) ** 0.45 * rng.lognormal(0.0, 2.0, size=(n, k))
    w /= w.sum(axis=1, keepdims=True)
    return torch.from_numpy(nb.astype(np.int32)), torch.from_numpy(w.astype(np.float32))


def sentinel_tables(n: int, k: int, long_rows: int, seed: int = 0, share: float = 0.08,
                    counts: bool = False):
    """Walk-table-shaped ids and weights with the walk tables' sentinels:
    ids distinct within a row (a random start plus increasing gaps), column
    5 put in ``long_rows`` rows, then about ``share`` of the other slots
    made sentinels (id n, past the valid limit n, weight 0), which all
    clamp onto column n - 1. Weights are lognormal, or integer visit counts
    (``counts``: every row sum exact, so the normalized weights are the same
    bits on every device); rows are not normalized (the builders do)."""
    rng = np.random.default_rng(seed)
    gaps = rng.integers(1, n // k, (n, k))
    nb = (rng.integers(0, n, (n, 1)) + np.cumsum(gaps, axis=1)) % n
    rows = rng.choice(n, long_rows, replace=False)
    nb[rows, 0] = np.where((nb[rows] == 5).any(axis=1), nb[rows, 0], 5)
    sent = (rng.random((n, k)) < share) & (nb != 5)
    w = (rng.integers(1, 8, (n, k)).astype(np.float32) if counts
         else rng.lognormal(0.0, 1.0, (n, k)).astype(np.float32))
    nb, w = np.where(sent, n, nb), np.where(sent, 0.0, w)
    return torch.from_numpy(nb.astype(np.int32)), torch.from_numpy(w.astype(np.float32))


def _normalized(nb: torch.Tensor, w: torch.Tensor, limit: int) -> torch.Tensor:
    w = torch.where(nb < limit, w, 0.0)
    s = w.sum(dim=1, keepdim=True)
    return torch.where(s > 0, w / s.clamp_min(1e-12), 0.0)


def _bits(x: torch.Tensor) -> torch.Tensor:
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.view(ints[x.element_size()])


def _hub(device, n=2048, dtype=torch.bfloat16, head=256, residual=8, seed=0, k=50):
    nb, w = popularity_tables(n, k=k, seed=seed)
    return t_hub.build_hub_pool_device(nb.to(device), w.to(device), valid_limit=n,
                                       head=head, residual=residual, dtype=dtype)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_hub_residual_padding_is_row_zero(device, request):
    """Rows with fewer than R residual entries pad with id 0 and weight 0;
    the residual's segment layout (limit N) built without the weights counts
    them as row 0's slots, so row 0 is one long split row: correct, as each
    adds 0 * g. Built with the weights, as the trainer builds it, row 0
    keeps only its slots of nonzero weight."""
    dev = request.getfixturevalue("cuda") if device == "cuda" else torch.device("cpu")
    hp, _ = _hub(dev, head=1024, k=16)
    pad = (hp.res_w == 0)
    assert bool(pad.any()) and bool((hp.res_nbrs[pad] == 0).all())
    lay = t_pool.segment_layout(hp.res_nbrs, hp.res_nbrs.shape[0])
    c = int(lay.totals[0])
    row0 = int((hp.res_nbrs == 0).sum())
    assert int(lay.row_ptr[1] - lay.row_ptr[0]) == row0
    assert int((lay.chunks[:c, 0] == 0).sum()) == -(-row0 // lay.chunk) > 1
    masked = t_pool.segment_layout(hp.res_nbrs, hp.res_nbrs.shape[0], weights=hp.res_w)
    c = int(masked.totals[0])
    real0 = int(((hp.res_nbrs == 0) & ~pad).sum())
    assert int(masked.row_ptr[1] - masked.row_ptr[0]) == real0 < row0
    assert int((masked.chunks[:c, 0] == 0).sum()) == max(1, -(-real0 // masked.chunk))


def test_build_hub_pool_device_is_repeatable():
    a, sa = _hub("cpu", dtype=torch.float8_e4m3fn)
    b, sb = _hub("cpu", dtype=torch.float8_e4m3fn)
    assert sa == sb
    for x, y in zip(a, b):
        assert torch.equal(_bits(x), _bits(y))


def test_column_mass_leaves_the_sentinels_out():
    """The column mass of a table whose sentinels (8% of the slots, weight
    0) all clamp onto the last column and whose column 5 is longer than
    100 chunks: within 1e-6 relative of a float64 sum on every column; the
    layout keeps exactly the slots of nonzero weight and cuts column 5 into
    chunks; the last column sums its own slots alone."""
    n, k = 4096, 16
    nb, w = sentinel_tables(n, k, long_rows=3500)
    w = _normalized(nb, w, n)
    cols = nb.clamp(0, n - 1)
    mass, kept = t_hub.column_mass(cols, w)
    ref = np.bincount(cols.reshape(-1).numpy(), weights=w.reshape(-1).double().numpy(),
                      minlength=n)
    sent = nb >= n
    assert 0.07 < float(sent.float().mean()) < 0.09
    assert int(kept) == int((~sent).sum())
    assert int((cols == 5).sum()) > 100 * t_pool.SEGMENT_CHUNK
    np.testing.assert_allclose(mass.double().numpy(), ref, rtol=1e-6, atol=0)
    assert float(mass[n - 1]) == pytest.approx(float(w[nb == n - 1].double().sum()), rel=1e-6)
    lay = t_pool.segment_layout(cols, n, weights=w)
    c = int(lay.totals[0])
    assert int((lay.chunks[:c, 0] == 5).sum()) == -(-int((cols == 5).sum()) // lay.chunk)
    assert int((lay.chunks[:c, 0] == n - 1).sum()) == 1


def test_hub_build_with_sentinels_matches_the_host_builder():
    """The device builder on a table of sentinels and one long column: the
    host builder's head, residual and stats (its column mass a float64
    ``bincount``; the masses here apart by more than twice the 1e-6 the
    column mass is held to, so no near-tie can flip),
    weights and slab within 1e-6; bitwise repeatable; ``mass_slots_skipped``
    is the table's sentinel share."""
    n, k, head = 4096, 16, 256
    nb, w = sentinel_tables(n, k, long_rows=3500)
    ref_mass = np.sort(np.bincount(nb.clamp(0, n - 1).reshape(-1).numpy(),
                                   weights=_normalized(nb, w, n).reshape(-1).double().numpy(),
                                   minlength=n))[::-1][:head + 1]
    assert ((ref_mass[:-1] - ref_mass[1:]) / ref_mass[:-1]).min() > 2e-6
    got, st = t_hub.build_hub_pool_device(nb, w, valid_limit=n, head=head, residual=4,
                                          dtype=torch.float32)
    again, st2 = t_hub.build_hub_pool_device(nb, w, valid_limit=n, head=head, residual=4,
                                             dtype=torch.float32)
    ref, rst = t_hub.build_hub_pool(nb, w, valid_limit=n, head=head, residual=4,
                                    dtype=torch.float32)
    assert st == st2
    for x, y in zip(got, again):
        assert torch.equal(_bits(x), _bits(y))
    assert torch.equal(got.head_ids, ref.head_ids) and int(got.head_ids[0]) == 5
    assert torch.equal(got.res_nbrs, ref.res_nbrs)
    torch.testing.assert_close(got.res_w, ref.res_w, atol=1e-6, rtol=0)
    torch.testing.assert_close(got.a_head, ref.a_head, atol=1e-6, rtol=1e-6)
    for key in ("head_cols", "residual_per_row", "a_bytes_built"):
        assert st[key] == rst[key], key
    for key in ("dropped_mass", "head_mass"):
        assert st[key] == pytest.approx(rst[key], abs=1e-6), key
    assert st["mass_slots_skipped"] == pytest.approx(float((nb >= n).float().mean()), abs=1e-7)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_take_rows_of_a_float8_slab(device, request):
    dev = request.getfixturevalue("cuda") if device == "cuda" else torch.device("cpu")
    a = torch.rand((50, 7), device=dev).to(torch.float8_e4m3fn)
    rows = torch.tensor([3, 0, 49, 3], device=dev)
    got = t_hub.take_rows(a, rows)
    assert got.dtype == torch.float8_e4m3fn
    assert torch.equal(got.float(), a.float()[rows])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b", [None, 1524])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_pool_kernels_at_the_hub_residual_shape(cuda, b, dtype):
    """The residual of a hub layer (K = 8, valid limit N, padding slots of
    row 0): the forward kernel within 1e-4 of its plain version, the segment
    backward bitwise equal to its plain version and from call to call; the
    whole graph (B = N) and a batch layer's rows."""
    hp, _ = _hub(cuda, head=1024, k=16)
    n = hp.res_nbrs.shape[0]
    rows = (torch.arange(n, device=cuda) if b is None
            else torch.randint(0, n, (b,), generator=torch.Generator(cuda).manual_seed(2),
                               device=cuda))
    nbrs, w = hp.res_nbrs[rows].contiguous(), hp.res_w[rows].contiguous()
    gen = torch.Generator(cuda).manual_seed(1)
    table = torch.randn((n, 64), generator=gen, device=cuda).to(dtype)
    g = torch.randn((nbrs.shape[0], 64), generator=gen, device=cuda)
    before = (t_pool.LAUNCHES, t_pool.SEGMENT_LAUNCHES)
    out = t_pool.gather_pool(table, nbrs, w, n)
    lay = t_pool.segment_layout(nbrs, n)
    masked = t_pool.segment_layout(nbrs, n, weights=w)
    d1 = t_pool.gather_pool_bwd(table, nbrs, w, n, g, need_weights=False, layout=lay)[0]
    d2 = t_pool.gather_pool_bwd(table, nbrs, w, n, g, need_weights=False)[0]
    d3 = t_pool.gather_pool_bwd(table, nbrs, w, n, g, need_weights=False, layout=masked)[0]
    torch.cuda.synchronize()
    assert (t_pool.LAUNCHES, t_pool.SEGMENT_LAUNCHES) == (before[0] + 1, before[1] + 3)
    torch.testing.assert_close(out, t_pool.gather_pool_plain(table, nbrs, w, n),
                               atol=1e-4, rtol=0)
    ref = t_pool.gather_pool_bwd_segment_plain(table, nbrs, w, n, g, lay)
    assert torch.equal(_bits(d1), _bits(ref))
    # Built by the call, the layout leaves the padding out, as ``masked`` does.
    ref = t_pool.gather_pool_bwd_segment_plain(table, nbrs, w, n, g, masked)
    assert torch.equal(_bits(d2), _bits(ref)) and torch.equal(_bits(d3), _bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
def test_hub_build_on_the_card_equals_cpu(cuda, dtype):
    """The device builder on the card: the same head and residual as on the
    CPU (distinct column masses here, so no near-tie can flip), weights
    within 1e-6 of the CPU's (its row sums add in another order), so the
    slab within one step of its dtype; bitwise repeatable on the card."""
    got, st = _hub(cuda, dtype=dtype)
    again, _ = _hub(cuda, dtype=dtype)
    ref, rst = _hub("cpu", dtype=dtype)
    for x, y in zip(got, again):
        assert torch.equal(_bits(x), _bits(y))
    assert torch.equal(got.head_ids.cpu(), ref.head_ids)
    assert torch.equal(got.res_nbrs.cpu(), ref.res_nbrs)
    torch.testing.assert_close(got.res_w.cpu(), ref.res_w, atol=1e-6, rtol=0)
    step = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7, torch.float8_e4m3fn: 2.0 ** -3}
    torch.testing.assert_close(got.a_head.cpu().float(), ref.a_head.float(), atol=1e-6,
                               rtol=step[dtype])
    for key in ("dropped_mass", "head_mass"):
        assert st[key] == pytest.approx(rst[key], abs=1e-6)


@pytest.mark.cuda
def test_hub_build_at_the_cell_shape_equals_cpu(cuda):
    """59,393 x 50 with ~8% sentinels and a 14,000-slot column, visit-count
    weights (the same normalized bits on both devices): the card's column
    mass bitwise equal to the CPU's (the segment kernels against their
    plain version, ties included), so the same head and residual; each
    build launches the segment backward once; two builds bitwise equal."""
    n, k = 59_393, 50
    nb, w = sentinel_tables(n, k, long_rows=14_000, seed=4, counts=True)
    cols = nb.clamp(0, n - 1)
    wn = _normalized(nb, w, n)
    mass, kept = t_hub.column_mass(cols.to(cuda), wn.to(cuda))
    ref_mass, ref_kept = t_hub.column_mass(cols, wn)
    assert torch.equal(_bits(mass.cpu()), _bits(ref_mass)) and int(kept) == int(ref_kept)

    def build(dev):
        return t_hub.build_hub_pool_device(nb.to(dev), w.to(dev), valid_limit=n, head=0,
                                           residual=8, dtype=torch.bfloat16)

    before = (t_pool.SEGMENT_LAUNCHES, t_pool.PLAN_LAUNCHES)
    got, st = build(cuda)
    again, st2 = build(cuda)
    torch.cuda.synchronize()
    assert (t_pool.SEGMENT_LAUNCHES, t_pool.PLAN_LAUNCHES) == (before[0] + 2,
                                                               before[1] + 2 * t_pool.PLAN_KERNELS)
    ref, rst = build("cpu")
    assert st == st2
    for x, y in zip(got, again):
        assert torch.equal(_bits(x), _bits(y))
    assert torch.equal(got.head_ids.cpu(), ref.head_ids)
    assert torch.equal(got.res_nbrs.cpu(), ref.res_nbrs)
    torch.testing.assert_close(got.res_w.cpu(), ref.res_w, atol=1e-6, rtol=0)
    torch.testing.assert_close(got.a_head.cpu().float(), ref.a_head.float(), atol=1e-6,
                               rtol=2.0 ** -7)
    assert st["mass_slots_skipped"] == rst["mass_slots_skipped"]
    assert st["mass_slots_skipped"] == pytest.approx(float((nb >= n).float().mean()), abs=1e-7)
    for key in ("dropped_mass", "head_mass"):    # f32 sums of 3M weights, another order
        assert st[key] == pytest.approx(rst[key], abs=1e-5)


def _to(hp, device):
    return type(hp)(*(x.to(device) for x in hp))


@pytest.mark.cuda
@pytest.mark.parametrize("slab", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
def test_hub_pool_matmul_on_the_card_matches_cpu(cuda, slab, impl, compute, monkeypatch):
    """Full and batch forms and the gradient in h (f32) on the card against
    the CPU, from one operator; with ``pallas`` the residual launches the
    forward kernel once a call and the segment backward once a gradient.
    Small row chunks force the chunked slab conversion."""
    monkeypatch.setattr(t_hub, "_CHUNK_BYTES", 1 << 16)
    hp, _ = _hub("cpu", dtype=slab)
    hc = _to(hp, cuda)
    n = hp.a_head.shape[0]
    h = torch.randn((n, 64), generator=torch.Generator().manual_seed(3))
    batch = torch.randint(0, n + 3, (300,), generator=torch.Generator().manual_seed(4))
    r = torch.randn((n, 64), generator=torch.Generator().manual_seed(5))

    def run(op, x, bt):
        x = x.to(compute).requires_grad_()
        full = t_hub.hub_pool_matmul(op, x, compute, impl)
        rows = t_hub.hub_pool_matmul_batch(op, x, bt, compute, impl)
        ((full.float() * r.to(x.device)).sum() + rows.float().sum()).backward()
        return full.detach().float(), rows.detach().float(), x.grad.float()

    before = (t_pool.LAUNCHES, t_pool.SEGMENT_LAUNCHES)
    got = run(hc, h.to(cuda), batch.to(cuda))
    torch.cuda.synchronize()
    if impl == "pallas":
        assert (t_pool.LAUNCHES, t_pool.SEGMENT_LAUNCHES) == (before[0] + 2, before[1] + 2)
    ref = run(hp, h, batch)
    tol = 1e-4 if compute == torch.float32 else 2e-2
    for a, b in zip(got, ref):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a.cpu(), b, atol=tol * scale, rtol=0)


@pytest.mark.cuda
def test_hub_pool_gradient_is_bitwise_repeatable_on_the_card(cuda):
    """bf16, kernels: two gradients in h bitwise equal (the head product is
    one GEMM, the gathers back into sort-based index_put, the residual into
    the segment kernel)."""
    hp, _ = _hub(cuda)
    h = torch.randn((hp.a_head.shape[0], 64), generator=torch.Generator(cuda).manual_seed(6),
                    device=cuda).bfloat16()
    batch = torch.randint(0, h.shape[0], (500,), generator=torch.Generator(cuda).manual_seed(7),
                          device=cuda)
    lay = t_pool.segment_layout(hp.res_nbrs, h.shape[0], weights=hp.res_w)

    def grad():
        x = h.clone().requires_grad_()
        out = (t_hub.hub_pool_matmul(hp, x, torch.bfloat16, "pallas", bwd_layout=lay).float()
               .square().sum()
               + t_hub.hub_pool_matmul_batch(hp, x, batch, torch.bfloat16, "pallas").float().sum())
        out.backward()
        return x.grad

    assert torch.equal(_bits(grad()), _bits(grad()))


@pytest.mark.cuda
@pytest.mark.parametrize("compute,slab", [(torch.float32, torch.bfloat16),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float8_e4m3fn)])
def test_block_pool_on_the_card_matches_cpu(cuda, compute, slab):
    """The block builder's scatter on the card bitwise equal to the CPU's
    (the index math is the same numpy), the float8 cast after it, and the
    pooled output and gradient in h against the CPU's."""
    nb, w = popularity_tables(1000, k=20, seed=3)
    perm = t_bsp.mass_permutation(nb, w)
    bp, st = t_bsp.build_block_pool(nb, w, perm, block_size=128, max_blocks=4)
    bc, sc = t_bsp.build_block_pool(nb.to(cuda), w.to(cuda), perm, block_size=128, max_blocks=4)
    bp = bp._replace(a_blocks=bp.a_blocks.to(slab))
    bc = bc._replace(a_blocks=bc.a_blocks.to(slab))
    assert st == sc and torch.equal(_bits(bc.a_blocks.cpu()), _bits(bp.a_blocks))
    h = torch.randn((1000, 64), generator=torch.Generator().manual_seed(8))

    def run(op, x):
        x = x.to(compute).requires_grad_()
        out = t_bsp.block_pool_matmul(op, x, compute).float()
        out.square().sum().backward()
        return out, x.grad.float()

    tol = 1e-4 if compute == torch.float32 else 2e-2
    for a, b in zip(run(bc, h.to(cuda)), run(bp, h)):
        torch.testing.assert_close(a.cpu(), b, atol=tol * max(1.0, float(b.abs().max())), rtol=0)
