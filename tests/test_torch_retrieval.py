"""PyTorch port, retrieval and evaluation against the JAX package:
``ExactIndex``, ``LSHIndex`` in both Hamming forms (JAX's hyperplanes and
signatures injected), ``evaluate_embeddings`` / ``recommend``, the batching
server, the ANN benchmark harness (JAX's hyperplanes and k-means initial
rows injected) and the ``benchmark`` / ``all`` CLI modes.
"""

import threading
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu.evaluation import metrics as j_metrics
from movie_recommendation_engine_tpu.retrieval import exact as j_exact
from movie_recommendation_engine_tpu.retrieval import lsh as j_lsh
from movie_recommendation_engine_tpu_torch.evaluation import metrics as t_metrics
from movie_recommendation_engine_tpu_torch.retrieval import exact as t_exact
from movie_recommendation_engine_tpu_torch.retrieval import lsh as t_lsh
from movie_recommendation_engine_tpu_torch.retrieval.server import BatchingRecommender


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_exact_index_matches_jax():
    """Distances to 1e-5; index sets equal except where a distance ties the
    k-th within 1e-6."""
    rng = np.random.default_rng(0)
    emb, q, k = _unit_rows(rng, 150, 16), _unit_rows(rng, 9, 16), 10
    emb[7] = emb[3]                                      # an exact tie
    ji = j_exact.ExactIndex(16)
    ji.build(jnp.asarray(emb))
    jd, jidx = map(np.asarray, ji.search(jnp.asarray(q), k))
    ti = t_exact.ExactIndex(16, device="cpu")
    ti.build(emb)
    td, tidx = (t.numpy() for t in ti.search(q, k))
    np.testing.assert_allclose(td, jd, atol=1e-5)
    for row in range(q.shape[0]):
        differ = set(tidx[row]) ^ set(jidx[row])
        full = ((q[row] - emb) ** 2).sum(1)
        assert all(abs(full[i] - jd[row, -1]) <= 1e-6 for i in differ)


@pytest.fixture(scope="module")
def lsh_setup():
    rng = np.random.default_rng(1)
    dim, bits, tables = 16, 64, 4
    emb, q = _unit_rows(rng, 120, dim), _unit_rows(rng, 11, dim)
    j_index = j_lsh.LSHIndex(dim, bits, tables, seed=0, use_pallas=False,
                             hamming_impl="popcount")
    j_index.build(jnp.asarray(emb))
    planes = np.asarray(j_index.planes)
    return emb, q, planes, j_index


def test_lsh_signatures_match_jax(lsh_setup):
    """Same planes, same sign bits wherever the projection is not within
    1e-5 of zero (there the two frameworks may round to either side)."""
    emb, _, planes, j_index = lsh_setup
    t_index = t_lsh.LSHIndex(16, 64, 4, planes=planes, device="cpu")
    t_sigs = t_index._signatures(torch.from_numpy(emb)).numpy().view(np.uint32)
    j_sigs = np.asarray(j_index._sigs)
    proj = emb.astype(np.float64) @ planes.transpose(1, 0, 2).reshape(16, -1)
    safe = (np.abs(proj) > 1e-5).reshape(emb.shape[0], 4, 2, 32)
    bits = np.arange(32, dtype=np.uint32)
    tb = (t_sigs[..., None] >> bits) & 1
    jb = (j_sigs[..., None] >> bits) & 1
    assert safe.mean() > 0.99
    np.testing.assert_array_equal(tb[safe], jb[safe])


@pytest.mark.parametrize("rerank", [0, 20])
def test_lsh_search_matches_jax_popcount(lsh_setup, rerank):
    """With JAX's planes and JAX's packed signatures injected, search equals
    the JAX popcount form exactly: distances and indices, ties included."""
    emb, q, planes, j_index = lsh_setup
    proj = q.astype(np.float64) @ planes.transpose(1, 0, 2).reshape(16, -1)
    assert np.abs(proj).min() > 1e-5          # query bits are unambiguous
    j_index.rerank = rerank
    jd, ji = map(np.asarray, j_index.search(jnp.asarray(q), 12))
    t_index = t_lsh.LSHIndex(16, 64, 4, rerank=rerank, planes=planes, device="cpu")
    t_index.build(emb)
    t_index._sigs = torch.from_numpy(np.array(j_index._sigs).view(np.int32))
    td, ti = (t.numpy() for t in t_index.search(q, 12))
    np.testing.assert_array_equal(ti, ji)
    if rerank:
        np.testing.assert_allclose(td, jd, atol=1e-5)
    else:
        np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("rerank,k", [(0, 12), (20, 12), (5, 12), (0, 120)])
def test_lsh_matmul_form_matches_popcount_and_jax(lsh_setup, rerank, k):
    """The ±1 form: ids and distances equal to the port's popcount form and
    to JAX's matmul form on the same planes, with and without rerank, with
    ``k`` above the shortlist (rerank 5) and at the corpus size."""
    emb, q, planes, _ = lsh_setup
    j_index = j_lsh.LSHIndex(16, 64, 4, seed=0, use_pallas=False, hamming_impl="matmul",
                             rerank=rerank)
    j_index.planes = jnp.asarray(planes)
    j_index.build(jnp.asarray(emb))
    jd, ji = map(np.asarray, j_index.search(jnp.asarray(q), k))
    out = {}
    for impl in ("matmul", "popcount"):
        t_index = t_lsh.LSHIndex(16, 64, 4, rerank=rerank, planes=planes, device="cpu",
                                 hamming_impl=impl)
        t_index.build(emb)
        assert (t_index._sigs_pm is not None) == (impl == "matmul")
        out[impl] = [t.numpy() for t in t_index.search(q, k)]
    (md, mi), (pd, pi) = out["matmul"], out["popcount"]
    np.testing.assert_array_equal(mi, pi)
    np.testing.assert_array_equal(md, pd)
    np.testing.assert_array_equal(mi, ji)
    if rerank:
        np.testing.assert_allclose(md, jd, atol=1e-5)
    else:
        assert md.dtype == np.int32
        np.testing.assert_array_equal(md, jd)


def test_lsh_unpack_pm_matches_jax(lsh_setup):
    """±1 bf16 [T, N, B] signatures bitwise as JAX's, from the same packed
    words; chunked over rows."""
    _, _, _, j_index = lsh_setup
    ref = np.asarray(j_lsh._unpack_pm(j_index._sigs).astype(jnp.float32))
    sigs = torch.from_numpy(np.array(j_index._sigs).view(np.int32))
    got = t_lsh._unpack_pm(sigs, rows=7)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_lsh_hamming_impl_from_environment(monkeypatch):
    monkeypatch.setenv("MRE_LSH_IMPL", "matmul")
    assert t_lsh.LSHIndex(8, 32, 2, device="cpu").hamming_impl == "matmul"
    monkeypatch.delenv("MRE_LSH_IMPL")
    assert t_lsh.LSHIndex(8, 32, 2, device="cpu").hamming_impl == "popcount"
    with pytest.raises(ValueError, match="hamming_impl"):
        t_lsh.LSHIndex(8, 32, 2, device="cpu", hamming_impl="bogus")


def test_benchmark_search_methods_matches_jax():
    """The same result keys and the same recall@10 per method, given JAX's
    hyperplanes and k-means initial rows."""
    import jax

    from movie_recommendation_engine_tpu import small_test_config
    from movie_recommendation_engine_tpu.retrieval import bench as j_bench
    from movie_recommendation_engine_tpu_torch.retrieval import bench as t_bench

    rng = np.random.default_rng(6)
    emb = _unit_rows(rng, 400, 16)
    q = emb[rng.choice(400, 24, replace=False)]
    cfg = small_test_config()
    methods = ["exact", "lsh", "lsh_rerank", "ivf"]
    ref = j_bench.benchmark_search_methods(jnp.asarray(emb), jnp.asarray(q), k=10,
                                           methods=methods, cfg=cfg, repeats=1)
    planes = np.asarray(j_lsh.LSHIndex(16, 64, 4, seed=0, use_pallas=False).planes)
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(0), 400, shape=(8,),
                                        replace=False))
    got = t_bench.benchmark_search_methods(emb, q, k=10, methods=methods, cfg=cfg,
                                           repeats=1, device="cpu", planes=planes,
                                           init_idx=init)
    assert list(got) == list(ref) == methods
    for m in methods:
        assert set(got[m]) == set(ref[m]), m
        assert got[m]["method"] == ref[m]["method"] and got[m]["index_size"] == 400
        assert got[m]["indices"].shape == (24, 10)
        if m != "exact":
            assert got[m]["recall"] == pytest.approx(ref[m]["recall"], abs=1e-12), m
    assert got["lsh_rerank"]["recall"] > got["lsh"]["recall"]


def test_evaluate_embeddings_matches_jax():
    """HR@k within 0.01 and MRR within 1%. A rank can move by one: both
    packages compare the matmul row against an elementwise gt similarity, so
    the ground truth counts against itself wherever the matmul rounds its
    own entry up, and the two frameworks round differently. The flips are
    symmetric noise, so the metrics agree over enough pairs."""
    rng = np.random.default_rng(2)
    emb = _unit_rows(rng, 300, 16)
    pairs = rng.integers(0, 300, (2000, 2))
    pairs[:3] = [[-1, 2], [4, 300], [5, 5]]                 # two dropped
    ref = j_metrics.evaluate_embeddings(jnp.asarray(emb), pairs)
    got = t_metrics.evaluate_embeddings(torch.from_numpy(emb), pairs)
    assert got["num_pairs"] == ref["num_pairs"] == 1998
    for key in ref:
        if key.startswith("hit_rate"):
            assert abs(got[key] - ref[key]) <= 0.01, key
    assert got["mrr"] == pytest.approx(ref["mrr"], rel=0.01)
    assert got["mrr_standard"] == pytest.approx(ref["mrr_standard"], rel=0.01)


def test_recommend_matches_jax():
    rng = np.random.default_rng(3)
    emb = _unit_rows(rng, 80, 8)
    qi = np.array([0, 5, 79], np.int32)
    js, jidx = j_metrics.recommend(jnp.asarray(emb), jnp.asarray(qi), k=6)
    ts, tidx = t_metrics.recommend(torch.from_numpy(emb), torch.from_numpy(qi).long(), k=6)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    assert not (tidx.numpy() == qi[:, None]).any()


@pytest.mark.parametrize("method", ["exact", "lsh", "lsh_rerank", "ivf"])
def test_batching_server_concurrent_requests(method):
    """More client threads than cores, a short switch interval, by-item and
    by-history requests at once: every answer excludes its query items and
    equals a direct search of the same index."""
    from movie_recommendation_engine_tpu_torch import small_test_config

    rng = np.random.default_rng(4)
    emb = _unit_rows(rng, 200, 32)
    server = BatchingRecommender(emb, method=method, cfg=small_test_config(),
                                 max_batch=8, max_wait_ms=1.0, max_k=20,
                                 device="cpu")
    results, errors = {}, []
    old = sys.getswitchinterval()

    def client(c):
        try:
            for r in range(4):
                if (c + r) % 2:
                    results[(c, r)] = ("item", c, server.recommend_by_item(c, k=5))
                else:
                    hist = [c, (c + 7) % 200, (c + 31) % 200]
                    results[(c, r)] = ("hist", hist, server.recommend_by_history(hist, k=5))
        except Exception as e:  # reported below
            errors.append(e)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        server.close()
    assert not errors and len(results) == 96
    for kind, query, out in results.values():
        idx = out["indices"]
        assert len(idx) == 5
        if kind == "item":
            assert query not in idx
            d, i = server.index.search(emb[query][None], k=server._search_k)
            direct = [j for j in i[0].tolist() if j != query][:5]
            assert idx == direct
        else:
            assert not set(query) & set(idx)
    stats = server.stats()
    assert stats["num_requests"] == 96 and stats["num_batches"] < 96


def _cli_sets(tmp_path):
    return ["--set=data.source=synthetic", "--set=data.synthetic_num_movies=120",
            "--set=data.synthetic_num_users=200", "--set=data.synthetic_num_ratings=3000",
            "--set=features.feature_dim=16", "--set=model.hidden_dim=32",
            "--set=model.embed_dim=16", "--set=walk.num_walks=10",
            "--set=walk.num_neighbors=6", "--set=search.lsh_bits=64",
            "--set=search.lsh_tables=2", "--set=search.ivf_partitions=6",
            "--set=train.epochs=1", "--set=train.batch_size=32",
            "--set=train.num_negative_samples=16", "--set=train.max_pairs_per_epoch=64",
            f"--set=paths.output_dir={tmp_path}", f"--set=paths.checkpoint_dir={tmp_path}"]


def test_cli_benchmark_and_all_on_cpu(tmp_path, capsys):
    from movie_recommendation_engine_tpu_torch.cli.main import main

    sets = _cli_sets(tmp_path)
    assert main(["benchmark", "--device", "cpu", "--num-queries", "16", *sets]) == 0
    out = capsys.readouterr().out
    for name in ("Exact (Brute Force)", "Locality-Sensitive Hashing",
                 "LSH + exact rerank (fused shortlist)", "Weak AND (IVF)"):
        assert name in out
    assert out.count("recall@10") == 3
    assert main(["all", "--device", "cpu", "--k", "4", *sets]) == 0
    out = capsys.readouterr().out
    assert "Top-4 recommendations (exact)" in out
    assert (tmp_path / "last_model.npz").exists()
    assert (tmp_path / "movie_embeddings.npz").exists()


@pytest.mark.parametrize("mode", ["tune", "demo", "download"])
def test_cli_unported_modes_exit(mode):
    from movie_recommendation_engine_tpu_torch.cli.main import main

    with pytest.raises(SystemExit, match="not ported: tune, demo, download") as e:
        main([mode, "--device", "cpu"])
    assert e.value.code != 0
