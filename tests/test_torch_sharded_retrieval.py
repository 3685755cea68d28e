"""PyTorch port, distributed retrieval against the JAX package.

JAX's ``retrieval/sharded.py`` runs in this process on the virtual mesh
((2, 4): four shards); the port runs in four spawned gloo processes, the
corpus split over all four ranks. Tolerances, each with its reason:

- ids: exact, in ``lax.top_k``'s tie order (the corpus repeats rows, so
  equal scores occur and the lower global id must come first);
- scores and distances: 1e-5 absolute (the same f32 products, summed per
  rank);
- ``sharded_kmeans`` from JAX's initial rows: centroids 1e-5, assignments
  exact (separated clusters);
- IVF with every list probed against exact search: ids exact except where
  two distances lie within 1e-6.
"""

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch.parallel import mesh as t_mesh


def _corpus(n=103, d=16, seed=2):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb[40:44] = emb[10]                      # exact ties: lower id first
    q = np.concatenate([emb[[10, 3, 77]], rng.standard_normal((5, d)).astype(np.float32)])
    return emb, q


def _worker(rank, world, tmp):
    from movie_recommendation_engine_tpu_torch.retrieval import sharded
    from movie_recommendation_engine_tpu_torch.retrieval.bench import benchmark_search_methods

    t_mesh.distributed_init(backend="gloo", init_method=f"file://{tmp}/pg",
                            world_size=world, rank=rank, init_timeout_s=60)
    torch.set_num_threads(2)
    group = torch.distributed.group.WORLD
    inp = dict(np.load(f"{tmp}/inputs.npz"))
    out = {}
    emb, q = _corpus()
    for name, (e, qq, k) in {"sim": (emb, q, 9), "sim_k_gt_chunk": (emb[:16], q, 6),
                             "sim_negative": (inp["pos"], -inp["pos"][:3], 5)}.items():
        rows, n = sharded.shard_embeddings(e, group, "cpu")
        s, i = sharded.sharded_similarity_topk(group, rows, torch.from_numpy(qq), k,
                                               valid_rows=n)
        out[f"{name}_s"], out[f"{name}_i"] = s.numpy(), i.numpy()
    idx = sharded.ShardedExactIndex(16, device="cpu")
    idx.build(emb)
    out["exact_d"], out["exact_i"] = (t.numpy() for t in idx.search(q, k=9))
    out["exact_rows"] = idx._emb.shape[0]

    xk = inp["km_x"]
    rows, n = sharded.shard_embeddings(xk, group, "cpu")
    c, a = sharded.sharded_kmeans(group, rows, torch.from_numpy(xk[inp["km_init"]]), n)
    out["km_c"] = c.numpy()
    out["km_a"] = a.numpy()

    ivf = sharded.ShardedIVFIndex(16, num_partitions=12, nprobe=5, seed=0,
                                  balance_factor=4.0, device="cpu", init_idx=inp["ivf_init"])
    ivf.build(inp["ivf_x"])
    out["ivf_d"], out["ivf_i"] = (t.numpy() for t in ivf.search(inp["ivf_q"], k=9))
    out["ivf_rows"] = ivf._emb.shape[0]
    full = sharded.ShardedIVFIndex(16, num_partitions=8, nprobe=8, device="cpu")
    full.build(emb)
    out["ivf_full_d"], out["ivf_full_i"] = (t.numpy() for t in full.search(q, k=6))

    res = benchmark_search_methods(emb, q, k=5, methods=["exact", "sharded_exact",
                                                         "sharded_ivf"],
                                   repeats=1, device="cpu")
    out["bench_recall"] = [res["sharded_exact"]["recall"], res["sharded_ivf"]["recall"]]
    out["bench_size"] = [res[m]["index_size"] for m in ("sharded_exact", "sharded_ivf")]
    np.savez(f"{tmp}/rank{rank}.npz", **{k: np.asarray(v) for k, v in out.items()})
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def retrieval_run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from movie_recommendation_engine_tpu.parallel import mesh as j_mesh
    from movie_recommendation_engine_tpu.retrieval import sharded as j_sh

    tmp = tmp_path_factory.mktemp("retrieval")
    mesh = j_mesh.make_mesh((2, 4))
    emb, q = _corpus()
    rng = np.random.default_rng(3)
    pos = np.abs(rng.standard_normal((18, 16))).astype(np.float32) + 0.1
    ref = {}
    for name, (e, qq, k) in {"sim": (emb, q, 9), "sim_k_gt_chunk": (emb[:16], q, 6),
                             "sim_negative": (pos, -pos[:3], 5)}.items():
        rows, n = j_sh.shard_embeddings(mesh, e)
        s, i = j_sh.sharded_similarity_topk(mesh, rows, jnp.asarray(qq), k, valid_rows=n)
        ref[f"{name}_s"], ref[f"{name}_i"] = np.asarray(s), np.asarray(i)
    idx = j_sh.ShardedExactIndex(16, mesh=mesh)
    idx.build(emb)
    ref["exact_d"], ref["exact_i"] = (np.asarray(t) for t in idx.search(q, k=9))

    # The JAX package's separated-clusters case (test_sharded_retrieval.py).
    p_km, n_km = 4, 96
    km_rng = np.random.default_rng(8)
    centers = km_rng.standard_normal((p_km, 8)).astype(np.float32) * 20.0
    km_x = (centers[np.arange(n_km) % p_km]
            + km_rng.standard_normal((n_km, 8)).astype(np.float32) * 0.1)
    km_init = np.asarray(jax.random.choice(jax.random.PRNGKey(0), n_km, shape=(p_km,),
                                           replace=False))
    rows, _ = j_sh.shard_embeddings(mesh, km_x)
    c, a = j_sh.sharded_kmeans(mesh, rows, jnp.asarray(km_x[km_init]), valid_rows=n_km)
    ref["km_c"], ref["km_a"] = np.asarray(c), np.asarray(a)[:n_km]

    n_ivf = 237
    ivf_x = rng.standard_normal((n_ivf, 16)).astype(np.float32)
    ivf_x[:80] += 2.0                            # uneven lists
    ivf_q = np.concatenate([ivf_x[rng.choice(n_ivf, 5, replace=False)],
                            rng.standard_normal((3, 16)).astype(np.float32)])
    ivf = j_sh.ShardedIVFIndex(16, mesh=mesh, num_partitions=12, nprobe=5, seed=0,
                               balance_factor=4.0)
    ivf.build(ivf_x)
    ref["ivf_d"], ref["ivf_i"] = (np.asarray(t) for t in ivf.search(ivf_q, k=9))
    ivf_init = np.asarray(jax.random.choice(jax.random.PRNGKey(0), n_ivf, shape=(12,),
                                            replace=False))
    np.savez(tmp / "inputs.npz", pos=pos, km_x=km_x, km_init=km_init, ivf_x=ivf_x,
             ivf_q=ivf_q, ivf_init=ivf_init)
    t_mesh.run_local(_worker, 4, str(tmp), timeout=120)
    return ref, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("name", ["sim", "sim_k_gt_chunk", "sim_negative"])
def test_sharded_similarity_topk_matches_jax(retrieval_run, name):
    ref, ranks = retrieval_run
    for out in ranks:
        np.testing.assert_array_equal(out[f"{name}_i"], ref[f"{name}_i"])
        np.testing.assert_allclose(out[f"{name}_s"], ref[f"{name}_s"], atol=1e-5, rtol=0)
    if name == "sim_negative":
        # Every real score is negative; the zero padding rows never win.
        assert (ranks[0][f"{name}_s"] < 0).all() and (ranks[0][f"{name}_i"] < 18).all()


def test_sharded_exact_index_matches_jax_and_exact_search(retrieval_run):
    from movie_recommendation_engine_tpu_torch.retrieval.exact import ExactIndex

    ref, ranks = retrieval_run
    emb, q = _corpus()
    ex = ExactIndex(16, device="cpu")
    ex.build(emb)
    ed, ei = (t.numpy() for t in ex.search(q, k=9))
    for out in ranks:
        assert out["exact_rows"] == 26                  # ceil(103 / 4): no rank holds all
        np.testing.assert_array_equal(out["exact_i"], ref["exact_i"])
        np.testing.assert_array_equal(out["exact_i"], ei)
        np.testing.assert_allclose(out["exact_d"], ref["exact_d"], atol=1e-5, rtol=0)
    assert ranks[0]["exact_i"][0][:5].tolist() == [10, 40, 41, 42, 43]   # ties: lower id


def test_sharded_kmeans_from_init_idx_matches_jax(retrieval_run):
    ref, ranks = retrieval_run
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["km_c"], ref["km_c"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(out["km_a"], ref["km_a"][24 * r:24 * r + 24])


def test_sharded_ivf_matches_jax(retrieval_run):
    ref, ranks = retrieval_run
    for out in ranks:
        assert out["ivf_rows"] < 237
        np.testing.assert_array_equal(out["ivf_i"], ref["ivf_i"])
        np.testing.assert_allclose(out["ivf_d"], ref["ivf_d"], atol=1e-4, rtol=1e-5)


def test_sharded_ivf_probing_every_list_is_exact_search(retrieval_run):
    from movie_recommendation_engine_tpu_torch.retrieval.exact import ExactIndex

    _, ranks = retrieval_run
    emb, q = _corpus()
    ex = ExactIndex(16, device="cpu")
    ex.build(emb)
    ed, ei = (t.numpy() for t in ex.search(q, k=6))
    for out in ranks:
        np.testing.assert_allclose(out["ivf_full_d"], ed, atol=1e-4, rtol=1e-5)
        same = out["ivf_full_i"] == ei
        near = np.abs(np.diff(ed, axis=1, prepend=-np.inf)) < 1e-6
        near |= np.abs(np.diff(ed, axis=1, append=np.inf)) < 1e-6
        assert (same | near).all()


def test_benchmark_runs_the_sharded_methods_on_every_rank(retrieval_run):
    _, ranks = retrieval_run
    for out in ranks:
        assert out["bench_recall"][0] == 1.0 and out["bench_recall"][1] > 0.5
        assert out["bench_size"].tolist() == [103, 103]


def test_balance_assignments_bounded_matches_jax():
    from movie_recommendation_engine_tpu.retrieval.sharded import (
        balance_assignments_bounded as j_balance)
    from movie_recommendation_engine_tpu_torch.retrieval.ivf import (
        balance_assignments, kmeans)
    from movie_recommendation_engine_tpu_torch.retrieval.sharded import (
        balance_assignments_bounded)

    rng = np.random.default_rng(9)
    x = rng.standard_normal((150, 8)).astype(np.float32)
    x[:90] += 3.0                                    # one overfull region
    c, a = kmeans(torch.from_numpy(x), 6, seed=1)
    c, a = c.numpy(), a.numpy()
    got = balance_assignments_bounded(x, c, a.copy(), 30)
    np.testing.assert_array_equal(got, j_balance(x, c, a.copy(), 30))
    np.testing.assert_array_equal(got, balance_assignments(x, c, a.copy(), 30))
    assert np.bincount(got, minlength=6).max() <= 30


@pytest.mark.parametrize("method", ["sharded_exact", "sharded_ivf"])
def test_server_and_make_index_over_a_sharded_index_in_one_process(method):
    from movie_recommendation_engine_tpu_torch import small_test_config
    from movie_recommendation_engine_tpu_torch.retrieval.bench import NAMES, make_index
    from movie_recommendation_engine_tpu_torch.retrieval.server import BatchingRecommender

    assert method in NAMES
    cfg = small_test_config()
    index = make_index(method, 8, cfg, device="cpu")
    assert index.group is None                       # no process group: a world of one
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((90, 8)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    rec = BatchingRecommender(emb, method=method, cfg=cfg.override(
        {"search.ivf_nprobe": 8}), max_batch=4, max_k=8, device="cpu")
    try:
        out = rec.recommend_by_item(7, k=4)
        dense = ((emb[7][None, :] - emb) ** 2).sum(axis=1)
        assert out["indices"] == [int(i) for i in np.argsort(dense) if i != 7][:4]
    finally:
        rec.close()


def test_benchmark_cli_with_a_sharded_method(tmp_path, capsys):
    from movie_recommendation_engine_tpu_torch.cli.main import main

    over = ["--set", "data.source=synthetic", "--set", "data.synthetic_num_movies=120",
            "--set", "data.synthetic_num_users=200", "--set", "data.synthetic_num_ratings=3000",
            "--set", "search.ivf_partitions=8", "--set", "search.search_method=sharded_ivf",
            "--set", f"paths.checkpoint_dir={tmp_path}/ck",
            "--set", f"paths.output_dir={tmp_path}/out"]
    assert main(["benchmark", "--device", "cpu", "--num-queries", "16", *over]) == 0
    text = capsys.readouterr().out
    assert "Weak AND (IVF, row-sharded over the process group)" in text
