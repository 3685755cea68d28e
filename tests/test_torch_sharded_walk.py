"""PyTorch port, row-sharded CSR walks and PPR against the JAX package.

JAX's ``sharded_walk`` runs in this process on the virtual mesh ((4, 2):
two shards); the port runs in four spawned gloo processes, on a model axis
of four ranks ((1, 4)) and of two ((2, 2)). Tolerances, each with its
reason:

- walks, neighborhood tables and the trainer's refreshed tables: exact (the
  same uniforms search the same cumprob values on whichever rank owns a
  node, so every hop is the replicated one);
- PPR scores: 1e-5 absolute against JAX's sharded and the port's replicated
  scores (the ranks' pushes are summed in another order), a trainer's PPR
  tables by the weights within 1e-5 and the ids except at near-ties.
"""

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch.parallel import mesh as t_mesh

N, E = 203, 2000


def _csr(csr_module=None):
    if csr_module is None:
        from movie_recommendation_engine_tpu_torch.graph import csr as csr_module

    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    w = rng.random(E).astype(np.float32) + 0.05
    keep = src % 97 != 0            # a few isolated nodes: halted walkers
    return csr_module.csr_from_edge_index(np.stack([src[keep], dst[keep]]), w[keep],
                                          num_nodes=N)


def _worker(rank, world, tmp):
    from movie_recommendation_engine_tpu_torch import small_test_config
    from movie_recommendation_engine_tpu_torch.graph import dataset
    from movie_recommendation_engine_tpu_torch.sampling import ppr
    from movie_recommendation_engine_tpu_torch.sampling import random_walk as rw
    from movie_recommendation_engine_tpu_torch.sampling import sharded_walk as sw
    from movie_recommendation_engine_tpu_torch.train.trainer import Trainer

    t_mesh.distributed_init(backend="gloo", init_method=f"file://{tmp}/pg",
                            world_size=world, rank=rank, init_timeout_s=60)
    torch.set_num_threads(2)
    inp = dict(np.load(f"{tmp}/inputs.npz"))
    csr = _csr()
    rep = rw.device_graph(csr, "cpu")
    out = {}
    for name, shape in (("m4", (1, 4)), ("m2", (2, 2))):
        mesh = t_mesh.make_mesh(shape)
        g = sw.sharded_device_graph(csr, t_mesh.axis_group(mesh, "model"), "cpu")
        out[f"{name}_held"] = [g.start, g.rows, g.local.indices.numel(), g.num_nodes]
        starts = torch.from_numpy(inp["starts"])
        out[f"{name}_walks"] = sw.sharded_random_walks(
            g, starts, 11, 3, int(inp["iters"]), uniforms=torch.from_numpy(inp["u"])).numpy()
        gen_a = torch.Generator().manual_seed(9)
        gen_b = torch.Generator().manual_seed(9)
        a = rw.all_node_neighborhood_tables(g, 2, 10, 2, 5, int(inp["iters"]),
                                            generator=gen_a, batch=64)
        b = rw.all_node_neighborhood_tables(rep, 2, 10, 2, 5, int(inp["iters"]),
                                            generator=gen_b, batch=64)
        out[f"{name}_tables_equal"] = all(torch.equal(x, y) for ta, tb in zip(a, b)
                                          for x, y in zip(ta, tb))
        out[f"{name}_ppr"] = sw.sharded_ppr_scores(
            g, torch.from_numpy(inp["sources"]), N, num_iterations=6).numpy()
    out["ppr_rep"] = ppr.ppr_scores(rep, torch.from_numpy(inp["sources"]), N,
                                    num_iterations=6).numpy()

    # The trainer on (2, 2): the CSR split over the model axis, its tables
    # (walks and PPR) against the single-device trainer's.
    cfg = small_test_config().override({"mesh.shard_tables": True})
    data = dataset.load(cfg)
    cfg.mesh.mesh_shape = (2, 2)
    for strategy in ("random_walk", "ppr"):
        c = cfg.override({"walk.strategy": strategy, "walk.ppr_batch": 64})
        c.mesh.mesh_shape = (2, 2)
        tr = Trainer(c, data, device="cpu")
        out[f"tr_{strategy}_sharded"] = isinstance(tr.graph, sw.ShardedDeviceGraph)
        tr.generator.manual_seed(4)
        tr.refresh_neighborhoods()
        out[f"tr_{strategy}_rows"] = [tr.shard.start, tr.shard.stop]
        for i, (nb, w) in enumerate(tr.nbr_tables):
            out[f"tr_{strategy}_nbrs{i}"], out[f"tr_{strategy}_w{i}"] = nb.numpy(), w.numpy()
    np.savez(f"{tmp}/rank{rank}.npz", **{k: np.asarray(v) for k, v in out.items()})
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def walk_run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from movie_recommendation_engine_tpu.graph import csr as j_csr
    from movie_recommendation_engine_tpu.parallel import mesh as j_mesh
    from movie_recommendation_engine_tpu.sampling import ppr as j_ppr
    from movie_recommendation_engine_tpu.sampling import random_walk as j_rw
    from movie_recommendation_engine_tpu.sampling import sharded_walk as j_sw

    tmp = tmp_path_factory.mktemp("walk")
    csr = _csr()
    jc = _csr(j_csr)
    g_sh = j_sw.sharded_device_graph(jc, j_mesh.make_mesh((4, 2)), axis="model")
    iters = j_rw.search_iters(jc)
    starts = np.random.default_rng(1).integers(0, N, 64).astype(np.int32)
    key = jax.random.PRNGKey(7)
    u = np.stack([np.asarray(jax.random.uniform(k, (64 * 11,)))
                  for k in jax.random.split(key, 3)])
    sources = np.array([0, 3, 50, 199], np.int32)
    ref = {"walks": np.asarray(j_rw.random_walks(g_sh, jnp.asarray(starts), key, 11, 3, iters)),
           "ppr": np.asarray(j_ppr.ppr_scores(g_sh, jnp.asarray(sources), N,
                                              num_iterations=6))}
    np.savez(tmp / "inputs.npz", starts=starts, u=u, iters=iters, sources=sources)
    t_mesh.run_local(_worker, 4, str(tmp), timeout=120)
    return csr, ref, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def single_device_tables():
    """The single-device port trainer's tables from the same generator seed
    (random walks) and its PPR tables."""
    from movie_recommendation_engine_tpu_torch import small_test_config
    from movie_recommendation_engine_tpu_torch.graph import dataset
    from movie_recommendation_engine_tpu_torch.train.trainer import Trainer

    out = {}
    for strategy in ("random_walk", "ppr"):
        cfg = small_test_config().override({"walk.strategy": strategy, "walk.ppr_batch": 64})
        tr = Trainer(cfg, dataset.load(cfg), device="cpu")
        tr.generator.manual_seed(4)
        tr.refresh_neighborhoods()
        out[strategy] = [(nb.numpy(), w.numpy()) for nb, w in tr.nbr_tables]
    return out


@pytest.mark.parametrize("name,size", [("m4", 4), ("m2", 2)])
def test_sharded_walks_bit_identical_to_jax_and_replicated(walk_run, name, size):
    csr, ref, ranks = walk_run
    for out in ranks:
        np.testing.assert_array_equal(out[f"{name}_walks"], ref["walks"])
        assert (out[f"{name}_walks"] == N).any()          # some walks halted
        assert bool(out[f"{name}_tables_equal"])


@pytest.mark.parametrize("name,size", [("m4", 4), ("m2", 2)])
def test_each_rank_holds_only_its_slice_of_the_csr(walk_run, name, size):
    csr, _, ranks = walk_run
    c = -(-N // size)
    for r, out in enumerate(ranks):
        s = r % size
        r0, r1 = min(s * c, N), min((s + 1) * c, N)
        start, rows, edges, total = out[f"{name}_held"].tolist()
        assert (start, rows, total) == (s * c, c, N)
        assert edges == csr.indptr[r1] - csr.indptr[r0] < csr.num_edges


@pytest.mark.parametrize("name", ["m4", "m2"])
def test_sharded_ppr_matches_jax_and_replicated(walk_run, name):
    _, ref, ranks = walk_run
    for out in ranks:
        np.testing.assert_allclose(out[f"{name}_ppr"], ref["ppr"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(out[f"{name}_ppr"], out["ppr_rep"], atol=1e-5, rtol=0)
        assert (out[f"{name}_ppr"].sum(axis=1) <= 1.0 + 1e-5).all()


def test_trainer_walk_tables_on_a_sharded_graph_equal_single_device(walk_run,
                                                                     single_device_tables):
    _, _, ranks = walk_run
    for out in ranks:
        assert bool(out["tr_random_walk_sharded"])
        r0, r1 = out["tr_random_walk_rows"].tolist()
        for i, (nb, w) in enumerate(single_device_tables["random_walk"]):
            np.testing.assert_array_equal(out[f"tr_random_walk_nbrs{i}"], nb[r0:r1])
            np.testing.assert_array_equal(out[f"tr_random_walk_w{i}"], w[r0:r1])


def test_trainer_ppr_tables_on_a_sharded_graph_match_single_device(walk_run,
                                                                    single_device_tables):
    _, _, ranks = walk_run
    for out in ranks:
        assert bool(out["tr_ppr_sharded"])
        r0, r1 = out["tr_ppr_rows"].tolist()
        for i, (nb, w) in enumerate(single_device_tables["ppr"]):
            got_nb, got_w = out[f"tr_ppr_nbrs{i}"], out[f"tr_ppr_w{i}"]
            np.testing.assert_allclose(got_w, w[r0:r1], atol=1e-5, rtol=0)
            # Ids agree except where two ranked weights are within 1e-6.
            wr = w[r0:r1]
            near = np.zeros_like(wr, bool)
            near[:, 1:] |= np.abs(np.diff(wr, axis=1)) < 1e-6
            near[:, :-1] |= np.abs(np.diff(wr, axis=1)) < 1e-6
            assert ((got_nb == nb[r0:r1]) | near).all()
