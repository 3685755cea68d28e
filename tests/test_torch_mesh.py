"""PyTorch port, the mesh and its collectives against the JAX package.

The JAX side runs in this process on the 8-device virtual CPU mesh; the
port runs in four spawned processes joined in a gloo group (``file://``
rendezvous under ``tmp_path``, 60 s timeout; the spawn is killed past 120
s). Tolerances, each with its reason:

- ``sharded_gather``, ``ring_shift``, the mesh's axes and the autograd
  collectives' values and gradients: exact (a masked gather adds one row to
  zeros; the others move or sum small integers);
- ``make_sharded_train_step`` and ``sharded_embed_fn`` against JAX's, f32:
  loss 1e-5 relative, parameters 1e-5 absolute after one Adam step at lr
  1e-3 (f32 sums in another order across ranks), embeddings 1e-5.
"""

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch.parallel import mesh as t_mesh


def _worker(rank, world, tmp):
    """One rank: joins the group, runs every check, writes its results."""
    from movie_recommendation_engine_tpu_torch.core import tree
    from movie_recommendation_engine_tpu_torch.core.checkpoint import params_from_jax
    from movie_recommendation_engine_tpu_torch.parallel import collectives as coll
    from movie_recommendation_engine_tpu_torch.parallel import sharding
    from movie_recommendation_engine_tpu_torch.train import optim

    first = t_mesh.distributed_init(backend="gloo", init_method=f"file://{tmp}/pg",
                                    world_size=world, rank=rank, init_timeout_s=60)
    torch.set_num_threads(2)
    inp = dict(np.load(f"{tmp}/inputs.npz"))
    out = {"init": [first, t_mesh.distributed_init(), torch.distributed.get_rank(),
                    torch.distributed.get_world_size()]}
    mesh22, mesh14 = t_mesh.make_mesh((2, 2)), t_mesh.make_mesh((1, 4))
    out["axes"] = [t_mesh.axis_size(mesh22, "data"), t_mesh.axis_size(mesh22, "model"),
                   t_mesh.axis_index(mesh22, "data"), t_mesh.axis_index(mesh22, "model")]
    g4 = t_mesh.axis_group(mesh14, "model")

    table = torch.from_numpy(inp["table"])
    c = table.shape[0] // world
    out["gather"] = coll.sharded_gather(table[rank * c:(rank + 1) * c],
                                        torch.from_numpy(inp["idx"]), g4).numpy()
    out["ring"] = coll.ring_shift(torch.from_numpy(inp["ring"][rank]), g4).numpy()
    own = torch.from_numpy(inp["own_ids"][rank])
    out["rows"] = coll.sharded_rows(table[rank * c:(rank + 1) * c], own, g4).numpy()
    for dtype in (torch.bfloat16, torch.float8_e4m3fn):   # slab dtypes, gathered as bits
        t8 = table.to(dtype)
        got = coll.sharded_rows(t8[rank * c:(rank + 1) * c], own, g4)
        out[f"rows_{dtype}"] = [got.dtype == dtype, torch.equal(
            got.view(torch.uint8 if dtype.itemsize == 1 else torch.int16),
            t8.view(torch.uint8 if dtype.itemsize == 1 else torch.int16)[own.long()])]

    # Autograd collectives: rank r's loss is (r + 1) * sum(output).
    base = torch.from_numpy(inp["base"])
    sizes = [3, 0, 2, 1]
    start = sum(sizes[:rank])
    x = base[start:start + sizes[rank]].clone().requires_grad_()
    y = coll.all_gather_rows(x, g4, sizes)
    ((rank + 1) * y.sum()).backward()
    out["ag"], out["ag_grad"] = y.detach().numpy(), x.grad.numpy()
    x = (base * (rank + 1)).requires_grad_()
    y = coll.all_reduce_sum(x, g4)
    ((rank + 1) * y.sum()).backward()
    out["ar"], out["ar_grad"] = y.detach().numpy(), x.grad.numpy()

    # The sharded step and embedding pass on (2, 2), tables row-sharded.
    flat = {k[len("params/"):]: v for k, v in inp.items() if k.startswith("params/")}
    params = params_from_jax(flat, "cpu")
    shard = t_mesh.row_shard(mesh22, inp["x"].shape[0])
    mine = slice(shard.start, shard.stop)
    x_t = torch.from_numpy(inp["x"][mine])
    nbrs, w = torch.from_numpy(inp["nbrs"][mine]), torch.from_numpy(inp["w"][mine])
    scfg = sharding.ShardedStepConfig(loss="max_margin", valid_limit=inp["x"].shape[0],
                                      dtype=torch.float32)
    step = sharding.make_sharded_train_step(mesh22, scfg, shard)
    for name, mats in (("gather", ()), ("hybrid", (torch.from_numpy(inp["a0"][mine]),))):
        start = tree.map_tree(torch.clone, params)     # Adam updates in place
        p2, _, loss = step(start, optim.adam_init(start), x_t, [nbrs, nbrs], [w, w], mats,
                           *(torch.from_numpy(inp[k]) for k in ("q", "p", "rn")), None, 1e-3)
        out[f"step_{name}_loss"] = float(loss)
        for k, v in tree.flatten(p2).items():
            out[f"step_{name}/{k}"] = v.numpy()
    embed = sharding.sharded_embed_fn(mesh22, scfg, shard)
    a = torch.from_numpy(inp["a0"][mine])
    rows = embed(params, x_t, [nbrs, nbrs], [w, w], (a, a))
    out["embed_rows"] = rows.numpy()
    out["embed"] = coll.all_gather_rows(rows, shard.group).numpy()
    np.savez(f"{tmp}/rank{rank}.npz", **{k: np.asarray(v) for k, v in out.items()})
    torch.distributed.destroy_process_group()


def _sleeper(rank, world, seconds):
    import time

    time.sleep(seconds)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """JAX's collectives, sharded step and embedding pass on the virtual
    mesh, and the port's on four gloo ranks, from the same numpy inputs."""
    import jax
    import jax.numpy as jnp

    from movie_recommendation_engine_tpu.core.checkpoint import _flatten
    from movie_recommendation_engine_tpu.models import pinsage as j_ps
    from movie_recommendation_engine_tpu.parallel import collectives as j_coll
    from movie_recommendation_engine_tpu.parallel import mesh as j_mesh
    from movie_recommendation_engine_tpu.parallel.sharding import (
        ShardedStepConfig, make_sharded_train_step, sharded_embed_fn)
    from movie_recommendation_engine_tpu.train import optim as j_optim

    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    inp = {"table": rng.standard_normal((16, 8)).astype(np.float32),
           "idx": np.array([0, 3, 7, 8, 15, 9, 4], np.int32),
           "ring": rng.standard_normal((4, 3, 5)).astype(np.float32),
           "own_ids": rng.integers(0, 16, (4, 5)).astype(np.int32),
           "base": rng.integers(-9, 9, (8, 3)).astype(np.float32)}
    mesh24 = j_mesh.make_mesh((2, 4))
    ref = {"gather": np.asarray(j_coll.sharded_gather(mesh24, jnp.asarray(inp["table"]),
                                                      jnp.asarray(inp["idx"]))),
           "ring": np.asarray(j_coll.ring_shift(mesh24, jnp.asarray(inp["ring"])))}

    n, f, h, e, k, b = 16, 8, 16, 8, 4, 8
    x = rng.standard_normal((n, f)).astype(np.float32)
    nbrs = rng.integers(0, n, (n, k)).astype(np.int32)
    w = rng.random((n, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    a0 = np.asarray(j_ps.dense_pool_matrix(jnp.asarray(nbrs), jnp.asarray(w), num_cols=n,
                                           valid_limit=n, dtype=jnp.float32))
    params = j_ps.init_params(jax.random.PRNGKey(0), f, h, e, 2)
    inp.update(x=x, nbrs=nbrs, w=w, a0=a0, q=rng.integers(0, n, b).astype(np.int32),
               p=rng.integers(0, n, b).astype(np.int32),
               rn=rng.choice(n, 6, replace=False).astype(np.int32),
               **{f"params/{kk}": np.asarray(v) for kk, v in _flatten(params).items()})
    mesh42 = j_mesh.make_mesh((4, 2))
    scfg = ShardedStepConfig(loss="max_margin", num_hard=0, valid_limit=n, dtype=jnp.float32)
    compile_step = make_sharded_train_step(mesh42, scfg)
    for name, mats in (("gather", ()), ("hybrid", (a0,))):
        step = compile_step(params, j_optim.adam_init(params), (jnp.asarray(nbrs),) * 2,
                            (jnp.asarray(w),) * 2, tuple(jnp.asarray(m) for m in mats))
        p2, _, loss = step(jax.tree_util.tree_map(np.asarray, params),
                           jax.tree_util.tree_map(np.asarray, j_optim.adam_init(params)),
                           x, (nbrs, nbrs), (w, w), mats, inp["q"], inp["p"], inp["rn"],
                           np.zeros((b, 1), np.int32), np.float32(1e-3))
        ref[f"step_{name}_loss"] = float(loss)
        ref[f"step_{name}"] = {kk: np.asarray(v) for kk, v in _flatten(p2).items()}
    embed = sharded_embed_fn(mesh42, scfg)(params, (jnp.asarray(nbrs),) * 2,
                                           (jnp.asarray(w),) * 2, (jnp.asarray(a0),) * 2)
    ref["embed"] = np.asarray(embed(params, x, (nbrs, nbrs), (w, w), (a0, a0)))

    np.savez(tmp / "inputs.npz", **inp)
    t_mesh.run_local(_worker, 4, str(tmp), timeout=120)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return inp, ref, ranks


def test_distributed_init_is_idempotent_and_joins(mesh_run):
    _, _, ranks = mesh_run
    for r, out in enumerate(ranks):
        assert out["init"].tolist() == [1, 1, r, 4]


def test_distributed_init_does_nothing_without_torchrun(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert t_mesh.distributed_init() is False
    assert not torch.distributed.is_initialized()
    assert t_mesh.is_coordinator() and t_mesh.world_size() == 1
    t_mesh.barrier("single process")                # a no-op


def test_nccl_refuses_more_ranks_than_devices(tmp_path, monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="one CUDA device a rank"):
        t_mesh.distributed_init(backend="nccl", init_method=f"file://{tmp_path}/pg",
                                world_size=2, rank=0)
    assert not torch.distributed.is_initialized()


def test_make_mesh_axes(mesh_run):
    _, _, ranks = mesh_run
    assert [out["axes"].tolist() for out in ranks] == [
        [2, 2, 0, 0], [2, 2, 0, 1], [2, 2, 1, 0], [2, 2, 1, 1]]


def test_sharded_gather_and_ring_shift_match_jax(mesh_run):
    inp, ref, ranks = mesh_run
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["gather"], ref["gather"])
        np.testing.assert_array_equal(out["ring"], ref["ring"][r])
        np.testing.assert_array_equal(out["rows"], inp["table"][inp["own_ids"][r]])
        assert out["rows_torch.bfloat16"].all() and out["rows_torch.float8_e4m3fn"].all()


def test_autograd_collectives_and_their_adjoints(mesh_run):
    inp, _, ranks = mesh_run
    base = inp["base"]
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["ag"], base[:6])
        # Every rank's loss reads the rank's rows with weight r' + 1: 10.
        np.testing.assert_array_equal(out["ag_grad"], np.full_like(out["ag_grad"], 10.0))
        np.testing.assert_array_equal(out["ar"], 10 * base)
        np.testing.assert_array_equal(out["ar_grad"], np.full_like(base, 10.0))


@pytest.mark.parametrize("form", ["gather", "hybrid"])
def test_sharded_step_matches_jax(mesh_run, form):
    _, ref, ranks = mesh_run
    for out in ranks:
        np.testing.assert_allclose(out[f"step_{form}_loss"], ref[f"step_{form}_loss"],
                                   rtol=1e-5)
        for k, v in ref[f"step_{form}"].items():
            np.testing.assert_allclose(out[f"step_{form}/{k}"], v, atol=1e-5, rtol=0,
                                       err_msg=k)


def test_sharded_embed_matches_jax_and_stays_row_sharded(mesh_run):
    _, ref, ranks = mesh_run
    for r, out in enumerate(ranks):
        assert out["embed_rows"].shape == (8, 8)
        s = r % 2
        np.testing.assert_allclose(out["embed_rows"], ref["embed"][8 * s:8 * s + 8], atol=1e-5)
        np.testing.assert_allclose(out["embed"], ref["embed"], atol=1e-5)


def test_pad_to_multiple_and_shares_match_jax():
    from movie_recommendation_engine_tpu.parallel import mesh as j_mesh

    x = np.arange(10).reshape(5, 2)
    for m in (1, 2, 4):
        got, ref = t_mesh.pad_to_multiple(x, m), j_mesh.pad_to_multiple(x, m)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1] == 5
    for n, parts in ((10, 4), (3, 4), (8, 2)):
        split = np.array_split(np.arange(n), parts)
        assert t_mesh.share_sizes(n, parts) == [len(s) for s in split]
        for r in range(parts):
            np.testing.assert_array_equal(np.arange(n)[t_mesh.batch_slice(n, r, parts)],
                                          split[r])


def test_run_local_kills_a_rank_that_hangs():
    with pytest.raises(TimeoutError, match="killed"):
        t_mesh.run_local(_sleeper, 2, 60, timeout=5)
