"""PyTorch port, the trainer on a (data, model) mesh against the JAX package.

JAX's mesh trainer (``mesh_shape=(4, 2)``, ``shard_tables``) runs in this
process on the virtual mesh; its tables, padded feature table, params, Adam
state and injected draws (random and hard negatives, keep masks) go to the
single-device port and to the port's mesh trainer, which runs in spawned
gloo processes: (1, 2) and (2, 1) on two ranks for the gather, hybrid, hub
and block rungs, (1, 2) for the attention aggregator with batch norm, and
(2, 2) on four ranks once (every node in the table, so the rows are padded
to the model axis). Tolerances, each with its reason:

- losses 1e-5 relative and parameters 1e-5 absolute after two Adam steps at
  lr 1e-3, f32 (each rank's share of the loss and the gradients are summed
  across ranks in another order; JAX's own mesh sums in its order). Adam
  divides each gradient element by its own size, so an element whose
  gradient is zero up to rounding (below 1e-6 of the largest: attention's
  score bias, which the softmax cancels) steps by up to lr either way; such
  elements are held to that bound, 2 lr over the two steps;
- the first step's gradients within 1e-5 of the largest, against the
  single-device port: a gradient counted on more than one rank (a factor
  of ``m``) is off by its own size;
- walk tables given, so every rank pools the same ids: exact.

A two-rank ``fit`` writes its checkpoints from the coordinator alone; one
rank killed after the first, the survivor fails instead of hanging, and a
new pair of ranks resumes from it.
"""

import json
import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu_torch.parallel import mesh as t_mesh

RUNGS = {
    "gather": {"model.pool_impl": "gather", "model.gather_impl": "pallas"},
    "hybrid": {"model.pool_impl": "hybrid"},
    "hub": {"model.pool_impl": "hub", "model.hub_pool_head": 64},
    "block": {"model.pool_impl": "block", "model.block_pool_block_size": 16,
              "model.block_pool_max_blocks": 10_000},
    "padded": {"model.pool_impl": "gather", "model.pool_nodes": "all"},
    # Another aggregator (no pool operators) with batch norm, whose
    # statistics are summed over the model axis and over every rank.
    "attention_bn": {"model.pool_impl": "gather", "model.aggregator_type": "attention",
                     "model.use_batch_norm": True},
}
STEPS, NUM_HARD, LR, EPOCH = 2, 2, 1e-3, 1.0


def _config(rung: str):
    from movie_recommendation_engine_tpu import small_test_config

    return small_test_config().override({"train.compute_dtype": "float32",
                                         "mesh.shard_tables": True, **RUNGS[rung]})


def _port_trainer(cfg_dict, shape, inp, data=None):
    """A CPU port trainer (on a mesh of ``shape``, or one device) given JAX's
    padded feature table, tables, params and Adam state."""
    from movie_recommendation_engine_tpu_torch.config import Config
    from movie_recommendation_engine_tpu_torch.core.checkpoint import params_from_jax
    from movie_recommendation_engine_tpu_torch.graph import dataset
    from movie_recommendation_engine_tpu_torch.train import optim
    from movie_recommendation_engine_tpu_torch.train.trainer import Trainer

    cfg = Config.from_dict(cfg_dict)
    cfg.mesh.mesh_shape = shape
    tr = Trainer(cfg, data if data is not None else dataset.load(cfg), device="cpu")
    x = torch.from_numpy(np.array(inp["x"]))
    tr.x_table = x if tr.shard is None else x[tr.shard.start:tr.shard.stop]
    tr.table_rows = int(x.shape[0])
    tr.set_neighborhood_tables([(inp[f"nbrs{i}"], inp[f"w{i}"])
                                for i in range(cfg.model.num_layers)])
    tr.params = params_from_jax({k[7:]: v for k, v in inp.items() if k.startswith("params/")},
                                "cpu")
    tr.opt_state = optim.state_from_jax(
        {k: v for k, v in inp.items() if k.startswith("opt/")}, "cpu")
    return tr


def _steps(tr, inp) -> dict:
    """The first step's loss and gradients, then ``STEPS`` Adam steps."""
    from movie_recommendation_engine_tpu_torch.core import tree
    from movie_recommendation_engine_tpu_torch.train.trainer import StepDraws

    t = lambda a: torch.from_numpy(np.array(a))      # noqa: E731  (a writable copy)
    draws = [StepDraws(t(inp[f"rand{s}"]), t(inp[f"hard{s}"]), [t(inp[f"keep{s}"])])
             for s in range(STEPS)]
    q, p = t(inp["q"]), t(inp["p"])
    loss0, grads = tr.loss_and_grads(q[0], p[0], draws[0], EPOCH)
    out = {"loss0": float(loss0), "rung": [type(m).__name__ for m in tr.pool_mats]}
    out.update({f"grad/{k}": v.numpy() for k, v in tree.flatten(grads).items()})
    out["losses"] = tr.train_steps(q, p, LR, EPOCH, NUM_HARD, draws=draws).numpy()
    out.update({f"param/{k}": v.numpy() for k, v in tree.flatten(tr.params).items()})
    return out


def _step_worker(rank, world, tmp, cases):
    from movie_recommendation_engine_tpu_torch.graph import dataset

    t_mesh.distributed_init(backend="gloo", init_method=f"file://{tmp}/pg{world}",
                            world_size=world, rank=rank, init_timeout_s=60)
    torch.set_num_threads(2)
    data = {}
    for rung, shape in cases:
        inp = dict(np.load(f"{tmp}/{rung}.npz"))
        cfg_dict = json.loads(str(inp.pop("cfg")))
        key = json.dumps(cfg_dict["data"], sort_keys=True)
        if key not in data:
            from movie_recommendation_engine_tpu_torch.config import Config

            data[key] = dataset.load(Config.from_dict(cfg_dict))
        tr = _port_trainer(cfg_dict, shape, inp, data[key])
        out = _steps(tr, inp)
        out["held_rows"] = tr.x_table.shape[0]
        np.savez(f"{tmp}/{rung}_{shape[0]}x{shape[1]}_rank{rank}.npz",
                 **{k: np.asarray(v) for k, v in out.items()})
    torch.distributed.destroy_process_group()


def _jax_inputs(rung: str) -> tuple[dict, dict]:
    """JAX's mesh trainer on the rung: its tables, padded table, params, Adam
    state, the draws its ``_run_steps`` makes from a key, and its result."""
    import jax
    import jax.numpy as jnp

    from movie_recommendation_engine_tpu.core.checkpoint import _flatten
    from movie_recommendation_engine_tpu.graph import dataset as j_dataset
    from movie_recommendation_engine_tpu.sampling import negative as j_neg
    from movie_recommendation_engine_tpu.train.trainer import Trainer as JTrainer

    cfg = _config(rung)
    cfg.mesh.mesh_shape = (4, 2)
    jt = JTrainer(cfg, j_dataset.load(cfg))
    jt.refresh_neighborhoods()
    batches = jt._epoch_pairs(np.random.default_rng(5))[:STEPS]
    q, p = batches[:, :, 0].astype(np.int32), batches[:, :, 1].astype(np.int32)
    inp = {"cfg": json.dumps(cfg.to_dict()), "x": np.asarray(jt.x_table), "q": q, "p": p}
    for i, (nb, w) in enumerate(jt.nbr_tables):
        inp[f"nbrs{i}"], inp[f"w{i}"] = np.asarray(nb), np.asarray(w)
    inp.update({f"params/{k}": np.asarray(v) for k, v in _flatten(jt.params).items()})
    inp.update({f"opt/{k}": np.asarray(v) for k, v in _flatten(jt.opt_state._asdict()).items()})
    key = jax.random.PRNGKey(11)
    num_rand = min(cfg.train.num_negative_samples, jt.data.num_movies)
    for s, k in enumerate(jax.random.split(key, STEPS)):
        k_neg, k_hard, k_drop = jax.random.split(k, 3)
        inp[f"rand{s}"] = np.asarray(j_neg.sample_random_negatives(
            k_neg, jt.data.num_movies, num_rand))
        inp[f"hard{s}"] = np.asarray(j_neg.sample_hard_negatives(
            jt.graph, jnp.asarray(q[s]), k_hard, NUM_HARD, jt.data.num_movies, num_walks=100,
            walk_length=cfg.walk.walk_length, min_rank=cfg.train.hard_neg_min_rank,
            max_rank=cfg.train.hard_neg_max_rank, n_iters=jt.n_iters))
        inp[f"keep{s}"] = np.asarray(jax.random.bernoulli(
            jax.random.split(k_drop)[1], 1 - cfg.model.dropout,
            (jt.table_rows, cfg.model.hidden_dim)))
    params, _, losses = jt._run_steps(
        jt.params, jt.opt_state, jt.x_table, tuple(t[0] for t in jt.nbr_tables),
        tuple(t[1] for t in jt.nbr_tables), jt.pool_mats, jt.graph, jnp.asarray(q),
        jnp.asarray(p), key, jnp.float32(LR), jnp.float32(EPOCH), num_hard=NUM_HARD)
    ref = {"losses": np.asarray(losses), "rung": [type(m).__name__ for m in jt.pool_mats],
           "table_rows": jt.table_rows}
    ref.update({f"param/{k}": np.asarray(v) for k, v in _flatten(params).items()})
    return inp, ref


@pytest.fixture(scope="module")
def mesh_steps(tmp_path_factory):
    """Per rung: JAX's mesh trainer, the single-device port and the port's
    mesh runs, from the same inputs."""
    tmp = tmp_path_factory.mktemp("steps")
    refs, singles = {}, {}
    for rung in RUNGS:
        inp, refs[rung] = _jax_inputs(rung)
        np.savez(tmp / f"{rung}.npz", **inp)
        singles[rung] = _steps(_port_trainer(json.loads(inp["cfg"]), None,
                                             {k: v for k, v in inp.items() if k != "cfg"}),
                               inp)
    two = [(r, s) for s in ((1, 2), (2, 1)) for r in ("gather", "hybrid", "hub", "block")]
    two.append(("attention_bn", (1, 2)))
    t_mesh.run_local(_step_worker, 2, str(tmp), two, timeout=120)
    t_mesh.run_local(_step_worker, 4, str(tmp), [("padded", (2, 2))], timeout=120)

    def ranks(rung, shape, world):
        return [dict(np.load(tmp / f"{rung}_{shape[0]}x{shape[1]}_rank{r}.npz"))
                for r in range(world)]
    return refs, singles, ranks


CASES = [(r, (1, 2), 2) for r in ("gather", "hybrid", "hub", "block")] + \
        [(r, (2, 1), 2) for r in ("gather", "hybrid", "hub", "block")] + \
        [("attention_bn", (1, 2), 2), ("padded", (2, 2), 4)]


def _ids(cases):
    return [f"{r}-{s[0]}x{s[1]}" for r, s, _ in cases]


def _assert_params_close(got: dict, ref: dict, single: dict) -> None:
    """Params within 1e-5, or within Adam's 2 lr where the single-device
    first gradient is zero up to rounding."""
    scale = max(float(np.abs(v).max()) for k, v in single.items() if k.startswith("grad/"))
    for k, v in ref.items():
        if not k.startswith("param/"):
            continue
        rounding_zero = np.abs(single["grad/" + k[len("param/"):]]) <= 1e-6 * scale
        diff = np.abs(got[k] - v)
        assert (diff[~rounding_zero] <= 1e-5).all(), (k, float(diff[~rounding_zero].max()))
        assert (diff[rounding_zero] <= 2 * LR * STEPS).all(), k


@pytest.mark.parametrize("rung,shape,world", CASES, ids=_ids(CASES))
def test_mesh_steps_match_jax_mesh_trainer(mesh_steps, rung, shape, world):
    refs, singles, ranks = mesh_steps
    ref = refs[rung]
    want = {"gather": [], "padded": [], "attention_bn": [], "hybrid": ["ArrayImpl"],
            "hub": ["HubPool"], "block": ["BlockPool"]}[rung]
    assert ref["rung"] == want
    for out in ranks(rung, shape, world):
        assert [n.replace("Tensor", "ArrayImpl") for n in out["rung"].tolist()] == want
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5, atol=0)
        _assert_params_close(out, ref, singles[rung])


@pytest.mark.parametrize("rung,shape,world", CASES, ids=_ids(CASES))
def test_mesh_steps_match_the_single_device_port(mesh_steps, rung, shape, world):
    refs, singles, ranks = mesh_steps
    single = singles[rung]
    m = shape[1]
    for out in ranks(rung, shape, world):
        # Row-sharded: each rank holds its 1/m of the (padded) feature table.
        assert out["held_rows"] * m == refs[rung]["table_rows"]
        np.testing.assert_allclose(out["loss0"], single["loss0"], rtol=1e-5)
        np.testing.assert_allclose(out["losses"], single["losses"], rtol=1e-5, atol=0)
        _assert_params_close(out, single, single)


@pytest.mark.parametrize("rung,shape,world", CASES, ids=_ids(CASES))
def test_mesh_gradients_are_counted_once(mesh_steps, rung, shape, world):
    """Each gradient leaf equals the single-device one to 1e-5 of the
    largest: a batch layer computed on every model rank, or a sum over a
    replicated computation, would scale a leaf by ``m``."""
    _, singles, ranks = mesh_steps
    single = singles[rung]
    grads = [k for k in single if k.startswith("grad/")]
    scale = max(float(np.abs(single[k]).max()) for k in grads)
    for out in ranks(rung, shape, world):
        for k in grads:
            np.testing.assert_allclose(out[k], single[k], atol=1e-5 * scale, rtol=0,
                                       err_msg=k)
            norm = float(np.linalg.norm(single[k]))
            if norm > 1e-3 * scale:
                assert abs(np.linalg.norm(out[k]) / norm - 1.0) < 1e-3, k


# ---------------------------------------------------------------------------
# A two-rank fit: the coordinator writes, a rank dies, the run resumes
# ---------------------------------------------------------------------------

def _fit_worker(rank, world, tmp, run, epochs, resume):
    from movie_recommendation_engine_tpu_torch import small_test_config
    from movie_recommendation_engine_tpu_torch.core import checkpoint as ckpt
    from movie_recommendation_engine_tpu_torch.graph import dataset
    from movie_recommendation_engine_tpu_torch.train.trainer import Trainer

    t_mesh.distributed_init(backend="gloo", init_method=f"file://{tmp}/pg_{run}",
                            world_size=world, rank=rank, init_timeout_s=60)
    torch.set_num_threads(2)
    writes = []
    save = ckpt.save_flat
    ckpt.save_flat = lambda path, *a, **kw: (writes.append(path), save(path, *a, **kw))
    cfg = small_test_config().override({
        "mesh.shard_tables": True, "train.epochs": epochs, "train.max_pairs_per_epoch": 128,
        "train.batch_size": 32, "eval.patience": 1000,
        "paths.checkpoint_dir": f"{tmp}/ck"})
    cfg.mesh.mesh_shape = (1, 2)
    tr = Trainer(cfg, dataset.load(cfg), device="cpu")
    start = tr.epoch
    out = tr.fit(resume_from=resume)
    with open(f"{tmp}/{run}_rank{rank}.json", "w") as f:
        json.dump({"start": start, "resumed_at": out["history"] and tr.epoch - len(
            out["history"]), "losses": [h["loss"] for h in out["history"]],
            "writes": len(writes), "epoch": tr.epoch}, f)
    torch.distributed.destroy_process_group()


def test_two_rank_fit_coordinator_writes_kill_and_resume(tmp_path):
    from movie_recommendation_engine_tpu_torch.core import checkpoint as ckpt

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_fit_worker, args=(r, 2, str(tmp_path), "a", 400, None))
             for r in range(2)]
    for p in procs:
        p.start()
    last = tmp_path / "ck" / "last_model.meta.json"
    deadline = time.monotonic() + 60
    try:
        while not last.exists() and time.monotonic() < deadline:
            assert all(p.is_alive() for p in procs), "a rank died before the first checkpoint"
            time.sleep(0.2)
        assert last.exists(), "no checkpoint within 60 s"
        procs[1].kill()
        procs[1].join()
        procs[0].join(55)
        assert not procs[0].is_alive(), "the survivor hung after its peer died"
        assert procs[0].exitcode != 0, "the survivor cannot have finished 400 epochs"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    e0 = int(ckpt.load_meta(str(tmp_path / "ck" / "last_model"))["epoch"])
    assert e0 >= 1

    t_mesh.run_local(_fit_worker, 2, str(tmp_path), "b", e0 + 2,
                     str(tmp_path / "ck" / "last_model"), timeout=120)
    a, b = (json.load(open(tmp_path / f"b_rank{r}.json")) for r in range(2))
    assert a["resumed_at"] == b["resumed_at"] == e0
    assert a["epoch"] == b["epoch"] == e0 + 2
    assert len(a["losses"]) == 2 and a["losses"] == b["losses"]
    assert np.isfinite(a["losses"]).all()
    # Only the coordinator wrote (last_model every epoch, best_model on a
    # new best); the other rank waited at the barrier.
    assert a["writes"] >= 2 and b["writes"] == 0
    assert int(ckpt.load_meta(str(tmp_path / "ck" / "last_model"))["epoch"]) == e0 + 2
