"""PyTorch port, the serving slice as a whole against the JAX package.

Config: ``small_test_config()`` with ``pool_impl=gather``,
``gather_impl=pallas`` (the JAX kernel in interpret mode; the port's kernel
wrapper on CPU tensors), ``search_method=lsh`` and float32 compute. The
port's ``Engine(cfg, device="cpu")`` gets the JAX Engine's params (through
``params_from_jax``), its neighborhood tables and its LSH hyperplanes.
Tolerances: features 1e-6, embeddings 2e-5, HR@k 0.01 and MRR 1% (see
``test_torch_retrieval``), recommendations and server answers exact.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu import api as j_api
from movie_recommendation_engine_tpu import small_test_config
from movie_recommendation_engine_tpu.core.checkpoint import _flatten
from movie_recommendation_engine_tpu_torch import api as t_api
from movie_recommendation_engine_tpu_torch.config import Config as TConfig
from movie_recommendation_engine_tpu_torch.core.checkpoint import load_meta, params_from_jax

PORT = Path(__file__).resolve().parents[1] / "movie_recommendation_engine_tpu_torch"
SLICE = {"model.pool_impl": "gather", "model.gather_impl": "pallas",
         "search.search_method": "lsh", "train.compute_dtype": "float32"}


def _port_engine(cfg, jax_engine):
    """A port Engine on the CPU carrying the JAX engine's params and tables."""
    eng = t_api.Engine(TConfig.from_dict(cfg.to_dict()), device="cpu")
    eng.trainer.params = params_from_jax(_flatten(jax_engine.trainer.params), "cpu")
    eng.trainer.set_neighborhood_tables(
        [(np.asarray(nb), np.asarray(w)) for nb, w in jax_engine.trainer.nbr_tables])
    return eng


@pytest.fixture(scope="module")
def engines():
    cfg = small_test_config().override(SLICE)
    j_eng = j_api.Engine(cfg)
    j_eng.embeddings()                       # samples JAX's tables
    return cfg, j_eng, _port_engine(cfg, j_eng)


def _assert_metrics_close(got, ref):
    for key, v in ref.items():
        if key.startswith("hit_rate"):
            assert abs(got[key] - v) <= 0.01, key
    assert got["mrr"] == pytest.approx(ref["mrr"], rel=0.01)
    assert got["num_pairs"] == ref["num_pairs"]


def test_slice_data_graph_and_pairs_equal(engines):
    """The copied numpy modules build the same corpus, CSR and pairs."""
    _, j_eng, t_eng = engines
    jd, td = j_eng.data, t_eng.data
    for f in ("user_idx", "movie_idx", "ratings", "timestamps", "movie_ids", "user_ids"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    assert (td.titles, td.genres, td.movie_tags) == (jd.titles, jd.genres, jd.movie_tags)
    for f in ("indptr", "indices", "weights", "cumprob"):
        np.testing.assert_array_equal(getattr(t_eng.trainer.csr, f),
                                      getattr(j_eng.trainer.csr, f))
    for f in ("train_pairs", "val_pairs", "test_pairs"):
        np.testing.assert_array_equal(getattr(t_eng.trainer, f), getattr(j_eng.trainer, f))


@pytest.mark.parametrize("max_features,min_df", [(100, 5), (7, 1), (50, 1000)])
def test_tfidf_fallback_matches_jax(engines, max_features, min_df):
    """The sklearn-free TF-IDF branch, which a machine without sklearn takes
    (``min_df=1000`` leaves no vocabulary: None)."""
    from movie_recommendation_engine_tpu.graph import features as j_feat
    from movie_recommendation_engine_tpu_torch.graph import features as t_feat

    docs = [j_feat.strip_year(t) for t in engines[1].data.titles]
    ref = j_feat._tfidf_fallback(docs, max_features, min_df)
    got = t_feat._tfidf_fallback(docs, max_features, min_df)
    if ref is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, ref)


def test_slice_features_and_embeddings(engines):
    _, j_eng, t_eng = engines
    assert t_eng.trainer.gather_impl == "pallas" and t_eng.trainer.pool_mats == ()
    np.testing.assert_allclose(t_eng.trainer.x_table.numpy(),
                               np.asarray(j_eng.trainer.x_table), atol=1e-6)
    emb = t_eng.embeddings()
    assert emb.shape == (j_eng.data.num_movies, j_eng.cfg.model.embed_dim)
    np.testing.assert_allclose(emb, j_eng.embeddings(), atol=2e-5)


def test_slice_evaluate(engines):
    _, j_eng, t_eng = engines
    _assert_metrics_close(t_eng.evaluate(), j_eng.evaluate())


def test_slice_recommend_and_server_exact(engines):
    """Same embeddings and hyperplanes in, the same answers out: exact
    recommendations, and LSH server answers by item and by history."""
    _, j_eng, t_eng = engines
    t_eng._emb = np.array(j_eng.embeddings())
    mids = [int(m) for m in j_eng.data.movie_ids[[3, 10, 42]]]
    assert t_eng.recommend(movie_id=mids[0], k=7) == j_eng.recommend(movie_id=mids[0], k=7)
    assert t_eng.recommend(history=mids, k=7) == j_eng.recommend(history=mids, k=7)
    j_srv = j_eng.serve()
    t_srv = t_eng.serve(planes=np.asarray(j_srv.index.planes))
    try:
        assert t_srv.index.num_bits == 64 and t_srv.index.num_tables == 4
        for i in (0, 3, 57):
            assert t_srv.recommend_by_item(i, k=8) == j_srv.recommend_by_item(i, k=8)
        hist = [1, 4, 9]
        assert t_srv.recommend_by_history(hist, k=8) == j_srv.recommend_by_history(hist, k=8)
    finally:
        j_srv.close()
        t_srv.close()


def test_jax_checkpoint_loads_and_evaluates(engines, tmp_path):
    """A checkpoint written by the JAX Trainer loads into the port (params,
    metadata, config) and evaluates to the JAX metrics."""
    cfg, j_eng, _ = engines
    path = str(tmp_path / "best_model")
    fresh = j_eng.trainer.params
    j_eng.trainer.params = jax_perturbed(fresh)
    try:
        j_eng.trainer.save_checkpoint(path)
        ref = j_eng.evaluate()
        ref_emb = np.asarray(j_eng.trainer.movie_embeddings())
    finally:
        j_eng.trainer.params = fresh
    meta_cfg = TConfig.from_dict(load_meta(path)["config"])
    assert meta_cfg.to_dict() == cfg.to_dict()
    t_eng = t_api.Engine(meta_cfg, device="cpu").load_checkpoint(path)
    t_eng.trainer.set_neighborhood_tables(
        [(np.asarray(nb), np.asarray(w)) for nb, w in j_eng.trainer.nbr_tables])
    assert t_eng.trainer.epoch == j_eng.trainer.epoch
    assert t_eng.trainer.opt_state.step == int(j_eng.trainer.opt_state.step)
    assert t_eng.trainer.plateau._asdict() == j_eng.trainer.plateau._asdict()
    np.testing.assert_allclose(t_eng.embeddings(), ref_emb, atol=2e-5)
    _assert_metrics_close(t_eng.evaluate(), ref)


def jax_perturbed(params):
    """Params unlike a fresh init, so that the load is what is checked."""
    import jax

    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(9)
    return jax.tree_util.tree_unflatten(
        tree, [x + 0.01 * rng.standard_normal(x.shape).astype(np.float32)
               for x in leaves])


def test_cli_modes_on_cpu(tmp_path, capsys):
    from movie_recommendation_engine_tpu_torch.cli.main import main

    sets = [f"--set={k}={v}" for k, v in SLICE.items()] + [
        "--set=data.source=synthetic", "--set=data.synthetic_num_movies=120",
        "--set=data.synthetic_num_users=200", "--set=data.synthetic_num_ratings=3000",
        "--set=features.feature_dim=16", "--set=model.hidden_dim=32",
        "--set=model.embed_dim=16", "--set=walk.num_walks=10",
        "--set=walk.num_neighbors=6", "--set=search.lsh_bits=64",
        "--set=search.lsh_tables=2",
        f"--set=paths.output_dir={tmp_path}", f"--set=paths.checkpoint_dir={tmp_path}"]
    assert main(["evaluate", "--device", "cpu", *sets]) == 0
    assert (tmp_path / "movie_embeddings.npz").exists()
    assert main(["recommend", "--device", "cpu", "--k", "3", *sets]) == 0
    assert "Top-3 recommendations (lsh)" in capsys.readouterr().out
    assert main(["tune", "--device", "cpu", "--lrs", "1e-3", "--hidden-dims", "32",
                 "--set=train.epochs=1", *sets]) == 0
    assert (tmp_path / "tuning_results.csv").exists()
    assert (tmp_path / "best_tuned_model.npz").exists()


def test_entry_points_default_to_cuda():
    """Without a device the entry points ask for CUDA, and raise where it
    is absent rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = TConfig.from_dict(small_test_config().to_dict())
    with pytest.raises(RuntimeError, match="CUDA"):
        t_api.Engine(cfg)
    from movie_recommendation_engine_tpu_torch.retrieval.exact import ExactIndex

    with pytest.raises(RuntimeError, match="CUDA"):
        ExactIndex(8)


def _port_modules():
    root = PORT.parent
    return sorted(".".join(p.relative_to(root).with_suffix("").parts)
                  for p in PORT.rglob("*.py"))


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (this one has JAX loaded by conftest)."""
    mods = [m.removesuffix(".__init__") for m in _port_modules()]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'movie_recommendation_engine_tpu'"
            " or m.startswith('movie_recommendation_engine_tpu.'))\n"
            "assert not bad, bad\nprint(len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(PORT.parent)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=PORT.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_source_has_no_jax_import():
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "movie_recommendation_engine_tpu"), \
                    f"{path}: imports {name}"
