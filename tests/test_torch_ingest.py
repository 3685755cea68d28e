"""PyTorch port, MovieLens CSV ingest and the co-occurrence counter against
the JAX package.

The CSVs are written by the tests: the small synthetic corpus as ratings,
titles holding commas and quotes, tags that pandas reads as missing (``NA``,
``null``, ``None``, ``n/a``, empty) beside ``nanotechnology`` and
``"a, b"``, ``imdbId`` with leading zeros and ``tmdbId`` left empty. The
port reads them without pandas; JAX reads them with pandas and its native
ratings parser. Every ``MovieLensData`` field must be equal: integer and
string fields exactly, ratings exactly (half-star values round-trip through
the text). The slice on CSV-loaded data is held to JAX's ``_run_steps`` as
``test_torch_train`` holds the synthetic one: f32 losses 1e-5 relative,
params 1e-5 absolute.
"""

import csv
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from movie_recommendation_engine_tpu import small_test_config
from movie_recommendation_engine_tpu.core.checkpoint import _flatten
from movie_recommendation_engine_tpu.graph import builders as j_builders
from movie_recommendation_engine_tpu.graph import dataset as j_dataset
from movie_recommendation_engine_tpu.graph import synthetic as j_synthetic
from movie_recommendation_engine_tpu.train.trainer import Trainer as JTrainer
from movie_recommendation_engine_tpu_torch.config import Config as TConfig
from movie_recommendation_engine_tpu_torch.core import tree
from movie_recommendation_engine_tpu_torch.core.checkpoint import params_from_jax
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
from movie_recommendation_engine_tpu_torch.graph import builders as t_builders
from movie_recommendation_engine_tpu_torch.graph import dataset as t_dataset
from movie_recommendation_engine_tpu_torch.train import optim as t_optim
from movie_recommendation_engine_tpu_torch.train.trainer import Trainer as TTrainer
from movie_recommendation_engine_tpu_torch.utils import cooc_native, ingest_native
from tests.test_torch_train import _jax_draws, _t

NA_TAGS = ["NA", "null", "None", "n/a", "", "#N/A"]
KEPT_TAGS = ["nanotechnology", "a, b", 'say "hi"', " NA"]


def _write_csvs(d, optional: bool = True) -> None:
    """The small synthetic corpus as MovieLens CSVs in ``d``."""
    raw = j_synthetic.generate(num_movies=200, num_users=400, num_ratings=8000, seed=0)
    titles = list(raw["titles"])
    titles[0] = "American President, The (1995)"
    titles[1] = 'Movie "Nick" Name, A (1999)'
    titles[2] = "NA"                        # pandas reads it as missing: ""
    with open(d / "movies.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["movieId", "title", "genres"])
        w.writerows(zip(raw["movie_ids"], titles, raw["genres"]))
    with open(d / "ratings.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["userId", "movieId", "rating", "timestamp"])
        w.writerows(zip(raw["rating_user_ids"], raw["rating_movie_ids"],
                        [f"{v:.1f}" for v in raw["rating_values"]], raw["rating_timestamps"]))
    if not optional:
        return
    tags = list(raw["tag_values"])
    extra = NA_TAGS + KEPT_TAGS
    tags[:len(extra)] = extra
    with open(d / "tags.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["userId", "movieId", "tag", "timestamp"])
        w.writerows(zip(raw["tag_user_ids"], raw["tag_movie_ids"], tags,
                        range(len(tags))))
    with open(d / "links.csv", "w", newline="") as f:
        f.write("movieId,imdbId,tmdbId\n")
        for i, mid in enumerate(raw["movie_ids"]):
            tmdb = "" if i % 5 == 0 else str(1000 + i)
            f.write(f"{mid},{i:07d},{tmdb}\n")


@pytest.fixture(scope="module")
def csv_dirs(tmp_path_factory):
    full = tmp_path_factory.mktemp("ml_full")
    bare = tmp_path_factory.mktemp("ml_bare")
    _write_csvs(full)
    _write_csvs(bare, optional=False)
    return {"full": full, "bare": bare}


def _cfg(d, workers: int = 4):
    return small_test_config().override({"data.source": "movielens", "data.data_dir": str(d),
                                         "train.num_workers": workers})


def _assert_same_data(got, ref) -> None:
    for name in ("user_idx", "movie_idx", "ratings", "timestamps", "movie_ids", "user_ids"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    assert got.user_idx.dtype == np.int64 and got.ratings.dtype == np.float32
    for name in ("titles", "genres", "movie_tags"):
        assert getattr(got, name) == getattr(ref, name), name
    for name in ("imdb_ids", "tmdb_ids"):
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def jax_data(csv_dirs):
    return {k: j_dataset.load(_cfg(d)) for k, d in csv_dirs.items()}


@pytest.mark.parametrize("files", ["full", "bare"])
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("route", ["native", "python"])
def test_load_movielens_csv_matches_jax(csv_dirs, jax_data, monkeypatch, files, workers,
                                        route):
    if route == "python":
        # A build that fails: the loader falls back to its stdlib reader.
        monkeypatch.setattr(ingest_native, "FLAGS", ("--no-such-flag",))
    log = MetricsLogger(stream=io.StringIO())
    got = t_dataset.load(TConfig.from_dict(_cfg(csv_dirs[files], workers).to_dict()), log)
    _assert_same_data(got, jax_data[files])
    (event,) = [e for e in log.history if e["event"] == "ingest"]
    rows = sum(1 for _ in open(csv_dirs[files] / "ratings.csv")) - 1
    assert event["route"] == route and event["rows"] == rows
    assert (event["reason"] is None) == (route == "native")
    if files == "bare":
        assert got.imdb_ids is None and got.tmdb_ids is None


def test_csv_traps_read_as_pandas_reads_them(csv_dirs, jax_data):
    got = t_dataset.load(TConfig.from_dict(_cfg(csv_dirs["full"]).to_dict()))
    titles = set(got.titles)
    assert {"American President, The (1995)", 'Movie "Nick" Name, A (1999)'} <= titles
    assert "NA" not in titles
    words = " ".join(got.movie_tags).split(" ")
    assert "nanotechnology" in words and '"hi"' in words and "b" in words
    for na in ("null", "None", "n/a", "#N/A", "nan"):     # " NA" is kept, as in pandas
        assert na not in words
    assert got.tmdb_ids.min() == -1 and got.imdb_ids.max() < 200
    assert (got.imdb_ids >= 0).all()


def test_read_ratings_python_matches_native(csv_dirs):
    path = str(csv_dirs["full"] / "ratings.csv")
    for a, b in zip(t_dataset.read_ratings_python(path), ingest_native.read_ratings_csv(path, 3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _cooc_inputs(seed, n=5000, users=120, movies=60):
    rng = np.random.default_rng(seed)
    return rng.integers(0, users, n), rng.integers(0, movies, n), movies


@pytest.mark.parametrize("seed,threshold", [(0, 2), (1, 5), (2, 400)])
def test_cooc_native_matches_numpy_and_jax(seed, threshold):
    u, m, movies = _cooc_inputs(seed)
    log = MetricsLogger(stream=io.StringIO())
    nat = t_builders.build_item_similarity_graph(u, m, movies, threshold=threshold, logger=log)
    ref = j_builders.build_item_similarity_graph(u, m, movies, threshold=threshold)
    assert [e["route"] for e in log.history] == ["native"]
    for name in ("indptr", "indices", "weights", "cumprob"):
        np.testing.assert_array_equal(getattr(nat, name), getattr(ref, name), err_msg=name)
    assert (nat.num_edges > 0) == (threshold < 400)
    # The two counters alone, on the grouped columns the builder counts.
    order = np.argsort(u, kind="stable")
    u_s, m_s = u[order].astype(np.int64), m[order].astype(np.int64)
    got = cooc_native.count_cooccurrence(u_s, m_s, movies, threshold)
    want = t_builders.cooccurrence_counts(u_s, m_s, movies, threshold)
    keys = [np.asarray(i, np.int64) * movies + j for i, j, _ in (got, want)]
    by = [np.argsort(k) for k in keys]
    np.testing.assert_array_equal(keys[0][by[0]], keys[1][by[1]])
    np.testing.assert_array_equal(got[2][by[0]], want[2][by[1]].astype(np.float32))


def test_cooc_falls_back_to_numpy_when_the_build_fails(monkeypatch):
    monkeypatch.setattr(cooc_native, "FLAGS", ("--no-such-flag",))
    u, m, movies = _cooc_inputs(3)
    log = MetricsLogger(stream=io.StringIO())
    got = t_builders.build_item_similarity_graph(u, m, movies, threshold=3, logger=log)
    ref = j_builders.build_item_similarity_graph(u, m, movies, threshold=3)
    for name in ("indptr", "indices", "weights", "cumprob"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    (event,) = log.history
    assert event["route"] == "numpy" and "g++" in event["reason"]


@pytest.fixture(scope="module")
def csv_slice(csv_dirs):
    """One block of 3 steps on the CSV-loaded corpus through JAX's
    ``_run_steps`` and the port's ``train_steps``, on the co-occurrence
    graph, from the same features, tables, params and draws."""
    cfg = _cfg(csv_dirs["full"]).override({"train.compute_dtype": "float32",
                                           "graph.use_bipartite_graph": False,
                                           "graph.similarity_threshold": 2})
    jt = JTrainer(cfg, j_dataset.load(cfg))
    jt.refresh_neighborhoods()
    tcfg = TConfig.from_dict(cfg.to_dict())
    tt = TTrainer(tcfg, t_dataset.load(tcfg), device="cpu")
    assert tt.csr.num_edges == jt.csr.num_edges
    np.testing.assert_array_equal(tt.csr.indices, jt.csr.indices)
    tt.x_table = _t(jt.x_table)
    tt.set_neighborhood_tables([(np.asarray(a), np.asarray(b)) for a, b in jt.nbr_tables])
    tt.pool_mats = tuple(_t(np.asarray(a, np.float32)).bfloat16() for a in jt.pool_mats)
    tt.params = params_from_jax(_flatten(jt.params), "cpu")
    tt.opt_state = t_optim.state_from_jax(
        {f"opt/{k}": np.asarray(v) for k, v in _flatten(jt.opt_state._asdict()).items()}, "cpu")
    batches = jt._epoch_pairs(np.random.default_rng(5))[:3]
    q_blk, p_blk = batches[:, :, 0].astype(np.int32), batches[:, :, 1].astype(np.int32)
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(jt, key, q_blk, 1)
    jt.params, jt.opt_state, j_losses = jt._run_steps(
        jt.params, jt.opt_state, jt.x_table, tuple(t[0] for t in jt.nbr_tables),
        tuple(t[1] for t in jt.nbr_tables), jt.pool_mats, jt.graph, jnp.asarray(q_blk),
        jnp.asarray(p_blk), key, jnp.float32(1e-3), jnp.float32(1.0), num_hard=1)
    t_losses = tt.train_steps(q_blk, p_blk, 1e-3, 1.0, 1, draws=draws)
    return jt, tt, np.asarray(j_losses), t_losses.numpy()


def test_train_steps_on_csv_data_match_jax(csv_slice):
    jt, tt, j_losses, t_losses = csv_slice
    assert np.isfinite(t_losses).all()
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=0)
    got = tree.flatten(tt.params)
    for k, r in _flatten(jt.params).items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(r), atol=1e-5, rtol=0, err_msg=k)
