"""PyTorch port, the tools around training against the JAX package: ``tune``,
``demo``, ``download``, reference ``.pt`` checkpoints (``torch_import``) and
``train --profile``, all on the CPU.

``download`` reads a ``file://`` zip the test builds (the URL is patched;
nothing touches the network). The ``.pt`` state dict is written by the test
in the reference's layout; embeddings through it agree with JAX's within
2e-5 in f32 (unit-norm rows, other summation orders).
"""

import io
import json
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movie_recommendation_engine_tpu import small_test_config
from movie_recommendation_engine_tpu.core.logging import MetricsLogger as JLogger
from movie_recommendation_engine_tpu.models import pinsage as j_ps
from movie_recommendation_engine_tpu.train import tune as j_tune
from movie_recommendation_engine_tpu.utils import torch_import as j_import
from movie_recommendation_engine_tpu_torch import api as t_api
from movie_recommendation_engine_tpu_torch.cli.main import main
from movie_recommendation_engine_tpu_torch.config import Config as TConfig
from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger
from movie_recommendation_engine_tpu_torch.graph import download as t_download
from movie_recommendation_engine_tpu_torch.models import pinsage as t_ps
from movie_recommendation_engine_tpu_torch.train import tune as t_tune
from movie_recommendation_engine_tpu_torch.utils import torch_import as t_import

TINY = {"data.synthetic_num_movies": 120, "data.synthetic_num_users": 200,
        "data.synthetic_num_ratings": 3000, "features.feature_dim": 16,
        "model.hidden_dim": 32, "model.embed_dim": 16, "walk.num_walks": 10,
        "train.epochs": 1, "train.batch_size": 32, "train.max_pairs_per_epoch": 64}


def _cfg(tmp_path, sub: str):
    return small_test_config().override({**TINY, "paths.output_dir": str(tmp_path / sub),
                                         "paths.checkpoint_dir": str(tmp_path / sub)})


def _sets(cfg) -> list[str]:
    """CLI arguments that give the CLI ``cfg`` (a config file beside its
    output directory)."""
    path = f"{cfg.paths.output_dir}.json"
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return ["--config", path]


def test_tune_grid_order_and_csv_columns_match_jax(tmp_path):
    grid = {"learning_rates": (1e-3, 5e-4), "hidden_dims": (32,)}
    jcfg = _cfg(tmp_path, "jax")
    ref = j_tune.hyperparameter_tuning(jcfg, JLogger(stream=io.StringIO()), **grid)
    log = MetricsLogger(stream=io.StringIO())
    got = t_tune.hyperparameter_tuning(TConfig.from_dict(_cfg(tmp_path, "port").to_dict()),
                                       log, device="cpu", **grid)
    order = [(e["lr"], e["hidden_dim"]) for e in log.history if e["event"] == "tune_config"]
    assert order == [(r["lr"], r["hidden_dim"]) for r in ref["results"]] == [
        (1e-3, 32), (5e-4, 32)]
    with open(got["csv"]) as f, open(ref["csv"]) as g:
        assert f.readline() == g.readline()            # the same columns, in order
    assert (tmp_path / "port" / "best_tuned_model.npz").exists()
    assert got["best"]["config"]["hidden_dim"] == 32


def test_tune_logs_a_bad_config_and_goes_on(tmp_path):
    log = MetricsLogger(stream=io.StringIO())
    cfg = TConfig.from_dict(_cfg(tmp_path, "bad").to_dict())
    out = t_tune.hyperparameter_tuning(cfg, log, learning_rates=(1e-3,), hidden_dims=(0, 32),
                                       device="cpu")
    errors = [e for e in log.history if e["event"] == "tune_error"]
    assert len(errors) == 1 and errors[0]["hidden_dim"] == 0
    assert [r["hidden_dim"] for r in out["results"]] == [32]


def test_demo_on_piped_commands(tmp_path, monkeypatch, capsys):
    cfg = _cfg(tmp_path, "demo")
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "search Midnight\nrecommend 3\nrecommend 999999\npopular\nbogus\nquit\n"))
    assert main(["demo", "--device", "cpu", *_sets(cfg)]) == 0
    out = capsys.readouterr().out
    assert "120 movies loaded" in out or "movies loaded" in out
    assert "query:" in out and "recommendations:" in out
    assert "movieId 999999 not found" in out and "commands:" in out
    recs = out.split("recommendations:")[1].split(">")[0].strip().splitlines()
    assert len(recs) == 10 and not any(r.startswith("[3]") for r in recs)


def test_demo_reads_saved_embeddings(tmp_path, monkeypatch, capsys):
    cfg = _cfg(tmp_path, "saved")
    assert main(["evaluate", "--device", "cpu", *_sets(cfg)]) == 0
    monkeypatch.setattr(sys, "stdin", io.StringIO("recommend 3\n"))
    capsys.readouterr()
    assert main(["demo", "--device", "cpu", *_sets(cfg)]) == 0
    assert "loaded embeddings from" in capsys.readouterr().out


def _zip_of_csvs(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    path = src / "ml-25m.zip"
    with zipfile.ZipFile(path, "w") as z:
        for name in t_download.REQUIRED_CSVS:
            z.writestr(f"ml-25m/{name}", "movieId\n1\n")
    return path


def test_download_from_a_file_url(tmp_path, monkeypatch, capsys):
    zpath = _zip_of_csvs(tmp_path)
    data_dir = tmp_path / "data" / "ml-25m"
    monkeypatch.setattr(t_download, "ML_25M_URL", zpath.as_uri())
    assert main(["download", "--set", f"data.data_dir={data_dir}"]) == 0
    assert all((data_dir / n).exists() for n in t_download.REQUIRED_CSVS)
    assert "verification: OK" in capsys.readouterr().out
    assert main(["download", "--set", f"data.data_dir={data_dir}"]) == 0
    assert "already present" in capsys.readouterr().out


def test_download_reports_a_failed_fetch(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(t_download, "ML_25M_URL", (tmp_path / "absent.zip").as_uri())
    assert main(["download", "--set", f"data.data_dir={tmp_path / 'd' / 'ml-25m'}"]) == 1
    assert "download failed" in capsys.readouterr().out


def _reference_state_dict(rng, f, hid, emb, layers=2):
    """A ``model_state_dict`` in the reference's layout: nn.Linear weights
    [out, in]."""
    def lin(prefix, fan_in, fan_out):
        return {f"{prefix}.weight": torch.from_numpy(
                    rng.standard_normal((fan_out, fan_in)).astype(np.float32) * 0.2),
                f"{prefix}.bias": torch.from_numpy(
                    rng.standard_normal(fan_out).astype(np.float32) * 0.1)}

    sd = {**lin("input_proj", f, hid), **lin("output_proj", hid, emb)}
    for i in range(layers):
        sd.update(lin(f"convs.{i}.lin_self", hid, hid))
        sd.update(lin(f"convs.{i}.lin_neigh", hid, hid))
        sd.update(lin(f"convs.{i}.lin_update", 2 * hid, hid))
    return sd


def test_torch_checkpoint_embeds_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    cfg = _cfg(tmp_path, "pt").override({"train.compute_dtype": "float32"})
    sd = _reference_state_dict(rng, 16, 32, 16)
    path = tmp_path / "ref.pt"
    torch.save({"epoch": 3, "model_state_dict": sd, "optimizer_state_dict": {},
                "loss": 0.5}, path)
    params, meta = t_import.load_torch_checkpoint(str(path))
    assert meta == {"epoch": 3, "loss": 0.5}
    jp, jmeta = j_import.load_torch_checkpoint(str(path))
    x = rng.standard_normal((40, 16)).astype(np.float32)
    nbrs = [rng.integers(0, 40, (40, 6)).astype(np.int32) for _ in range(2)]
    wts = [rng.random((40, 6)).astype(np.float32) for _ in range(2)]
    ref = j_ps.pooled_forward(jp, jnp.asarray(x), [jnp.asarray(a) for a in nbrs],
                              [jnp.asarray(a) for a in wts], dtype=jnp.float32)
    got = t_ps.pooled_forward(params, torch.from_numpy(x), [torch.from_numpy(a) for a in nbrs],
                              [torch.from_numpy(a) for a in wts], dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    # Through the Engine and the CLI.
    eng = t_api.Engine(TConfig.from_dict(cfg.to_dict()), device="cpu")
    eng.load_checkpoint(str(path))
    for k in ("input_proj", "output_proj"):
        assert torch.equal(eng.trainer.params[k]["w"], sd[f"{k}.weight"].t())
    emb = eng.embeddings()
    assert emb.shape == (eng.data.num_movies, 16) and np.isfinite(emb).all()
    assert main(["evaluate", "--device", "cpu", "--checkpoint", str(path), *_sets(cfg)]) == 0
    saved = np.load(tmp_path / "pt" / "movie_embeddings.npz")["embeddings"]
    np.testing.assert_allclose(saved, emb, atol=1e-6)


def test_train_profile_writes_a_trace(tmp_path, capsys):
    cfg = _cfg(tmp_path, "prof")
    trace_dir = tmp_path / "trace"
    assert main(["train", "--device", "cpu", "--profile", str(trace_dir), *_sets(cfg)]) == 0
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names)
    assert '"event": "profile"' in capsys.readouterr().out
