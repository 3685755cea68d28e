"""Hyperparameter grid search.

Port of ``movie_recommendation_engine_tpu/train/tune.py`` (reference
``hyperparameter_tuning``, run.py:330-429): a grid over learning rate x
hidden dim, each config trained and scored on the validation pairs, the best
model checkpointed to ``best_tuned_model`` and a results CSV written. One
config that fails is logged (``tune_error``) and the sweep goes on.
"""

from __future__ import annotations

import csv
import itertools
import os
from typing import Any, Sequence

from ..config import Config
from ..core.logging import MetricsLogger


def hyperparameter_tuning(
    cfg: Config,
    logger: MetricsLogger | None = None,
    learning_rates: Sequence[float] = (1e-3, 5e-4),
    hidden_dims: Sequence[int] = (128, 256),
    metric: str = "hit_rate@10",
    device=None,
) -> dict[str, Any]:
    """Train and score every (lr, hidden_dim) of the grid, in
    ``itertools.product`` order, on ``device`` (``cuda`` unless ``"cpu"``).
    Returns ``{"best": {"metric", "config"}, "results": rows, "csv": path}``."""
    from ..graph import dataset
    from .trainer import Trainer

    logger = logger or MetricsLogger()
    data = dataset.load(cfg, logger)

    results = []
    best = {"metric": -float("inf"), "config": None}
    os.makedirs(cfg.paths.output_dir, exist_ok=True)
    os.makedirs(cfg.paths.checkpoint_dir, exist_ok=True)

    for lr, hd in itertools.product(learning_rates, hidden_dims):
        run_cfg = cfg.override({"train.learning_rate": lr, "model.hidden_dim": hd})
        logger.log("tune_config", lr=lr, hidden_dim=hd)
        try:
            tr = Trainer(run_cfg, data, logger, device=device)
            tr.fit()
            # Scored on the validation pairs: selecting on the test pairs
            # would leak them (an empty val split takes evaluate's
            # genre-similarity fallback).
            ev = tr.evaluate(tr.val_pairs)
            score = ev.get(metric, 0.0)
            results.append({"lr": lr, "hidden_dim": hd, **ev})
            if score > best["metric"]:
                best = {"metric": score, "config": {"lr": lr, "hidden_dim": hd}}
                tr.save_checkpoint(os.path.join(cfg.paths.checkpoint_dir, "best_tuned_model"),
                                   tag="best_tuned")
        except Exception as e:  # noqa: BLE001 — one bad config must not end the sweep
            logger.log("tune_error", lr=lr, hidden_dim=hd, error=f"{type(e).__name__}: {e}")

    csv_path = os.path.join(cfg.paths.output_dir, "tuning_results.csv")
    if results:
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(results[0].keys()))
            w.writeheader()
            w.writerows(results)
    return {"best": best, "results": results, "csv": csv_path}
