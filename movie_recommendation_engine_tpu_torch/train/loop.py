"""The training loop that every architecture shares: ``fit`` (epochs,
validation, the plateau schedule, ``last_model`` / ``best_model``
checkpoints, early stopping), checkpoint save and resume in the JAX
package's format, and the generator's checkpointed words.

A subclass supplies the model: ``trainer.Trainer`` (PinSage) and
``seq_trainer.SeqTrainer`` (HSTU) each set ``cfg``, ``log``, ``device``,
``generator``, ``params``, ``opt_state``, ``plateau``, ``graphs`` (a
``StepGraphs``), ``epoch``, ``best_metric`` and ``eval_seconds``, and
implement ``train_epoch``, ``validate``, ``evaluate``, ``movie_embeddings``
and ``_params_from``.
``make_trainer`` picks the subclass of ``model.arch``.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..config import Config
from ..core import checkpoint as ckpt
from ..core.logging import MetricsLogger, span
from ..graph.dataset import MovieLensData
from ..parallel import mesh as mesh_mod
from . import optim


class TrainLoop:
    """``fit`` and checkpoints over a subclass's epoch, validation and
    evaluation."""

    def train_epoch(self, epoch: int) -> dict[str, float]:
        """One epoch's steps; its stats, ``loss`` among them."""
        raise NotImplementedError

    def validate(self) -> dict[str, float] | None:
        """The validation metrics (``hit_rate@k`` among them), or None
        without a validation set."""
        raise NotImplementedError

    def evaluate(self, pairs: np.ndarray | None = None, params=None) -> dict[str, float]:
        """The test metrics at ``params`` (``self.params`` if None); its
        duration is kept in ``eval_seconds``."""
        raise NotImplementedError

    def movie_embeddings(self, params=None) -> torch.Tensor:
        """[num_movies, d] f32 item embeddings at ``params``, the rows the
        indexes search."""
        raise NotImplementedError

    def _params_from(self, flat: dict[str, np.ndarray]):
        """The params of a checkpoint's flat leaves, on the device."""
        raise NotImplementedError

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- checkpoint / resume ----------------------------------------------

    def _rng_words(self) -> np.ndarray:
        """Two uint32 words drawn from the generator, which is then reseeded
        from them: a run that saves continues exactly as one that resumes
        from what it saved (``_reseed``)."""
        words = torch.randint(0, 2**32, (2,), generator=self.generator,
                              device=self.device, dtype=torch.int64).cpu().numpy()
        words = words.astype(np.uint32)
        self._reseed(words)
        return words

    def _reseed(self, words: np.ndarray) -> None:
        w = np.asarray(words, np.uint32).reshape(-1)
        if w.shape != (2,):
            raise ValueError(f"checkpoint rng must be uint32[2], got shape {w.shape}")
        # manual_seed resets the generator's state in place (the state the
        # step graphs registered), so the graphs stay and replay from the
        # new seed, as eager steps would.
        self.generator.manual_seed((int(w[0]) << 32) | int(w[1]))

    def save_checkpoint(self, path: str, tag: str = "last") -> None:
        """Params, Adam state and a uint32[2] ``rng`` in the JAX package's
        format (``.npz`` + ``.meta.json``), which its Trainer resumes. Every
        rank draws the rng words (the generators stay in step); only the
        coordinator writes, then every rank waits at a barrier, so none
        reads or exits before the write lands."""
        flat = {f"params/{k}": v for k, v in ckpt.params_to_jax(self.params).items()}
        flat.update(optim.state_to_jax(self.opt_state))
        flat["rng"] = self._rng_words()
        meta = {"epoch": self.epoch, "best_metric": self.best_metric,
                "plateau": self.plateau._asdict(), "config": self.cfg.to_dict(), "tag": tag}
        if mesh_mod.is_coordinator():
            ckpt.save_flat(path, flat, meta)
        mesh_mod.barrier(f"ckpt:{tag}")

    def load_checkpoint(self, path: str) -> None:
        """Params, Adam state, rng (the generator is reseeded from it),
        epoch, best metric and plateau state from a checkpoint written by
        either package."""
        flat = ckpt.load_flat(path)
        meta = ckpt.load_meta(path)
        self.graphs.drop()
        self.params = self._params_from(flat)
        self.opt_state = optim.state_from_jax(flat, self.device)
        self._reseed(flat["rng"])
        self.epoch = int(meta["epoch"])
        self.best_metric = float(meta["best_metric"])
        self.plateau = optim.PlateauState(**meta["plateau"])

    # ---- main loop --------------------------------------------------------

    def fit(self, resume_from: str | None = None) -> dict[str, Any]:
        """Epochs from ``self.epoch`` to ``train.epochs``: train, validate
        (HR@min(k) every ``eval.eval_every`` epochs), step the plateau
        schedule, write ``last_model`` every epoch and ``best_model`` on a
        new best, stop early on ``eval.patience``."""
        cfg = self.cfg
        if resume_from and os.path.exists(
                resume_from if resume_from.endswith(".npz") else resume_from + ".npz"):
            self.load_checkpoint(resume_from)
            self.log.log("resume", epoch=self.epoch)

        stopper = optim.EarlyStopping(cfg.eval.patience)
        stopper.best = self.best_metric
        os.makedirs(cfg.paths.checkpoint_dir, exist_ok=True)
        best_path = os.path.join(cfg.paths.checkpoint_dir, "best_model")
        last_path = os.path.join(cfg.paths.checkpoint_dir, "last_model")
        history = []
        best_written = False  # did THIS fit() call write best_model?

        for epoch in range(self.epoch, cfg.train.epochs):
            self.epoch = epoch
            with span("trainer.epoch", timed=True) as sp:
                stats = self.train_epoch(epoch)
            stats["epoch_seconds"] = sp.seconds

            val_metric = None
            val = (self.validate() if cfg.eval.eval_every
                   and (epoch + 1) % cfg.eval.eval_every == 0 else None)
            if val is not None:
                val_metric = val[f"hit_rate@{min(cfg.eval.k_values)}"]
                stats.update({f"val_{k}": v for k, v in val.items()})
                stats["val_seconds"] = self.eval_seconds

            # Plateau on the train loss (min mode) or on the val metric (max
            # mode, by negation; epochs without validation leave it as is).
            if cfg.train.lr_plateau_monitor == "val_metric":
                if val_metric is not None:
                    self.plateau = optim.plateau_step(
                        self.plateau, -float(val_metric), factor=cfg.train.lr_plateau_factor,
                        patience=cfg.train.lr_plateau_patience)
            else:
                self.plateau = optim.plateau_step(
                    self.plateau, stats["loss"], factor=cfg.train.lr_plateau_factor,
                    patience=cfg.train.lr_plateau_patience)
            stats["lr"] = self.plateau.lr
            self.log.log_epoch(epoch, **stats)
            history.append(stats)

            self.epoch = epoch + 1
            self.save_checkpoint(last_path, tag="last")
            if val_metric is not None and val_metric > self.best_metric:
                self.best_metric = val_metric
                self.save_checkpoint(best_path, tag="best")
                best_written = True
            if val_metric is not None and stopper.update(val_metric):
                self.log.log("early_stop", epoch=epoch)
                break

        return {"history": history, "best_metric": self.best_metric,
                # Only when this call wrote it: a resumed run restores
                # best_metric without writing best_model.
                "best_path": best_path if best_written else None}


def make_trainer(cfg: Config, data: MovieLensData, logger: MetricsLogger | None = None,
                 device=None) -> TrainLoop:
    """The trainer of ``model.arch``: ``trainer.Trainer`` (PinSage) or
    ``seq_trainer.SeqTrainer`` (HSTU)."""
    arch = cfg.model.arch
    if arch == "pinsage":
        from .trainer import Trainer

        return Trainer(cfg, data, logger, device=device)
    if arch == "hstu":
        from .seq_trainer import SeqTrainer

        return SeqTrainer(cfg, data, logger, device=device)
    raise ValueError(f"unknown model.arch {arch!r} (expected 'pinsage' or 'hstu')")
