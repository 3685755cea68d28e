"""The training loop that every architecture shares: the state every
trainer keeps, the step loop (``train_steps``, one graph replay or eager
step a row of a block), the epoch's block loop (``train_epoch``), ``fit``
(epochs, validation, the plateau schedule, ``last_model`` / ``best_model``
checkpoints, early stopping), checkpoint save and resume in the JAX
package's format, and the generator's checkpointed words.

Where JAX scans a jitted block of steps, compiled once per static argument,
``train_steps`` replays one CUDA graph of the step per row of the block
(``core/graphs.GraphCache.run``): the first step under a key runs eager,
as a real step that also warms the caches, the second captures, and a block
of any length replays. A step graph records one whole step: the draws from
the trainer's generator (registered with the graph, so that each replay
draws new numbers and leaves the generator where an eager step would), the
forward, the loss, the backward and the in-place Adam update; it reads its
batch from two static buffers that each step fills and leaves its loss in a
static scalar. ``lr`` reaches it as a 0-d device tensor filled before each
block. Steps run eager instead, by rule, on the CPU, under a mesh (gloo
stages its collectives through the host) and when the caller passes the
draws; ``graphed = False`` asks for eager steps on the card too.

The step, embedding and encoding graphs share one record (``STATE``) of
what they read besides their inputs: params, Adam state, ``lr``, the
generator and the subclass's ``graph_inputs()``. ``train_steps`` checks it
once a block, an embedding pass once a pass; a moved tensor or another
generator drops them all. A reseed keeps them: ``manual_seed`` resets the
registered generator state in place, and the next replay draws from the new
seed as an eager step would. The per-epoch programs live in
``graphs.programs``, a pool of their own.

A subclass supplies the model and its data: ``trainer.Trainer`` (PinSage)
and ``seq_trainer.SeqTrainer`` (HSTU) over a ``MovieLensData``,
``click_trainer.ClickTrainer`` (DLRM-DCNv2) over a ``CriteoData``. Each
calls ``TrainLoop.__init__`` with its data and the function that draws its
params, and implements ``epoch_batches`` (the
epoch's batches, the first three entries its two [S, ...] batch tensors and
the steps in a block), ``_block`` (a block's batches on the device, its
graph key and its step function), ``graph_inputs``, ``_epoch_stats``,
``validate``, ``evaluate``, ``movie_embeddings`` and ``_params_from``;
``_epoch_steps`` where ``train_steps`` takes more than the block and ``lr``
or a block's last steps pad it; ``_opt_init`` / ``_opt_to_flat`` /
``_opt_from_flat`` and ``_val_metric`` where its optimizer is not Adam or
its validation metric not HR@min(k). ``make_trainer`` picks the subclass of
``model.arch``.
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..core import checkpoint as ckpt
from ..core.graphs import GraphCache
from ..core.logging import MetricsLogger, span
from ..parallel import mesh as mesh_mod
from . import optim

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
STATE = "trainer state"     # the record of what the step, embedding and encoding graphs read


class EpochTimes(NamedTuple):
    """The block loop's clock (host clock, the device synchronized)."""

    seconds: float              # the whole loop, through the losses' readback
    first_block_seconds: float  # the first block: eager steps and captures among them
    timed_steps: int            # the steps after the first block
    timed_seconds: float        # their seconds


class TrainLoop:
    """The state, step loop, block loop, ``fit`` and checkpoints of a
    trainer over a subclass's model on ``device``; ``init_params(generator)``
    draws the params, ``graphed=False`` keeps its programs eager."""

    def __init__(self, cfg: Config, data: Any, logger: MetricsLogger | None,
                 device: torch.device, init_params: Callable, graphed: bool = True):
        self.cfg = cfg
        self.data = data
        self.log = logger or MetricsLogger()
        self.device = device
        if cfg.train.lr_plateau_monitor not in ("train_loss", "val_metric"):
            raise ValueError(
                "train.lr_plateau_monitor must be 'train_loss' or "
                f"'val_metric', got {cfg.train.lr_plateau_monitor!r}")
        # The port's own seeded init and streams: the numbers differ from
        # JAX's; parity comes from injecting JAX's params and draws.
        self.generator = torch.Generator(device=device).manual_seed(cfg.train.seed)
        self.params = init_params(self.generator)
        self.opt_state = self._opt_init(self.params)
        self.compute_dtype = _DTYPES[cfg.train.compute_dtype]
        self.plateau = optim.plateau_init(cfg.train.learning_rate)
        # The step's lr on the device, filled before each block, so that a
        # captured step reads the new value.
        self._lr = torch.zeros((), dtype=torch.float32, device=device)
        # Steps, embedding passes and the per-epoch programs replay CUDA
        # graphs on the card; False runs them eager.
        self.graphed = device.type == "cuda" and graphed
        self.graphs = GraphCache(device, self.log, "step_graph",
                                 programs=GraphCache(device, self.log))
        self.epoch = 0
        self.best_metric = -float("inf")
        self.eval_seconds: float | None = None    # seconds of the last ``evaluate``
        self.steps_per_call = 8                   # steps per block of an epoch

    # ---- what a subclass supplies -----------------------------------------

    def epoch_batches(self, epoch: int) -> tuple:
        """The epoch's batches on the device: two [S, ...] tensors whose rows
        are the steps' batches and the steps in a block, first."""
        raise NotImplementedError

    def _epoch_steps(self, epoch: int, batches: tuple) -> tuple[tuple, int | None]:
        """The arguments of ``train_steps`` after ``lr`` at ``epoch``, and
        how many of the epoch's steps are real (the rest pad its last block;
        None: all)."""
        return (), None

    def _block(self, a_blk, b_blk, *args) -> tuple:
        """A block's batches on the device as the step takes them, the key
        of its step graph and its step function ``step(a, b, draws=None)``
        at ``args``."""
        raise NotImplementedError

    def graph_inputs(self) -> tuple:
        """The tensors the step and embedding graphs read besides their
        inputs and the state every trainer keeps (``_reads``)."""
        raise NotImplementedError

    def _epoch_stats(self, batches: tuple, times: EpochTimes) -> dict[str, Any]:
        """An epoch's stats besides the loss and the step times."""
        return {}

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

    def _opt_init(self, params) -> Any:
        """The optimizer's state for ``params``: Adam's."""
        return optim.adam_init(params)

    def _opt_to_flat(self) -> dict[str, np.ndarray]:
        """The optimizer's state as checkpoint leaves."""
        return optim.state_to_jax(self.opt_state)

    def _opt_from_flat(self, flat: dict[str, np.ndarray]) -> Any:
        return optim.state_from_jax(flat, self.device)

    def _val_metric(self, val: dict[str, float]) -> float:
        """The validation metric the plateau, ``best_model`` and early
        stopping follow (higher is better): HR@min(k)."""
        return val[f"hit_rate@{min(self.cfg.eval.k_values)}"]

    # ---- steps and epochs -------------------------------------------------

    def _reads(self) -> tuple:
        """What the step, embedding and encoding graphs read besides their
        inputs (their record, ``STATE``)."""
        return (self.params, self.opt_state, self._lr, self.generator, self.graph_inputs())

    def train_steps(self, a_blk, b_blk, lr: float, *args,
                    draws: list | None = None) -> torch.Tensor:
        """Steps over the rows of ``a_blk``, ``b_blk`` [S, ...] at ``args``
        (``_block``): per step the draws (``draws[s]`` if given, else drawn
        from the generator), the loss, its gradient and an in-place Adam
        update at ``lr``; replays of the step's graph where ``graphed`` and
        no draws are given. Returns the [S] f32 losses on the device,
        without waiting for them."""
        a_blk, b_blk, key, step = self._block(a_blk, b_blk, *args)
        self._lr.fill_(lr)
        losses = torch.empty(a_blk.shape[0], dtype=torch.float32, device=self.device)
        graphed = self.graphed and draws is None
        for s in range(a_blk.shape[0]):
            if graphed:
                losses[s] = self.graphs.run(key, step, (a_blk[s], b_blk[s]),
                                            reads=None if s else self._reads(), record=STATE,
                                            generator=self.generator, copy=False)
            else:
                losses[s] = step(a_blk[s], b_blk[s], None if draws is None else draws[s])
        return losses

    def train_epoch(self, epoch: int) -> dict[str, Any]:
        """One epoch's steps: ``epoch_batches`` (span
        ``trainer.epoch_batches``), then ``train_steps`` block by block
        (span ``trainer.steps``, through the losses' readback). Stats:
        ``loss`` (the mean over the real steps), ``step_ms_avg`` (the mean
        over the steps after the first block), ``step_wall_seconds`` and the
        subclass's ``_epoch_stats``."""
        with span("trainer.epoch_batches"):
            batches = self.epoch_batches(epoch)
            self._sync()
        a_all, b_all, block = batches[:3]
        args, real = self._epoch_steps(epoch, batches)
        step_losses = []
        t_after_first = None
        with span("trainer.steps", timed=True) as steps:
            for s0 in range(0, a_all.shape[0], block):
                step_losses.append(self.train_steps(a_all[s0:s0 + block], b_all[s0:s0 + block],
                                                    self.plateau.lr, *args))
                if t_after_first is None:
                    self._sync()
                    t_after_first = time.time_ns()
            losses = torch.cat(step_losses).cpu().numpy()[:real]
        times = EpochTimes(steps.seconds, (t_after_first - steps.start_ns) / 1e9,
                           a_all.shape[0] - block, (steps.end_ns - t_after_first) / 1e9)
        return {
            "loss": float(losses.mean()),
            "step_ms_avg": (times.timed_seconds / times.timed_steps * 1e3
                            if times.timed_steps else float("nan")),
            "step_wall_seconds": round(steps.seconds, 2),
            **self._epoch_stats(batches, times),
        }

    def _cached_call(self, key: tuple, fn: Callable, params=None, inputs: tuple = (),
                     check: bool = True) -> Any:
        """``fn(params, *inputs)`` at ``params`` (``self.params`` if None):
        where ``graphed`` and ``params`` is ``self.params``, which the graph
        reads in place, a replay of its graph under ``key`` on the steps'
        record (checked first with ``check``: once a pass); else eager."""
        p = self.params if params is None else params
        if self.graphed and p is self.params:
            return self.graphs.run(key, partial(fn, p), inputs,
                                   reads=self._reads() if check else None, record=STATE)
        return fn(p, *inputs)

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
        flat.update(self._opt_to_flat())
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
        self.opt_state = self._opt_from_flat(flat)
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
                val_metric = self._val_metric(val)
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


def make_trainer(cfg: Config, data: Any, logger: MetricsLogger | None = None,
                 device=None) -> TrainLoop:
    """The trainer of ``model.arch``: ``trainer.Trainer`` (PinSage),
    ``seq_trainer.SeqTrainer`` (HSTU) or ``click_trainer.ClickTrainer``
    (DLRM-DCNv2, the one that takes ``data.source="criteo"``)."""
    arch = cfg.model.arch
    if (arch == "dlrm_dcnv2") != (cfg.data.source == "criteo"):
        raise ValueError(f"model.arch={arch!r} with data.source={cfg.data.source!r}: "
                         "'dlrm_dcnv2' trains on 'criteo' click samples, and only it does")
    if arch == "pinsage":
        from .trainer import Trainer

        return Trainer(cfg, data, logger, device=device)
    if arch == "hstu":
        from .seq_trainer import SeqTrainer

        return SeqTrainer(cfg, data, logger, device=device)
    if arch == "dlrm_dcnv2":
        from .click_trainer import ClickTrainer

        return ClickTrainer(cfg, data, logger, device=device)
    raise ValueError(f"unknown model.arch {arch!r} (expected 'pinsage', 'hstu' or "
                     "'dlrm_dcnv2')")
