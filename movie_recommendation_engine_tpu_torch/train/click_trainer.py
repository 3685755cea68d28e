"""Training runtime of DLRM-DCNv2 (``model.arch="dlrm_dcnv2"``,
``models/dlrm.py``) over click samples (``data.source="criteo"``,
``graph/criteo.py``): the train step, the epoch loop, validation by ROC AUC
and checkpoints.

The training split lives on the device whole. An epoch visits
``n // train.batch_size`` batches (the rest of the samples wait for another
epoch's order), the order a permutation drawn on the device from
``train.seed + 1000 + epoch``; a step reads its batch's dense features and
ids from the split by the batch's sample indices.

A step: the bags (``gather_pool`` a feature), the dense part's forward and
backward, Adagrad on the dense parameters, and per table the gradient of
the rows the batch touched (``ops.pool.compact_rows``, ``compact_grad``:
the segment route's passes over the batch's B * K_f slots) and FBGEMM's
row-wise Adagrad on those rows alone (``optim.rowwise_adagrad_update``).
Every shape is fixed by the batch and the bag sizes, and nothing is read
back, so on the card a step replays one CUDA graph (key ``("click_step",
B)``, the first step eager), as the other trainers' steps do
(``loop.TrainLoop``); it repeats bit for bit (no float atomics). The step
adds its lookups and the distinct rows it touched to two device counters,
read once an epoch (``lookups``, ``unique_rows`` in the epoch's stats).

Validation and test score every sample of their split in chunks of
``EVAL_CHUNK`` (one graph per chunk shape on the card) and report ``auc``
(``evaluation.metrics.auc``, on the device) and ``logloss``; ``auc`` is the
metric the plateau, ``best_model`` and early stopping follow. Spans:
``trainer.epoch_batches``, ``trainer.steps``, ``trainer.evaluate``
(``.logits``, ``.auc``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..core import tree
from ..core.device import resolve_device
from ..core.graphs import on_device
from ..core.logging import MetricsLogger, span
from ..evaluation import metrics as eval_metrics
from ..graph.criteo import ClickSplit, CriteoData
from ..models import dlrm
from ..models.pinsage import num_params
from ..ops import pool
from . import optim
from .loop import TrainLoop

EVAL_CHUNK = 65536        # samples a chunk of the validation forward


class DeviceSplit(NamedTuple):
    dense: torch.Tensor          # [n, dense] f32
    sparse: list[torch.Tensor]   # per feature [n, K_f] int32
    labels: torch.Tensor         # [n] f32


class ClickTrainer(TrainLoop):
    """DLRM-DCNv2's data and model state for one config on ``device``."""

    def __init__(self, cfg: Config, data: CriteoData,
                 logger: MetricsLogger | None = None, device=None):
        if cfg.mesh.mesh_shape is not None:
            raise ValueError("model.arch='dlrm_dcnv2' runs on one device (mesh.mesh_shape is set)")
        if not isinstance(data, CriteoData):
            raise TypeError(f"model.arch='dlrm_dcnv2' trains on click samples "
                            f"(data.source='criteo'), got {type(data).__name__}")
        device = resolve_device(device)
        self.dims = dm = dlrm.dims(cfg)
        super().__init__(cfg, data, logger, device,
                         init_params=lambda g: dlrm.init_params(g, dm, device))
        self.batch = cfg.train.batch_size
        if data.train.size < self.batch:
            raise ValueError(f"{data.train.size} training samples, fewer than one batch of "
                             f"{self.batch}")
        self.train_set = _on_device(data.train, device)
        self.ones = [torch.ones((self.batch, k), device=device) for k in dm.bags]
        # Each bag's padding of its compact rows, spread over its table's spare rows.
        self.pad_rows = [rows + torch.arange(self.batch * k, device=device) % dlrm.SPARE_ROWS
                         for k, rows in zip(dm.bags, dm.rows)]
        held_out = [s.size for s in (data.val, data.test) if s is not None]
        self.eval_chunk = min(EVAL_CHUNK, max(held_out))
        self.eval_ones = [torch.ones((self.eval_chunk, k), device=device) for k in dm.bags]
        self._eval_sets: dict[str, tuple] = {}
        # Lookups and distinct rows touched since the epoch began (device).
        self.counts = torch.zeros(2, dtype=torch.int64, device=device)
        self.log.log(
            "init", device=str(device), arch="dlrm_dcnv2", train_samples=data.train.size,
            val_samples=data.val.size, test_samples=data.test.size if data.test else 0,
            dense_params=num_params(dlrm.dense_params(self.params)),
            rows_held=list(dm.rows), table_bytes=sum(t.numel() * 4 for t in self.params["tables"]),
            lookups_per_step=self.batch * sum(dm.bags))

    # ---- optimizer, checkpoints -------------------------------------------

    def _opt_init(self, params) -> optim.AdagradState:
        return optim.adagrad_init(dlrm.dense_params(params), params["tables"])

    def _opt_to_flat(self) -> dict[str, np.ndarray]:
        return optim.adagrad_to_flat(self.opt_state)

    def _opt_from_flat(self, flat: dict[str, np.ndarray]) -> optim.AdagradState:
        return optim.adagrad_from_flat(flat, self.device)

    def _params_from(self, flat: dict[str, np.ndarray]):
        leaves = {k[len("params/"):]: torch.tensor(np.asarray(v), dtype=torch.float32,
                                                   device=self.device)
                  for k, v in flat.items() if k.startswith("params/")}
        params = tree.unflatten(leaves)
        if not isinstance(params, dict) or set(params) != {"tables", "bottom", "cross", "top"}:
            raise ValueError("not a DLRM-DCNv2 checkpoint: top-level keys "
                             f"{sorted(params) if isinstance(params, dict) else params}")
        return params

    def _val_metric(self, val: dict[str, float]) -> float:
        return val["auc"]

    # ---- train step -------------------------------------------------------

    def batch_of(self, idx: torch.Tensor):
        """(dense [B, dense], ids per feature [B, K_f]) of samples ``idx`` [B]
        of the training split."""
        s = self.train_set
        return s.dense[idx], [x[idx] for x in s.sparse]

    def step(self, idx: torch.Tensor, labels: torch.Tensor, draws=None) -> torch.Tensor:
        """One step on samples ``idx`` [B] int64 with ``labels`` [B] f32 at
        the lr last filled in: the loss, its gradient, Adagrad on the dense
        parameters and row-wise Adagrad on the touched rows of each table.
        DLRM draws nothing, so ``draws`` is unused."""
        dense, ids = self.batch_of(idx)
        loss, grads, d_emb = dlrm.loss_and_grads(self.params, dense, ids, self.ones, labels,
                                                 self.dims, self.compute_dtype)
        optim.adagrad_update(grads, self.opt_state.sum, dlrm.dense_params(self.params), self._lr)
        self.update_tables(ids, d_emb)
        return loss

    def update_tables(self, ids: list[torch.Tensor], d_emb: torch.Tensor) -> None:
        """Row-wise Adagrad of each table over the rows ``ids[f]`` touched,
        from the bags' gradient ``d_emb`` [B, F, d]; counts the lookups and
        the distinct rows. A bag touches at most its table's held rows, so
        the update takes the compact rows up to that many (the rest are
        padding)."""
        unique = []
        for f, (table, acc, i, w, pad, rows) in enumerate(zip(
                self.params["tables"], self.opt_state.rows, ids, self.ones, self.pad_rows,
                self.dims.rows)):
            c = pool.compact_rows(i, spare=pad)
            d_rows = pool.compact_grad(d_emb[:, f].contiguous(), i, w, c)
            n = min(d_rows.shape[0], rows)
            optim.rowwise_adagrad_update(table, acc, c.rows[:n], d_rows[:n], self._lr)
            unique.append(c.count)
        self.counts[0].add_(sum(x.numel() for x in ids))
        self.counts[1].add_(torch.stack(unique).sum())

    def graph_inputs(self) -> tuple:
        return (self.train_set, self.ones, self.pad_rows, self.eval_ones, self.counts)

    def _block(self, idx_blk, labels_blk) -> tuple:
        """A block's sample indices (int64) and labels (f32) on the device,
        the step graph's key (batch) and the step."""
        idx_blk = torch.as_tensor(idx_blk, dtype=torch.int64, device=self.device)
        labels_blk = torch.as_tensor(labels_blk, dtype=torch.float32, device=self.device)
        return idx_blk, labels_blk, ("click_step", int(idx_blk.shape[1])), self.step

    # ---- epoch loop -------------------------------------------------------

    def epoch_batches(self, epoch: int) -> tuple:
        """The epoch's batches on the device, sample indices [S, B] int64 and
        their labels [S, B] f32: a permutation of the training split drawn on
        the device from ``train.seed + 1000 + epoch``, cut into S = n // B
        batches. Returns (indices, labels, block, samples); the counters
        start again from 0."""
        n, b = self.data.train.size, self.batch
        steps = n // b
        g = torch.Generator(device=self.device).manual_seed(self.cfg.train.seed + 1000 + epoch)
        idx = torch.randperm(n, generator=g, device=self.device)[:steps * b].view(steps, b)
        self.counts.zero_()
        return idx, self.train_set.labels[idx], min(self.steps_per_call, steps), steps * b

    def _epoch_stats(self, batches: tuple, times) -> dict[str, Any]:
        lookups, unique = self.counts.tolist()
        return {"examples_per_sec": batches[3] / max(times.seconds, 1e-9),
                "steps": int(batches[0].shape[0]), "samples": batches[3],
                "lookups": lookups, "unique_rows": unique}

    # ---- evaluation -------------------------------------------------------

    def _eval_set(self, split: str) -> tuple:
        """(the split on the device padded to whole chunks with sample 0, its
        labels unpadded) of ``split`` ("val" or "test")."""
        if split not in self._eval_sets:
            s = getattr(self.data, split)
            if s is None:
                raise ValueError(f"no {split} split in {self.data.data_dir}")
            pad = (-s.size) % self.eval_chunk
            rows = np.concatenate([np.arange(s.size), np.zeros(pad, np.int64)])
            self._eval_sets[split] = (_on_device(ClickSplit(
                s.dense[rows], [x[rows] for x in s.sparse], s.labels[rows]), self.device),
                on_device(self.device, s.labels, torch.float32))
        return self._eval_sets[split]

    @torch.no_grad()
    def split_logits(self, split: str = "val", params=None) -> torch.Tensor:
        """[n] f32 logits of every sample of ``split`` at ``params`` (``self.
        params`` if None), in chunks of ``eval_chunk``: replays of one graph
        where ``graphed`` and ``params`` is None or ``self.params``."""
        data, labels = self._eval_set(split)
        c = self.eval_chunk
        out = [self._cached_call(("click_eval", c), self._chunk_logits, params,
                                 (data.dense[s:s + c], *[x[s:s + c] for x in data.sparse]),
                                 check=s == 0)
               for s in range(0, data.labels.shape[0], c)]
        return torch.cat(out)[:labels.shape[0]]

    def _chunk_logits(self, params, dense, *ids) -> torch.Tensor:
        return dlrm.predict(params, dense, list(ids), self.eval_ones, self.dims,
                            self.compute_dtype)

    def evaluate(self, pairs: np.ndarray | None = None, params=None) -> dict[str, float]:
        """``auc`` and ``logloss`` of the test split (the validation split
        where there is none) at ``params``; its duration is kept in
        ``eval_seconds``. Click samples hold their own labels, so it takes
        no ``pairs``."""
        if pairs is not None:
            raise ValueError("model.arch='dlrm_dcnv2' scores held-out click samples; "
                             "it takes no pairs")
        return self._evaluate("test" if self.data.test is not None else "val", params)

    def validate(self) -> dict[str, float]:
        return self._evaluate("val")

    def _evaluate(self, split: str, params=None) -> dict[str, float]:
        with span("trainer.evaluate", timed=True) as sp:
            with span("trainer.evaluate.logits", sync=self.device):
                scores = self.split_logits(split, params)
            with span("trainer.evaluate.auc"):
                labels = self._eval_set(split)[1]
                out = {"auc": float(eval_metrics.auc(scores, labels)),
                       "logloss": float(F.binary_cross_entropy_with_logits(scores, labels))}
        self.eval_seconds = sp.seconds
        return out

    def movie_embeddings(self, params=None) -> torch.Tensor:
        raise ValueError("model.arch='dlrm_dcnv2' ranks click samples; it has no item "
                         "embeddings to search")


def _on_device(s: ClickSplit, device: torch.device) -> DeviceSplit:
    return DeviceSplit(on_device(device, s.dense, torch.float32),
                       [on_device(device, x, torch.int32) for x in s.sparse],
                       on_device(device, s.labels, torch.float32))
