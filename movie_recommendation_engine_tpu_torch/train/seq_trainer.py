"""Training runtime of HSTU (``model.arch="hstu"``, ``models/hstu.py``): each
user's rating history in time order, the train step, the epoch loop,
validation and checkpoints.

The split is leave-two-out (``graph/split.leave_two_out``): a user's newest
item is the test target, the one before it the validation target, and the
rest train. An epoch visits every user whose train window holds a target,
in batches of ``train.batch_size`` users, each window the newest
``hstu_max_len + 1`` train items: the forward over its first
``hstu_max_len`` slots, position i predicting slot i + 1, every real
target supervised against ``train.num_negative_samples`` uniform negatives
of its own. The last batch is padded with empty windows, which supervise
nothing.

Validation and test rank each user's held-out item over all items by the
dot product of the user's state (the output at the last input position,
its query time the held-out item's timestamp) with the L2-normalised item
table, through the ranks graph (``evaluation.metrics.query_ranks``): HR@k,
NDCG@k and MRR.

The step loop, the block loop, the plateau schedule, early stopping and
checkpoints (``train_steps``, ``train_epoch``, ``fit``, ``save_checkpoint``)
are ``loop.TrainLoop``'s, the Adam update ``optim``'s, as for PinSage. As
there, on the card a step replays one CUDA graph (key ``("seq_step", B,
window)``, the first step eager), the user encoding one graph per chunk
shape and the item table one graph; the CPU, ``draws=`` and ``graphed =
False`` run eager. Spans: ``trainer.epoch_batches`` (the permutation on the
host and the windows' gather on the device), ``trainer.steps``,
``trainer.evaluate`` (``.embed``: the user states and the item table,
``.ranks``). Each epoch's stats give ``positions`` (supervised targets),
``pad_slots`` (padding slots of its [B, hstu_max_len] inputs), and
``real_slots`` and ``attn_pairs`` (real positions, and the pairs of their
causal triangles) for a FLOP count.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import Config
from ..core import tree
from ..core.device import resolve_device
from ..core.graphs import on_device
from ..core.logging import MetricsLogger, span
from ..evaluation import metrics as eval_metrics
from ..graph.dataset import MovieLensData
from ..models import hstu
from ..models.pinsage import num_params
from ..parallel import sharding
from . import optim
from .loop import TrainLoop

ENCODE_BATCH = 1024        # users a chunk of the validation encoding


class SeqTrainer(TrainLoop):
    """HSTU's dataset and model state for one config on ``device``."""

    def __init__(self, cfg: Config, data: MovieLensData,
                 logger: MetricsLogger | None = None, device=None):
        if cfg.mesh.mesh_shape is not None:
            raise ValueError("model.arch='hstu' runs on one device (mesh.mesh_shape is set)")
        device = resolve_device(device)
        self.dims = hstu.dims(cfg)
        super().__init__(cfg, data, logger, device, init_params=lambda g: hstu.init_params(
            g, data.num_movies, self.dims, device))
        self.length = self.dims.max_len
        self.window = self.length + 1
        self.num_items = data.num_movies
        self.hist = data.histories(self.window)
        h = self.hist
        self.train_users = np.flatnonzero(h.train_lengths >= 2)
        if self.train_users.shape[0] == 0:
            raise ValueError("no training targets: no user has four or more ratings")
        # The train windows on the device, one empty row last (the padding).
        self.empty_row = h.train_ids.shape[0]
        self.train_ids = on_device(self.device, _with_empty(h.train_ids, -1), torch.int32)
        self.train_ts = on_device(self.device, _with_empty(h.train_ts, 0), torch.int64)
        self._eval_sets: dict[str, tuple] = {}
        self.log.log(
            "init", device=str(self.device), arch="hstu", num_movies=data.num_movies,
            num_users=data.num_users, num_params=num_params(self.params),
            train_users=int(self.train_users.shape[0]),
            val_users=int((h.val_lengths >= 2).sum()),
            test_users=int((h.test_lengths >= 2).sum()), window=self.window)

    # ---- train step -------------------------------------------------------

    def draw_step(self, b: int) -> hstu.Draws:
        return hstu.draw_step(self.generator, b, self.length,
                              self.cfg.train.num_negative_samples, self.num_items, self.dims,
                              self.device)

    def loss_and_grads(self, ids: torch.Tensor, ts: torch.Tensor, draws: hstu.Draws):
        """The loss of windows ``ids``, ``ts`` [B, window] and its gradient
        in every parameter, at ``self.params``."""
        temperature = self.cfg.train.nce_temperature
        return sharding.loss_and_grads(
            lambda params: hstu.seq_loss(params, ids, ts, draws, self.dims, temperature,
                                         self.compute_dtype),
            self.params)

    def step(self, ids: torch.Tensor, ts: torch.Tensor,
             draws: hstu.Draws | None = None) -> torch.Tensor:
        """One step at the lr last filled in: the draws (drawn unless
        given), the loss, its gradient and an in-place Adam update."""
        d = draws if draws is not None else self.draw_step(int(ids.shape[0]))
        loss, grads = self.loss_and_grads(ids, ts, d)
        optim.adam_update(grads, self.opt_state, self.params, self._lr)
        return loss

    def graph_inputs(self) -> tuple:
        return (self.train_ids, self.train_ts)

    def _block(self, ids_blk, ts_blk) -> tuple:
        """A block's windows on the device, ``ids`` int32 and ``ts`` int64,
        the step graph's key (batch, window) and the step."""
        ids_blk = torch.as_tensor(ids_blk, dtype=torch.int32, device=self.device)
        ts_blk = torch.as_tensor(ts_blk, dtype=torch.int64, device=self.device)
        return ids_blk, ts_blk, ("seq_step", int(ids_blk.shape[1]), self.window), self.step

    # ---- epoch loop -------------------------------------------------------

    def epoch_batches(self, epoch: int) -> tuple:
        """The epoch's windows on the device, ``ids``, ``ts`` [S, B,
        window]: the train users in a permutation from ``train.seed + 1000 +
        epoch``, the last batch padded with empty windows. Returns (ids,
        ts, block, counts), ``counts`` the epoch's ``positions``, ``slots``
        (of its inputs), ``pad_slots``, ``real_slots`` and ``attn_pairs``."""
        users = self.train_users[np.random.default_rng(
            self.cfg.train.seed + 1000 + epoch).permutation(self.train_users.shape[0])]
        b = min(self.cfg.train.batch_size, users.shape[0])
        rows = np.concatenate([users, np.full((-users.shape[0]) % b, self.empty_row)])
        rows = on_device(self.device, rows.reshape(-1, b), torch.int64)
        n = self.hist.train_lengths[users]
        real = np.minimum(n, self.length)
        slots = rows.shape[0] * b * self.length
        counts = {"positions": int((n - 1).sum()), "slots": slots,
                  "pad_slots": int(slots - real.sum()),
                  "real_slots": int(real.sum()),
                  "attn_pairs": int((real * (real + 1) // 2).sum())}
        block = min(self.steps_per_call, rows.shape[0])
        return self.train_ids[rows], self.train_ts[rows], block, counts

    def _epoch_stats(self, batches: tuple, times) -> dict[str, Any]:
        counts = batches[3]
        return {"examples_per_sec": counts["positions"] / max(times.seconds, 1e-9),
                "steps": int(batches[0].shape[0]), **counts}

    # ---- inference / eval -------------------------------------------------

    @torch.no_grad()
    def movie_embeddings(self, params=None) -> torch.Tensor:
        """[num_movies, d] f32 L2-normalised item table: a replay of its
        graph where ``graphed`` and ``params`` is None or ``self.params``."""
        return self._cached_call(("items",), hstu.item_table, params)

    def _eval_set(self, split: str) -> tuple:
        """(ids, ts [Q', window] on the device, padded to whole chunks with
        empty windows; the state's position [Q'] and the targets [Q]) of the
        users with a ``split`` target and an item before it."""
        if split not in self._eval_sets:
            ids = getattr(self.hist, f"{split}_ids")
            ts = getattr(self.hist, f"{split}_ts")
            n = getattr(self.hist, f"{split}_lengths")
            users = np.flatnonzero(n >= 2)
            chunk = max(1, min(ENCODE_BATCH, users.shape[0]))
            pad = (-users.shape[0]) % chunk
            rows = np.concatenate([users, np.full(pad, -1)])
            pos = np.where(rows >= 0, n[rows] - 2, 0)
            targets = ids[users, n[users] - 1]
            self._eval_sets[split] = (
                on_device(self.device, np.where(rows[:, None] >= 0, ids[rows], -1), torch.int32),
                on_device(self.device, np.where(rows[:, None] >= 0, ts[rows], 0), torch.int64),
                on_device(self.device, pos, torch.int64),
                on_device(self.device, targets, torch.int64), chunk)
        return self._eval_sets[split]

    @torch.no_grad()
    def user_states(self, split: str = "val", params=None) -> tuple[torch.Tensor, torch.Tensor]:
        """([Q, d] f32 user states, [Q] targets) of ``split`` ("val" or
        "test"), in chunks of ``ENCODE_BATCH`` users: replays of one graph
        per chunk shape where ``graphed`` and ``params`` is None or
        ``self.params``."""
        ids, ts, pos, targets, chunk = self._eval_set(split)
        out = [self._cached_call(("encode", chunk, self.window), self._last_state, params,
                                 (ids[s:s + chunk], ts[s:s + chunk], pos[s:s + chunk]),
                                 check=s == 0)
               for s in range(0, ids.shape[0], chunk)]
        return torch.cat(out)[:targets.shape[0]], targets

    def _last_state(self, params, ids, ts, pos) -> torch.Tensor:
        states = hstu.encode(params, ids[:, :self.length], ts, self.dims,
                             dtype=self.compute_dtype)
        return states[torch.arange(ids.shape[0], device=ids.device), pos]

    def evaluate(self, pairs: np.ndarray | None = None, params=None) -> dict[str, float]:
        """HR@k, NDCG@k and MRR of the test users' held-out items at
        ``params``; its duration is kept in ``eval_seconds``. HSTU holds out
        each user's newest ratings, so it takes no ``pairs``."""
        if pairs is not None:
            raise ValueError("model.arch='hstu' evaluates each user's held-out item; "
                             "it takes no pairs")
        return self._evaluate("test", params)

    def validate(self) -> dict[str, float]:
        return self._evaluate("val")

    def _evaluate(self, split: str, params=None) -> dict[str, float]:
        with span("trainer.evaluate", timed=True) as sp:
            with span("trainer.evaluate.embed", sync=self.device):
                states, targets = self.user_states(split, params)
                items = self.movie_embeddings(params)
            with span("trainer.evaluate.ranks"):
                ranks = eval_metrics.query_ranks(items, states, targets,
                                                 graphs=self.graphs.programs,
                                                 graphed=self.graphed)
                out = eval_metrics.rank_metrics(ranks.cpu().numpy(), self.cfg.eval.k_values,
                                                self.cfg.eval.mrr_scale)
        self.eval_seconds = sp.seconds
        return out

    def _params_from(self, flat: dict[str, np.ndarray]):
        leaves = {k[len("params/"):]: torch.tensor(np.asarray(v), dtype=torch.float32,
                                                   device=self.device)
                  for k, v in flat.items() if k.startswith("params/")}
        params = tree.unflatten(leaves)
        if not isinstance(params, dict) or not {"item_emb", "pos_emb", "blocks"} <= set(params):
            raise ValueError("not an HSTU checkpoint: top-level keys "
                             f"{sorted(params) if isinstance(params, dict) else params}")
        return params


def _with_empty(a: np.ndarray, fill) -> np.ndarray:
    return np.concatenate([a, np.full((1, a.shape[1]), fill, dtype=a.dtype)])

