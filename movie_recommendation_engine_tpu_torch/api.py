"""High-level library API of the PyTorch port.

    from movie_recommendation_engine_tpu_torch import api, default_config

    cfg = default_config()
    cfg.data.source = "synthetic"
    engine = api.train(cfg)                     # -> Engine (trained, on cuda)
    engine = api.load(cfg, checkpoint="checkpoints/best_model")
    emb = engine.embeddings()                   # [num_movies, embed_dim]
    engine.evaluate()                           # HR@k / MRR dict
    engine.recommend(movie_id=3, k=10)          # ranked (movieId, title, score)
    engine.recommend(history=[3, 15, 40], k=10) # user-as-centroid query
    server = engine.serve()                     # BatchingRecommender

Port of ``movie_recommendation_engine_tpu/api.py``.
"""

from __future__ import annotations

import numpy as np

from .config import Config, default_config
from .core.device import resolve_device
from .core.logging import MetricsLogger


class Engine:
    """A loaded dataset + model on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for; raises when CUDA is asked for and absent). Under ``torchrun``
    it joins the process group first, so ``cfg.mesh.mesh_shape`` spans the
    ranks."""

    def __init__(self, cfg: Config | None = None,
                 logger: MetricsLogger | None = None, device=None):
        from .graph import dataset
        from .parallel.mesh import distributed_init
        from .train.loop import make_trainer

        self.device = resolve_device(device)
        # Under torchrun: join the process group (a no-op otherwise).
        distributed_init(backend="gloo" if self.device.type == "cpu" else "nccl")
        self.cfg = cfg or default_config()
        self.log = logger or MetricsLogger(pretty=False)
        self.data = dataset.load(self.cfg, self.log)
        self.trainer = make_trainer(self.cfg, self.data, self.log, device=self.device)
        self._emb: np.ndarray | None = None
        self._emb_device = None          # the same rows on the device

    # -- training / checkpoints ----------------------------------------------

    def fit(self, resume_from: str | None = None) -> dict:
        out = self.trainer.fit(resume_from=resume_from)
        self._emb = None  # embeddings are stale after training
        return out

    def save_checkpoint(self, path: str) -> None:
        self.trainer.save_checkpoint(path)

    def load_checkpoint(self, path: str) -> "Engine":
        """A JAX-format ``.npz`` checkpoint (``core/checkpoint.py``), written
        by either package, or a reference ``.pt`` checkpoint (its params
        only, ``utils/torch_import.py``)."""
        if path.endswith(".pt"):
            from .utils.torch_import import load_torch_checkpoint

            self.trainer.params, meta = load_torch_checkpoint(path, self.device)
            self.log.log("loaded_torch_checkpoint", path=path, **meta)
        else:
            self.trainer.load_checkpoint(path)
        self._emb = None
        return self

    def embeddings(self, refresh: bool = False) -> np.ndarray:
        """[num_movies, embed_dim] L2-normalized item embeddings (cached)."""
        if self._emb is None or refresh:
            self._emb_device = self.trainer.movie_embeddings()
            self._emb = self._emb_device.cpu().numpy()
        return self._emb

    def evaluate(self, pairs: np.ndarray | None = None) -> dict:
        return self.trainer.evaluate(pairs)

    def recommend(self, movie_id: int | None = None,
                  history: list[int] | None = None, k: int = 10,
                  by_index: bool = False) -> list[dict]:
        """Top-k similar items for one movieId or a watch history (external
        movieIds unless ``by_index``). Exact search; ``serve()`` builds a
        batched / ANN server. On ``cuda`` a movieId's top-k is
        ``evaluation.metrics.recommend`` on the card, a replay of its CUDA
        graph from the third call of a ``k`` on (the trainer's
        ``graphs.programs``); a history ranks on the host, as JAX's does."""
        emb = self.embeddings()
        lut = self.data.movie_id_to_idx()

        def to_idx(mid):
            i = int(mid) if by_index else lut.get(int(mid), -1)
            if not 0 <= i < emb.shape[0]:
                raise KeyError(f"unknown movie {mid}")
            return i

        if history:
            idxs = [to_idx(m) for m in history]
            q = emb[idxs].mean(axis=0)
            q /= max(float(np.linalg.norm(q)), 1e-12)
            exclude = set(idxs)
        elif movie_id is not None:
            qi = to_idx(movie_id)
            if self.device.type == "cuda":
                return self._rows(*self._recommend_on_device(qi, k), exclude={qi}, k=k)
            q, exclude = emb[qi], {qi}
        else:
            raise ValueError("pass movie_id or history")

        sims = emb @ q
        order = np.argsort(-sims)
        return self._rows(order, sims[order], exclude, k)

    def _recommend_on_device(self, qi: int, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(indices, scores) of ``qi``'s top min(k, N) rows on the card; the
        query, scored -inf, comes last if at all."""
        import torch

        from .evaluation.metrics import recommend

        tr = self.trainer
        emb = self._emb_device
        kk = min(k, emb.shape[0])
        scores, idx = recommend(emb, torch.tensor([qi], device=self.device), k=kk,
                                graphs=tr.graphs.programs, graphed=tr.graphed)
        return idx[0].cpu().numpy(), scores[0].cpu().numpy()

    def _rows(self, order, scores, exclude, k: int) -> list[dict]:
        out = []
        for i, score in zip(order, scores):
            if int(i) in exclude:
                continue
            out.append({
                "movieId": int(self.data.movie_ids[i]),
                "title": self.data.titles[i],
                "genres": self.data.genres[i],
                "score": float(score),
            })
            if len(out) == k:
                break
        return out

    def serve(self, method: str | None = None, **kw):
        """BatchingRecommender over the current embeddings on this engine's
        device (``retrieval/server.py``); the caller owns ``close()``."""
        from .retrieval.server import BatchingRecommender

        return BatchingRecommender(
            self.embeddings(), method=method or self.cfg.search.search_method,
            cfg=self.cfg, max_batch=self.cfg.serve.max_batch,
            max_wait_ms=self.cfg.serve.max_wait_ms,
            max_k=self.cfg.serve.max_k, device=self.device, **kw,
        )


def train(cfg: Config | None = None, resume_from: str | None = None,
          device=None) -> Engine:
    """Load data per ``cfg``, train to completion, return the Engine."""
    eng = Engine(cfg, device=device)
    eng.fit(resume_from=resume_from)
    return eng


def load(cfg: Config | None = None, checkpoint: str | None = None,
         device=None) -> Engine:
    """Engine with the port's seeded params, or a checkpoint's if given."""
    eng = Engine(cfg, device=device)
    if checkpoint:
        eng.load_checkpoint(checkpoint)
    return eng
