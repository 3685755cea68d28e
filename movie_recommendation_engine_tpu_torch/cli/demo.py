"""Interactive demo: search movies, show details, get recommendations.

Port of ``movie_recommendation_engine_tpu/cli/demo.py`` (reference
``demo.py:195-286``): a command loop with title substring search,
recommendations by movieId and a most-popular listing, which also reads
commands piped on stdin. It uses the embeddings in
``output/movie_embeddings.npz`` when present, else computes them on the
device from the best checkpoint (or the seeded params).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def run_demo(cfg, args) -> int:
    from ..core import checkpoint as ckpt
    from ..core.device import resolve_device
    from ..core.graphs import GraphCache
    from ..core.logging import MetricsLogger
    from ..evaluation.metrics import recommend
    from ..graph import dataset

    device = resolve_device(getattr(args, "device", None))
    logger = MetricsLogger(pretty=False)
    data = dataset.load(cfg, logger)
    emb_path = os.path.join(cfg.paths.output_dir, "movie_embeddings.npz")
    if os.path.exists(emb_path):
        emb, _ = ckpt.load_embeddings(emb_path)
        print(f"loaded embeddings from {emb_path}")
    else:
        from ..train.trainer import Trainer

        tr = Trainer(cfg, data, logger, device=device)
        best = os.path.join(cfg.paths.checkpoint_dir, "best_model")
        if os.path.exists(best + ".npz"):
            tr.load_checkpoint(best)
        emb = tr.movie_embeddings().cpu().numpy()
    emb_t = torch.as_tensor(emb, device=device)
    graphs = GraphCache(device)      # recommend's graphs (on cuda)

    # Popularity = rating count per movie.
    pop = np.bincount(data.movie_idx, minlength=data.num_movies)

    def show(i: int) -> None:
        tags = data.movie_tags[i][:120] if data.movie_tags else ""
        ratings = data.ratings[data.movie_idx == i]
        avg = float(ratings.mean()) if ratings.size else float("nan")
        print(f"[{data.movie_ids[i]}] {data.titles[i]} | {data.genres[i]} | "
              f"avg rating {avg:.2f} ({pop[i]} ratings)"
              + (f" | tags: {tags}" if tags else ""))

    def do_search(q: str) -> None:
        ql = q.lower()
        hits = [i for i, t in enumerate(data.titles) if ql in t.lower()][:15]
        if not hits:
            print("no matches")
        for i in hits:
            show(i)

    def do_recommend(movie_id: int, k: int = 10) -> None:
        lut = data.movie_id_to_idx()
        if movie_id not in lut:
            print(f"movieId {movie_id} not found")
            return
        qidx = lut[movie_id]
        print("query:")
        show(qidx)
        _, idx = recommend(emb_t, torch.tensor([qidx], device=device), k=k, graphs=graphs)
        print("recommendations:")
        for i in idx[0].cpu().numpy():
            show(int(i))

    def do_popular(k: int = 10) -> None:
        for i in np.argsort(-pop)[:k]:
            show(int(i))

    menu = "\ncommands: search <text> | recommend <movieId> | popular | quit"
    print(f"{data.num_movies} movies loaded.{menu}")
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            return 0
        if not line:
            continue
        cmd, _, rest = line.partition(" ")
        if cmd in ("quit", "exit", "q"):
            return 0
        if cmd == "search" and rest:
            do_search(rest)
        elif cmd == "recommend" and rest:
            try:
                do_recommend(int(rest))
            except ValueError:
                print("usage: recommend <movieId>")
        elif cmd == "popular":
            do_popular()
        else:
            print(menu)
