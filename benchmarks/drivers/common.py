"""What the train and serve drivers share: the corpus, the port's config,
the engine, the seeded weights, and the reference's check of the walk
tables and of the embedding pass."""

from __future__ import annotations

import io
import time

import torch

from ..corpus import cache
from ..reference import pinsage as ref

# Streams drawn from one --seed: the weights, the walks of the refresh the
# check follows, the train steps' draws, the traffic.
PARAMS, WALKS, STEPS, TRAFFIC = range(4)


def sub_seed(seed: int, stream: int) -> int:
    return (int(seed) * 4 + stream) % (2 ** 63)


def port_config(run, corpus_dir: str):
    """The port's ``Config``: its defaults, then the configuration's
    ``port_config`` and the mix's ``overrides``; the corpus as MovieLens
    CSVs."""
    from movie_recommendation_engine_tpu_torch.config import Config

    dotted = {**run.spec["config"]["port_config"], **run.spec["mix"].get("overrides", {})}
    dotted.update({"data.source": "movielens", "data.data_dir": corpus_dir})
    return Config().override(dotted)


def corpus(run) -> str:
    t0 = time.perf_counter()
    d, gen_s = cache.ensure(run.spec["config"]["corpus"])
    run.note("corpus", dir=d, generated_s=gen_s, ensure_s=time.perf_counter() - t0)
    return d


def engine(run, cfg):
    """``api.Engine`` on the run's device, its log kept in memory (the
    result line is the last line of standard output)."""
    from movie_recommendation_engine_tpu_torch import api
    from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger

    t0 = time.perf_counter()
    eng = api.Engine(cfg, logger=MetricsLogger(stream=io.StringIO(), pretty=False),
                     device=run.device)
    ingest = [e for e in eng.log.history if e["event"] == "ingest"]
    run.note("engine", seconds=time.perf_counter() - t0,
             csv_load_s=ingest[0]["seconds"] if ingest else None,
             rows=eng.data.num_movies, nodes=eng.trainer.csr.num_nodes,
             edges=eng.trainer.csr.num_edges, train_pairs=int(eng.trainer.train_pairs.shape[0]),
             val_pairs=int(eng.trainer.val_pairs.shape[0]))
    return eng


def make_params(seed: int, feature_dim: int, hidden: int, embed: int, num_layers: int,
                device) -> dict:
    """The weights, drawn on the device from ``seed``: He-normal matrices,
    zero biases (the configuration's ``init_style``), in the port's tree."""
    g = torch.Generator(device=device).manual_seed(seed)

    def linear(fan_in, fan_out):
        return {"w": (2.0 / fan_in) ** 0.5 * torch.randn((fan_in, fan_out), generator=g,
                                                         device=device),
                "b": torch.zeros(fan_out, device=device)}

    return {"input_proj": linear(feature_dim, hidden),
            "convs": [{"self": linear(hidden, hidden), "neigh": linear(hidden, hidden),
                       "update": linear(2 * hidden, hidden)} for _ in range(num_layers)],
            "output_proj": linear(hidden, embed)}


def install_params(trainer, params: dict) -> None:
    """Copies ``params`` into the trainer's own tensors (same tree)."""
    mine, theirs = ref.leaves(params), ref.leaves(trainer.params)
    if mine.keys() != theirs.keys():
        raise ValueError(f"parameter trees differ: {sorted(mine)} vs {sorted(theirs)}")
    with torch.no_grad():
        for k, v in mine.items():
            theirs[k].copy_(v)


def model_dims(cfg) -> dict:
    return {"feature_dim": cfg.features.feature_dim, "hidden": cfg.model.hidden_dim,
            "embed": cfg.model.embed_dim, "num_layers": cfg.model.num_layers}


class Start:
    """What the reference starts from, copied off the program before it is
    freed: the interactions, the feature table and the pairs the program's
    ingest made (the start the reference follows, see PERF.md), and the
    configuration's model settings."""

    def __init__(self, eng):
        d, tr = eng.data, eng.trainer
        self.user_idx, self.movie_idx, self.ratings = d.user_idx, d.movie_idx, d.ratings
        self.num_movies, self.num_users = d.num_movies, d.num_users
        self.x = tr.x_table.detach().float().cpu()
        self.rows = tr.table_rows
        self.val_pairs = tr.val_pairs
        c = tr.cfg
        self.model = vars(c.model).copy()
        self.walk = vars(c.walk).copy()
        self.train = vars(c.train).copy()
        self.k_values = tuple(c.eval.k_values)


def tables_gap(run, start: Start, program_tables, device) -> list:
    """The reference's walk tables from the WALKS stream, checked against
    the program's: the share of table slots whose id or weight differs
    (``tables_mismatch``). Returns the reference's tables."""
    g = ref.bipartite_graph(start.user_idx, start.movie_idx, start.ratings, start.num_movies,
                            start.num_users, device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(run.seed, WALKS))
    w = start.walk
    counted = start.num_movies if w["count_nodes"] == "movies" else g.num_nodes
    mine = ref.walk_tables(g, start.rows, start.model["num_layers"], w["num_walks"],
                           w["walk_length"], w["num_neighbors"], counted, gen)
    slots = differ = 0
    for (ri, rw), (pi, pw) in zip(mine, program_tables):
        pi, pw = pi.to(device), pw.to(device)
        differ += int(((ri != pi) | (rw != pw)).sum())
        slots += ri.numel()
    run.check("tables_mismatch", differ / slots)
    return mine


def row_gap(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(largest, median) L2 distance between matching rows."""
    d = torch.linalg.vector_norm(a.float() - b.float(), dim=1)
    return float(d.max()), float(d.median())
