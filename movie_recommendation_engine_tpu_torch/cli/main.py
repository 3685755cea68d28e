"""CLI of the PyTorch port:

    python -m movie_recommendation_engine_tpu_torch <mode> [--device cuda|cpu]
        [--set key=value ...]

Modes (those of ``movie_recommendation_engine_tpu/cli/main.py``): train |
evaluate | recommend | benchmark | tune | demo | serve | download | all.
``train --resume`` resumes from ``last_model``, ``train --profile DIR``
writes a ``torch.profiler`` trace of training to ``DIR/trace.json``; ``tune``
searches ``--lrs`` x ``--hidden-dims``; ``demo`` reads commands from stdin;
``all`` runs train, evaluate and recommend. ``--checkpoint`` takes a
JAX-format checkpoint (without ``.npz``) or a reference ``.pt``.
``--device`` (default ``cuda``) replaces the JAX CLI's ``--platform``; a run
asked to use CUDA on a machine without it fails.

Under ``torchrun`` every entry first joins the process group (NCCL on
``cuda``, gloo with ``--device cpu``; log event ``distributed_init``), so a
multi-device run is

    torchrun --nproc-per-node=N -m movie_recommendation_engine_tpu_torch train \
        --set mesh.mesh_shape=[d,m] --set mesh.shard_tables=true

Config overrides use dotted keys into the typed Config, e.g.
    --set search.search_method=lsh --set data.data_dir=/data/ml-25m
"""

from __future__ import annotations

import argparse
import ast
import csv
import os
import sys

import numpy as np

from ..config import Config, default_config
from ..core import checkpoint as ckpt
from ..core.logging import TRACE_FILE, MetricsLogger, trace

MODES = ("train", "evaluate", "recommend", "benchmark", "tune", "demo", "serve",
         "download", "all")


def _parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got: {pair}")
        k, v = pair.split("=", 1)
        # Accept lowercase true/false/none too: `--set x=false` must not
        # become the truthy string "false".
        low = v.strip().lower()
        if low in ("true", "false", "none"):
            out[k] = {"true": True, "false": False, "none": None}[low]
            continue
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def _load_config(args) -> Config:
    cfg = default_config()
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    if args.set:
        cfg = cfg.override(_parse_overrides(args.set))
    return cfg


def _make_trainer(cfg: Config, logger: MetricsLogger, device):
    from ..graph import dataset
    from ..train.trainer import Trainer

    return Trainer(cfg, dataset.load(cfg, logger), logger, device=device)


def _load_checkpoint_if_any(tr, cfg: Config, args, logger) -> None:
    path = args.checkpoint or os.path.join(cfg.paths.checkpoint_dir, "best_model")
    if path.endswith(".pt") and os.path.exists(path):
        from ..utils.torch_import import load_torch_checkpoint

        tr.params, meta = load_torch_checkpoint(path, tr.device)
        logger.log("loaded_torch_checkpoint", path=path, **meta)
    elif os.path.exists(path + ".npz"):
        tr.load_checkpoint(path)
        logger.log("loaded_checkpoint", path=path)


def cmd_train(cfg: Config, args) -> int:
    logger = MetricsLogger()
    tr = _make_trainer(cfg, logger, args.device)
    resume = os.path.join(cfg.paths.checkpoint_dir, "last_model") if args.resume else None
    with trace(args.profile):
        result = tr.fit(resume_from=resume)
    if args.profile:
        logger.log("profile", path=os.path.join(args.profile, TRACE_FILE))
    logger.log("done", best_metric=result["best_metric"])
    return 0


def cmd_evaluate(cfg: Config, args) -> int:
    logger = MetricsLogger()
    tr = _make_trainer(cfg, logger, args.device)
    _load_checkpoint_if_any(tr, cfg, args, logger)
    logger.log("evaluation", **tr.evaluate())
    # Embeddings + the movieId<->idx mapping, as the JAX CLI writes them.
    emb = tr.movie_embeddings().cpu().numpy()
    os.makedirs(cfg.paths.output_dir, exist_ok=True)
    ckpt.save_embeddings(os.path.join(cfg.paths.output_dir, "movie_embeddings"),
                         emb, tr.data.movie_ids)
    with open(os.path.join(cfg.paths.output_dir, "movie_id_mapping.csv"),
              "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["idx", "movieId", "title"])
        for i, mid in enumerate(tr.data.movie_ids):
            w.writerow([i, int(mid), tr.data.titles[i]])
    return 0


def _load_or_compute_embeddings(cfg: Config, args, logger):
    emb_path = os.path.join(cfg.paths.output_dir, "movie_embeddings.npz")
    tr = _make_trainer(cfg, logger, args.device)
    _load_checkpoint_if_any(tr, cfg, args, logger)
    if args.use_saved_embeddings and os.path.exists(emb_path):
        emb, movie_ids = ckpt.load_embeddings(emb_path)
        # Saved rows must correspond 1:1 to this dataset's movie indices.
        if (len(movie_ids) == len(tr.data.movie_ids)
                and np.array_equal(np.asarray(movie_ids, np.int64),
                                   np.asarray(tr.data.movie_ids, np.int64))):
            return tr, emb
        logger.log("saved_embeddings_mismatch", path=emb_path,
                   saved_rows=int(len(movie_ids)),
                   dataset_rows=int(len(tr.data.movie_ids)))
    return tr, tr.movie_embeddings().cpu().numpy()


def cmd_recommend(cfg: Config, args) -> int:
    """Top-k similar movies for --movie-id via the configured search method."""
    import torch

    from ..retrieval.bench import make_index

    logger = MetricsLogger(pretty=False)
    tr, emb = _load_or_compute_embeddings(cfg, args, logger)
    data = tr.data
    lut = data.movie_id_to_idx()
    if args.movie_id is not None and int(args.movie_id) in lut:
        qidx = lut[int(args.movie_id)]
    elif args.movie_id is not None:
        print(f"movieId {args.movie_id} not in dataset")
        return 1
    else:
        qidx = 0

    k = args.k
    method = cfg.search.search_method
    if method == "exact":
        from ..evaluation.metrics import recommend as rec

        e = torch.as_tensor(emb, device=tr.device)
        scores, idx = rec(e, torch.tensor([qidx], device=tr.device), k=k,
                          graphs=tr.graphs.programs, graphed=tr.graphed)
        idx, scores = idx[0].cpu().numpy(), scores[0].cpu().numpy()
    else:
        index = make_index(method, emb.shape[1], cfg, device=tr.device)
        index.build(emb)
        d, i = index.search(emb[qidx:qidx + 1], k=k + 1)
        idx, scores = i[0].cpu().numpy(), -d[0].cpu().numpy()
        keep = idx != qidx
        idx, scores = idx[keep][:k], scores[keep][:k]

    print(f"\nQuery: [{data.movie_ids[qidx]}] {data.titles[qidx]} ({data.genres[qidx]})")
    print(f"Top-{k} recommendations ({method}):")
    rows = []
    for rank, (i, s) in enumerate(zip(idx, scores), 1):
        i = int(i)
        print(f"  {rank:2d}. [{data.movie_ids[i]}] {data.titles[i]} "
              f"({data.genres[i]}) score={float(s):.4f}")
        rows.append((rank, int(data.movie_ids[i]), data.titles[i], float(s)))
    if args.save_csv:
        os.makedirs(cfg.paths.output_dir, exist_ok=True)
        out = os.path.join(cfg.paths.output_dir, "recommendations.csv")
        with open(out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["rank", "movieId", "title", "score"])
            w.writerows(rows)
        print(f"saved {out}")
    return 0


def cmd_benchmark(cfg: Config, args) -> int:
    """exact / LSH / LSH + rerank / IVF latency and recall@k over
    ``--num-queries`` movies drawn from the corpus."""
    from ..retrieval.bench import benchmark_search_methods, print_benchmark

    logger = MetricsLogger(pretty=False)
    tr, emb = _load_or_compute_embeddings(cfg, args, logger)
    rng = np.random.default_rng(cfg.train.seed)
    nq = min(args.num_queries, emb.shape[0])
    q = emb[rng.choice(emb.shape[0], nq, replace=False)]
    methods = ["exact", "lsh", "lsh_rerank", "ivf"]
    if cfg.search.lsh_rerank > 0:
        # The configured LSH already reranks: one row covers both.
        methods.remove("lsh_rerank")
    if cfg.search.search_method not in methods and not (
            cfg.search.search_method == "lsh_rerank" and cfg.search.lsh_rerank > 0):
        methods.append(cfg.search.search_method)
    results = benchmark_search_methods(emb, q, k=args.k, cfg=cfg, methods=methods,
                                       device=tr.device)
    print_benchmark(results, k=args.k)
    return 0


def cmd_tune(cfg: Config, args) -> int:
    from ..train.tune import hyperparameter_tuning

    logger = MetricsLogger()
    kwargs = {}
    if args.lrs:
        kwargs["learning_rates"] = [float(v) for v in args.lrs.split(",") if v.strip()]
    if args.hidden_dims:
        kwargs["hidden_dims"] = [int(v) for v in args.hidden_dims.split(",") if v.strip()]
    result = hyperparameter_tuning(cfg, logger, device=args.device, **kwargs)
    logger.log("tune_done", best=result["best"])
    return 0


def cmd_demo(cfg: Config, args) -> int:
    from .demo import run_demo

    return run_demo(cfg, args)


def cmd_download(cfg: Config, args) -> int:
    from ..graph.download import download_ml25m

    return 0 if download_ml25m(cfg.data.data_dir) else 1


def cmd_serve(cfg: Config, args) -> int:
    """Persistent batched recommendation server over the configured index."""
    from ..retrieval.server import BatchingRecommender, make_http_server

    logger = MetricsLogger()
    tr, emb = _load_or_compute_embeddings(cfg, args, logger)
    rec = BatchingRecommender(
        emb, method=cfg.search.search_method, cfg=cfg,
        max_batch=cfg.serve.max_batch, max_wait_ms=cfg.serve.max_wait_ms,
        max_k=cfg.serve.max_k, device=tr.device,
    )
    port = args.port if args.port is not None else cfg.serve.port
    httpd = make_http_server(rec, cfg.serve.host, port,
                             movie_ids=tr.data.movie_ids, titles=tr.data.titles)
    logger.log("serving", host=cfg.serve.host, port=httpd.server_address[1],
               ntotal=rec.ntotal, method=rec.method, device=str(tr.device))
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        rec.close()
    return 0


def _join_process_group(device: str) -> None:
    """Join ``torchrun``'s process group (a no-op without it, and after the
    first call)."""
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import distributed_init

    if dist.is_initialized() or not distributed_init(
            backend="gloo" if device == "cpu" else "nccl"):
        return
    local = torch.cuda.device_count() if device == "cuda" else 1
    MetricsLogger().log("distributed_init", process_index=dist.get_rank(),
                        process_count=dist.get_world_size(), local_devices=local,
                        global_devices=dist.get_world_size(), backend=dist.get_backend())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="movie_recommendation_engine_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("mode", choices=MODES)
    ap.add_argument("--config", help="path to a Config JSON")
    ap.add_argument("--set", action="append", default=[],
                    help="dotted config override key=value (repeatable)")
    ap.add_argument("--checkpoint", help="checkpoint path (without .npz)")
    ap.add_argument("--movie-id", type=int, help="query movieId for recommend")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--num-queries", type=int, default=256,
                    help="benchmark mode: query count")
    ap.add_argument("--port", type=int, default=None,
                    help="serve mode: listen port (default serve.port)")
    ap.add_argument("--use-saved-embeddings", action="store_true")
    ap.add_argument("--save-csv", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="train mode: resume from checkpoint_dir/last_model")
    ap.add_argument("--profile", metavar="DIR",
                    help="train mode: write a torch.profiler trace of training to DIR")
    ap.add_argument("--lrs", default=None,
                    help="tune mode: comma list of learning rates (default 1e-3,5e-4)")
    ap.add_argument("--hidden-dims", default=None,
                    help="tune mode: comma list of hidden dims (default 128,256)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device to run on (default cuda; fails without it)")
    args = ap.parse_args(argv)
    _join_process_group(args.device)
    cfg = _load_config(args)
    if args.mode == "all":
        return (cmd_train(cfg, args) or cmd_evaluate(cfg, args)
                or cmd_recommend(cfg, args))
    return {"train": cmd_train, "evaluate": cmd_evaluate, "recommend": cmd_recommend,
            "benchmark": cmd_benchmark, "tune": cmd_tune, "demo": cmd_demo,
            "serve": cmd_serve, "download": cmd_download}[args.mode](cfg, args)


if __name__ == "__main__":
    sys.exit(main())
