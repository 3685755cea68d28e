"""The serving knee: offers a serving cell's traffic at a list of rates to
one server and reports, at each, the completed rate, the backlog at the
window's close and the latency tail.

    python3 benchmarks/sweep.py --workload ml25m-serve-item --seed 1 --seconds 5 \\
        --rates 1000,2000,4000,8000

Set-up is the cell's (corpus, trainer, seeded weights, one refresh, one
embedding pass, the server). Each rate runs the cell's open-loop schedule
for ``--seconds`` and waits for its answers; one JSON line per rate (and
all of them at ``--out`` if given). The
knee is the highest rate whose completed rate keeps up with the offered
one with no backlog growing over the window; a serving cell offers about
four fifths of it.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", required=True, help="comma-separated requests per second")
    ap.add_argument("--out", help="a JSON file for all the rows")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from benchmarks import harness

    harness.cache_env()
    import numpy as np
    import torch

    from benchmarks.drivers import common, serve

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from movie_recommendation_engine_tpu_torch.retrieval.server import BatchingRecommender

    spec = harness.load_spec(args.workload)
    run = harness.Run(spec, args.seed, args.seconds, False, "cuda")
    mix = {**spec["mix"], **run.params}
    cfg = common.port_config(run, common.corpus(run))
    eng = common.engine(run, cfg)
    tr = eng.trainer
    common.install_params(tr, common.make_params(common.sub_seed(run.seed, common.PARAMS),
                                                 **common.model_dims(cfg), device="cuda"))
    tr.generator.manual_seed(common.sub_seed(run.seed, common.WALKS))
    tr.refresh_neighborhoods()
    emb = tr.movie_embeddings().detach().cpu().numpy()
    rec = BatchingRecommender(emb, method=cfg.search.search_method, cfg=cfg,
                              max_batch=cfg.serve.max_batch, max_wait_ms=cfg.serve.max_wait_ms,
                              max_k=cfg.serve.max_k, device="cuda")
    serve.warm_up(rec, eng.data, emb, {**mix, "rate_per_s": float(args.rates.split(",")[0])},
                  int(mix["k"]), np.random.default_rng(0))
    gc.collect()
    gc.freeze()         # as the cell's set-up ends
    rows = []
    try:
        for rate in [float(r) for r in args.rates.split(",")]:
            rng = np.random.default_rng(common.sub_seed(run.seed, common.TRAFFIC))
            due = serve.schedule(rate, args.seconds, int(rng.integers(2 ** 62)))
            queries, excludes = serve.requests(eng.data, emb, due.shape[0], rng)
            rec.reset_stats()
            out = serve.drive(rec, due, queries, excludes, int(mix["k"]), float(mix["drain_s"]))
            st = rec.stats()
            ok = out["ok"] & ~np.isnan(out["done"])
            lat = (out["done"] - out["due"])[ok] * 1e3
            close = out["t0"] + args.seconds
            row = {"offered_per_s": rate, "requests": int(due.shape[0]),
                   "completed_per_s": float(np.sum(out["done"][ok] <= close)) / args.seconds,
                   "backlog_at_close": int(np.sum(~(out["done"] <= close))),
                   "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
                   "p90_ms": float(np.percentile(lat, 90)) if lat.size else None,
                   "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
                   "generator_late_ms_p99": float(np.nanpercentile(out["sent"] - out["due"], 99)
                                                  * 1e3),
                   "generator_late_ms_max": float(np.nanmax(out["sent"] - out["due"]) * 1e3),
                   "mean_batch": st["mean_batch_size"], "failed": int((~ok).sum())}
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        rec.close()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "seconds": args.seconds, "rows": rows,
                       "device": torch.cuda.get_device_name(0)}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
