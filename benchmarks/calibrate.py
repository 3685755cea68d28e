"""The readings the limits of a cell's checks are set from, in one process.

    python3 benchmarks/calibrate.py --workload ml25m-train-full --seeds 11,12,13 \\
        --control-seeds 11,12,13

Set-up is the cell's. Then per seed of ``--seeds`` the program's checked
work at the cell's size (a train cell: the refresh and the checked steps,
validation; a serve cell: the embedding pass and the answers to the
check's sample of requests, asked one batch at a time) and its numbers
against the f32 reference: the lower readings. Per seed of
``--control-seeds`` the control, the reference in the precision below the
configuration's in the program's place (fp8 matmul operands and pooled
tables; a serve cell's search in TF32), and for a train cell the fault of
half of each step's batch left out: the upper readings. Each is judged by
the cell's own limits (its workload file's ``limits``): one JSON line per
reading with ``correct`` and every number beside its limit (a number the
cell does not compare under ``readings``), and all of them in one JSON file
at ``--out`` if given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh(spec, seed, harness):
    return harness.Run(spec, seed, 0.0, False, "cuda")


def train(spec, seeds, control_seeds, harness, emit) -> None:
    import torch

    from benchmarks.drivers import common, train as drv
    from benchmarks.reference import pinsage as ref
    from movie_recommendation_engine_tpu_torch.train import optim

    run0 = _fresh(spec, seeds[0], harness)
    mix = spec["mix"]
    start_epoch, n_check = int(mix["start_epoch"]), int(mix["check_steps"])
    cfg = common.port_config(run0, common.corpus(run0))
    eng = common.engine(run0, cfg)
    tr = eng.trainer
    start = common.Start(eng)

    def program(run):
        with torch.no_grad():         # Adam's state as a fresh trainer's
            for moments in (tr.opt_state.mu, tr.opt_state.nu):
                for t in ref.leaves(moments).values():
                    t.zero_()
            tr.opt_state.step.zero_()
        tr.plateau = optim.plateau_init(cfg.train.learning_rate)
        return drv.checked_start(run, tr, cfg, start_epoch, n_check)

    for seed in sorted(set(seeds) | set(control_seeds)):
        run = _fresh(spec, seed, harness)
        params0, tables, batches, num_hard, lr, prog = program(run)
        want = drv.follow(run, start, params0, tables, batches, num_hard, lr,
                          ref.Precision("f32"), prog["params"])
        if seed in seeds:
            drv.compare(run, prog, want, params0, start)
            emit(seed, "program", run)
        if seed in control_seeds:
            ctrl = _fresh(spec, seed, harness)
            got = drv.follow(ctrl, start, params0, tables, batches, num_hard, lr,
                             ref.Precision("fp8"), prog["params"])
            drv.compare(ctrl, got, want, params0, start)
            emit(seed, "control_fp8", ctrl)
            half = _fresh(spec, seed, harness)
            got = drv.follow(half, start, params0, tables, batches, num_hard, lr,
                             ref.Precision("f32"), prog["params"],
                             loss_rows=batches.shape[1] // 2)
            got["emb"], got["hr"] = want["emb"], want["hr"]
            drv.compare(half, got, want, params0, start)
            emit(seed, "fault_half_batch", half)


def serve(spec, seeds, control_seeds, harness, emit) -> None:
    import numpy as np
    import torch

    from benchmarks.drivers import common, serve as drv
    from benchmarks.reference import pinsage as ref
    from movie_recommendation_engine_tpu_torch.retrieval.server import BatchingRecommender

    run0 = _fresh(spec, seeds[0], harness)
    mix = {**spec["mix"], **run0.params}
    k = int(mix["k"])
    cfg = common.port_config(run0, common.corpus(run0))
    eng = common.engine(run0, cfg)
    tr = eng.trainer
    start = common.Start(eng)
    dims = common.model_dims(cfg)
    n_check = int(mix["check_requests"])

    def answers(emb_np, seed, search):
        rng = np.random.default_rng(common.sub_seed(seed, common.TRAFFIC))
        q, ex = drv.requests(eng.data, emb_np, n_check, rng)
        ids, scores = [], []
        for s in range(0, n_check, 64):
            i_s, sc_s = search(q[s:s + 64], ex[s:s + 64])
            ids += i_s
            scores += sc_s
        return {"queries": q, "excludes": ex, "ids": ids, "scores": scores}

    for seed in sorted(set(seeds) | set(control_seeds)):
        run = _fresh(spec, seed, harness)
        params0 = common.make_params(common.sub_seed(seed, common.PARAMS), **dims, device="cuda")
        common.install_params(tr, params0)
        tr.generator.manual_seed(common.sub_seed(seed, common.WALKS))
        tr.refresh_neighborhoods()
        tables = [(i.detach().clone(), w.detach().clone()) for i, w in tr.nbr_tables]
        emb = tr.movie_embeddings().detach().cpu().numpy()
        want = drv.follow(run, start, params0, tables, ref.Precision("f32"))
        if seed in seeds:
            rec = BatchingRecommender(emb, method=cfg.search.search_method, cfg=cfg,
                                      max_batch=cfg.serve.max_batch,
                                      max_wait_ms=cfg.serve.max_wait_ms,
                                      max_k=cfg.serve.max_k, device="cuda")
            try:
                def search(q, ex):
                    futs = [rec.submit(q[i], k, exclude=ex[i]) for i in range(len(q))]
                    got = [f.result() for f in futs]
                    return [g["indices"] for g in got], [g["scores"] for g in got]
                served = {"emb": torch.as_tensor(emb), **answers(emb, seed, search)}
            finally:
                rec.close()
            drv.compare(run, served, want, k)
            emit(seed, "program", run)
        if seed in control_seeds:
            ctrl = _fresh(spec, seed, harness)
            got = drv.follow(ctrl, start, params0, tables, ref.Precision("fp8"))
            e = got["emb"]

            def search_tf32(q, ex):
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    qt = torch.as_tensor(q, device="cuda")
                    dist = ((qt * qt).sum(1, keepdim=True) + (e * e).sum(1)[None]
                            - 2.0 * (qt @ e.T))
                finally:
                    ref.tf32_off()
                for i, x in enumerate(ex):
                    dist[i, torch.as_tensor(x, device="cuda")] = math.inf
                d, i = torch.topk(dist, k, largest=False)
                return i.cpu().tolist(), (-d).cpu().tolist()
            served = {"emb": e, **answers(e.cpu().numpy(), seed, search_tf32)}
            drv.compare(ctrl, served, want, k)
            emit(seed, "control_fp8_tf32", ctrl)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", help="a JSON file for all the readings")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmarks import harness

    harness.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []

    def emit(seed, kind, run):
        row = {"seed": seed, "kind": kind,
               "correct": all(v <= lim for v, lim in run.checks.values()),
               "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()},
               "readings": dict(run.readings)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    {"train": train, "serve": serve}[spec["mix"]["driver"]](spec, seeds, control, harness, emit)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows,
                       "device": torch.cuda.get_device_name(0)}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
