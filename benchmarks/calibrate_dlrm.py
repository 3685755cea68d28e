"""The readings the limits of the DLRM-DCNv2 cell's checks are set from, in
one process (``calibrate.py`` knows the PinSage drivers only).

    python3 benchmarks/calibrate_dlrm.py --workload criteo-dlrm-train --seeds 11,12,13 \\
        --control-seeds 11,12

Set-up is the cell's. Then per seed of ``--seeds`` the program's checked
work at the cell's size (the seeded weights, the checked steps, the
held-out logits) against the f32 reference: the lower readings. Per seed of
``--control-seeds`` what must fail, each in the program's place: the
control, the reference with fp8 e4m3 matmul operands (``control_fp8``);
and the faults ``fault_half_batch`` (the odd samples out of the loss),
``fault_no_x0`` (the cross layers without ``x0 *``) and
``fault_skip_table`` (the update of table 0, a row-wise sharded one,
skipped). Each is judged by the cell's own limits: one JSON line per
reading with ``correct`` and every number beside its limit, and all of them
in one JSON file at ``--out`` if given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="criteo-dlrm-train")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", help="a JSON file for all the readings")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmarks import harness

    harness.cache_env()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from benchmarks.corpus import criteo
    from benchmarks.drivers import click_train as drv
    from benchmarks.reference import dlrm as ref
    from movie_recommendation_engine_tpu_torch.core import tree
    from movie_recommendation_engine_tpu_torch.train import optim

    spec = harness.load_spec(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []

    def fresh(seed):
        return harness.Run(spec, seed, 0.0, False, args.device)

    def emit(seed, kind, run):
        row = {"seed": seed, "kind": kind,
               "correct": all(v <= lim for v, lim in run.checks.values()),
               "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()},
               "readings": dict(run.readings)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    run0 = fresh(seeds[0])
    d, _ = criteo.ensure(spec["config"]["corpus"])
    cfg = drv.port_config(run0, d)
    eng = drv.engine(run0, cfg)
    tr = eng.trainer
    val = eng.data.val
    n_check = int(spec["mix"]["check_steps"])
    for seed in sorted(set(seeds) | set(control)):
        with torch.no_grad():         # Adagrad's state as a fresh trainer's
            for t in tree.leaves(tr.opt_state._asdict()):
                t.zero_()
        tr.plateau = optim.plateau_init(cfg.train.learning_rate)
        run = fresh(seed)
        batches, lr, prog = drv.checked_start(run, tr, cfg, n_check)
        start = {"val": (val.dense, val.sparse), "labels": torch.from_numpy(val.labels),
                 "dims": drv.dims(cfg)}
        want = drv.follow(run, start, batches, lr, ref.Precision("f32"), prog)
        if seed in seeds:
            drv.compare(run, prog, want, start)
            emit(seed, "program", run)
        if seed not in control:
            continue
        for kind, prec, fault in (("control_fp8", "fp8", ref.Fault()),
                                  ("fault_half_batch", "f32", ref.Fault(half=True)),
                                  ("fault_no_x0", "f32", ref.Fault(no_x0=True)),
                                  ("fault_skip_table", "f32", ref.Fault(skip=0))):
            r = fresh(seed)
            got = drv.follow(r, start, batches, lr, ref.Precision(prec), prog, fault)
            got["auc"] = ref.auc(got["logits"], start["labels"])
            drv.compare(r, got, want, start)
            emit(seed, kind, r)
            del got
        del want
        if args.device == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows,
                       "device": torch.cuda.get_device_name(0) if args.device == "cuda"
                       else "cpu"}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
