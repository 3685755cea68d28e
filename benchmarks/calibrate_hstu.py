"""The readings the limits of the HSTU cell's checks are set from, in one
process (``calibrate.py`` knows the PinSage drivers only).

    python3 benchmarks/calibrate_hstu.py --workload ml20m-hstu-train --seeds 11,12,13 \\
        --control-seeds 11,12,13

Set-up is the cell's. Then per seed of ``--seeds`` the program's checked
work at the cell's size (the seeded weights, the checked steps, validation)
against the f32 reference: the lower readings. Per seed of
``--control-seeds`` what must fail, each in the program's place: the
control, the reference with fp8 e4m3 operands (``control_fp8``); and the
faults ``fault_half_positions`` (the reference with the odd positions out
of the loss), ``fault_no_bias`` (the reference without the relative bias
``rab^{p,t}``) and ``fault_state_unchanged`` (the program's outputs with
Adam's state and the params left as they started). Each is judged by the
cell's own limits: one JSON line per reading with ``correct`` and every
number beside its limit, and all of them in one JSON file at ``--out`` if
given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="ml20m-hstu-train")
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
    from benchmarks.drivers import common, hstu_train as drv
    from benchmarks.reference import hstu as ref
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
    cfg = common.port_config(run0, common.corpus(run0))
    tr = drv.engine(run0, cfg).trainer
    n_check = int(spec["mix"]["check_steps"])
    for seed in sorted(set(seeds) | set(control)):
        with torch.no_grad():         # Adam's state as a fresh trainer's
            for moments in (tr.opt_state.mu, tr.opt_state.nu):
                for t in ref.leaves(moments).values():
                    t.zero_()
            tr.opt_state.step.zero_()
        tr.plateau = optim.plateau_init(cfg.train.learning_rate)
        run = fresh(seed)
        params0, batches, lr, prog = drv.checked_start(run, tr, cfg, n_check)
        start = prog.pop("start")
        want = drv.follow(run, start, params0, batches, lr, ref.Precision("f32"),
                          prog["params"])
        if seed in seeds:
            drv.compare(run, prog, want, params0, start)
            emit(seed, "program", run)
        if seed not in control:
            continue
        for kind, kw in (("control_fp8", {"prec": ref.Precision("fp8")}),
                         ("fault_half_positions", {"half": True}),
                         ("fault_no_bias", {"bias": False})):
            r = fresh(seed)
            got = drv.follow(r, start, params0, batches, lr,
                             kw.get("prec", ref.Precision("f32")), prog["params"],
                             half=kw.get("half", False), bias=kw.get("bias", True))
            if kind == "fault_half_positions":       # judged on its steps alone
                got.update(states=want["states"], items=want["items"], hr=want["hr"])
            drv.compare(r, got, want, params0, start)
            emit(seed, kind, r)
        r = fresh(seed)
        same = dict(prog, params={k: v.detach().clone() for k, v in
                                  ref.leaves(params0).items()},
                    m1={k: torch.zeros_like(v) for k, v in prog["m1"].items()})
        drv.compare(r, same, want, params0, start)
        emit(seed, "fault_state_unchanged", r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows,
                       "device": torch.cuda.get_device_name(0) if args.device == "cuda"
                       else "cpu"}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
