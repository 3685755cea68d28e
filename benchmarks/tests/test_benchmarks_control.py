"""The control: the reference in the precision below the configuration's
(fp8 matmul operands and pooled tables for bf16) put in the program's
place fails the cell's checks. On the card ``benchmarks/calibrate.py`` takes
the same readings at each cell's own size and judges them by its limits;
here at a tiny size, by the same limits."""

import json
import subprocess
import sys

from . import tiny

CONTROL = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
from benchmarks import harness
from benchmarks.drivers import common, train
from benchmarks.reference import pinsage as ref
spec = harness.load_spec("tiny-hub-train")
run = harness.Run(spec, 5, 0.0, False, "cpu")
cfg = common.port_config(run, common.corpus(run))
eng = common.engine(run, cfg)
tr = eng.trainer
params0 = common.make_params(common.sub_seed(5, common.PARAMS), **common.model_dims(cfg),
                             device="cpu")
common.install_params(tr, params0)
tr.generator.manual_seed(common.sub_seed(5, common.WALKS))
tr.refresh_neighborhoods()
tables = [(i.clone(), w.clone()) for i, w in tr.nbr_tables]
batches = tr.train_pairs[np.random.default_rng(0).choice(
    tr.train_pairs.shape[0], 3 * 64, replace=False)].reshape(3, 64, 2)
start = common.Start(eng)
flat = ref.leaves(params0)
want = train.follow(run, start, params0, tables, batches, 6, 1e-3, ref.Precision("f32"), flat)
ctrl = harness.Run(spec, 5, 0.0, False, "cpu")
got = train.follow(ctrl, start, params0, tables, batches, 6, 1e-3, ref.Precision("fp8"), flat)
train.compare(ctrl, got, want, params0, start)
print(json.dumps({{k: [v, lim] for k, (v, lim) in ctrl.checks.items()}}))
"""


def test_fp8_control_fails_the_embedding_check(checkout):
    """Under the committed limits of the cell the tiny one stands for, fp8
    fails ``emb_gap``, the check the cell relies on to catch it."""
    p = subprocess.run([sys.executable, "-c", CONTROL.format(root=checkout)], cwd=checkout,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    checks = json.loads(p.stdout.strip().splitlines()[-1])
    value, limit = checks["emb_gap"]
    assert limit == tiny.limits("ml25m-train-full")["emb_gap"]
    assert value > limit, checks
