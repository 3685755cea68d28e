"""DLRM-DCNv2 training traffic (``model.arch="dlrm_dcnv2"`` on
``data.source="criteo"``): whole epochs of the port's click trainer over
every sample of the training split (batches drawn in a new order each
epoch), each followed by validation (AUC) on every held-out sample and the
plateau schedule, without ``fit``'s checkpoint writes and early stopping,
from epoch ``start_epoch`` until ``--seconds`` have passed.

Set-up loads the corpus (``corpus/criteo.py``, written once per checkout)
through the port's reader and builds the trainer, installs the seeded
weights (the PARAMS stream, ``reference.dlrm.init_tables`` / ``init_dense``,
one table at a time), then drives the very trainer the window uses through
``check_steps`` steps on distinct training samples (the TRAFFIC stream),
through the window's own call (``ClickTrainer.train_steps``), one step a
call so that the first step's gradient norms can be read from Adagrad's
accumulators; keeps the touched rows and the dense parameters it reached
and its logits on every held-out sample; then validates twice (capturing
the evaluation graph). Once the window has closed and the program is freed,
the plain reference (``reference/dlrm.py``) remakes the seeded weights,
follows those steps and scores the held-out samples at the params the
program reached, in blocks (``follow``, ``compare``).

Metrics: ``train_ex_per_s`` is the training samples of the window's whole
epochs over the window's wall time, steps and validation included.
``run.records["dlrm"]`` holds the model's sizes, each epoch's samples,
steps, lookups and distinct rows, and the validation pass's chunks and
distinct rows, for ``benchmarks/yardstick/dlrm.py``.
"""

from __future__ import annotations

import gc
import io
import time

import numpy as np
import torch

from ..corpus import criteo
from ..reference import dlrm as ref
from . import common


def port_config(run, data_dir: str):
    """The port's ``Config``: its defaults, then the configuration's
    ``port_config`` and the mix's ``overrides``; the corpus as Criteo
    arrays."""
    from movie_recommendation_engine_tpu_torch.config import Config

    dotted = {**run.spec["config"]["port_config"], **run.spec["mix"].get("overrides", {})}
    dotted.update({"data.source": "criteo", "data.data_dir": data_dir})
    return Config().override(dotted)


def dims(cfg) -> ref.Dims:
    m = cfg.model
    return ref.Dims(m.dlrm_dense_features, tuple(m.dlrm_bag_sizes),
                    tuple(m.dlrm_rows_held) or tuple(m.dlrm_table_rows),
                    tuple(m.dlrm_table_rows), m.embed_dim, tuple(m.dlrm_bottom),
                    tuple(m.dlrm_top), m.dlrm_cross_layers, m.dlrm_cross_rank)


def engine(run, cfg):
    """``api.Engine`` on the run's device, its log kept in memory."""
    from movie_recommendation_engine_tpu_torch import api
    from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger

    t0 = time.perf_counter()
    eng = api.Engine(cfg, logger=MetricsLogger(stream=io.StringIO(), pretty=False),
                     device=run.device)
    ingest = [e for e in eng.log.history if e["event"] == "ingest"]
    run.note("engine", seconds=time.perf_counter() - t0,
             load_s=ingest[0]["seconds"] if ingest else None,
             train_samples=eng.data.train.size, val_samples=eng.data.val.size,
             click_rate=float(eng.data.train.labels.mean()))
    return eng


def run(run) -> None:
    from movie_recommendation_engine_tpu_torch.train import optim

    mix = run.spec["mix"]
    start_epoch, n_check = int(mix["start_epoch"]), int(mix["check_steps"])
    # The config first: a port without the model fails here, before the corpus is written.
    cfg = port_config(run, criteo.corpus_dir(run.spec["config"]["corpus"]))
    t0 = time.perf_counter()
    d, gen_s = criteo.ensure(run.spec["config"]["corpus"])
    run.note("corpus", dir=d, generated_s=gen_s, ensure_s=time.perf_counter() - t0)

    with run.setup():
        eng = engine(run, cfg)
        tr = eng.trainer
        batches, lr, prog = checked_start(run, tr, cfg, n_check)
    run.note("setup", setup_s=run.setup_s, check_losses=prog["losses"], val_auc=prog["auc"])

    epochs, n_samples = [], 0
    captures0 = len(tr.graphs.events) + len(tr.graphs.programs.events)
    with run.window():
        t0 = time.perf_counter()
        ep = start_epoch
        while True:
            tr.epoch = ep
            with run.span("epoch"):
                with run.span("train_epoch"):
                    stats = tr.train_epoch(ep)
                with run.span("validate"):
                    tv = time.perf_counter()
                    val = tr.validate()
                    stats["val_seconds"] = time.perf_counter() - tv
                tr.plateau = optim.plateau_step(
                    tr.plateau, stats["loss"], factor=cfg.train.lr_plateau_factor,
                    patience=cfg.train.lr_plateau_patience)
            stats.update({f"val_{k}": v for k, v in val.items()})
            epochs.append(stats)
            n_samples += stats["samples"]
            ep += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
    run.e2e["train_ex_per_s"] = n_samples / run.window_s
    captures = len(tr.graphs.events) + len(tr.graphs.programs.events) - captures0
    run.records.update(epochs=epochs, dlrm={
        "dims": dims(cfg)._asdict(), "batch": tr.batch,
        "epochs": [{k: e[k] for k in ("samples", "steps", "lookups", "unique_rows")}
                   for e in epochs],
        "val": _val_rows(tr)})
    run.attempted = len(epochs)
    run.note("window", epochs=len(epochs), window_s=run.window_s, captures_in_window=captures,
             per_epoch=[{k: e[k] for k in ("loss", "step_ms_avg", "step_wall_seconds",
                                           "val_seconds", "val_auc", "lookups", "unique_rows")}
                        for e in epochs[:3] + epochs[3:][-1:]])
    if captures:
        run.note("warning", what="graphs captured inside the window", count=captures)

    val = eng.data.val
    start = {"val": (val.dense, val.sparse), "labels": torch.from_numpy(val.labels),
             "dims": dims(cfg)}
    del eng, tr
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    want = follow(run, start, batches, lr, ref.Precision("f32"), prog)
    compare(run, prog, want, start)


def _val_rows(tr) -> dict:
    """The validation pass's chunks and the distinct rows each chunk's bags
    read, summed over chunks and features."""
    data, _ = tr._eval_set("val")
    c = tr.eval_chunk
    rows = sum(int(torch.unique(x[s:s + c]).numel()) for x in data.sparse
               for s in range(0, x.shape[0], c))
    return {"chunk": c, "chunks": data.labels.shape[0] // c, "unique_rows": rows}


def checked_start(run, tr, cfg, n_check: int):
    """Set-up's work on the trainer the window uses: the seeded weights, then
    ``n_check`` steps through ``ClickTrainer.train_steps`` on distinct
    training samples, one a call (the first step's gradient norms read from
    Adagrad's accumulators after it), then the params reached on the rows
    the steps touched, the logits of every held-out sample, and validation
    twice (capturing the evaluation graph). Returns (the checked batches on
    the host, lr, the program's outputs)."""
    dev, dm = tr.device, dims(cfg)
    seed = common.sub_seed(run.seed, common.PARAMS)
    with torch.no_grad():
        for mine, t in zip(tr.params["tables"], ref.init_tables(seed, dm, dev)):
            mine[:t.shape[0]].copy_(t)
            mine[t.shape[0]:].zero_()
            del t
        dense = ref.init_dense(seed, dm, dev)
        theirs = ref.dense_leaves({k: tr.params[k] for k in ("bottom", "cross", "top")})
        for k, v in ref.dense_leaves(dense).items():
            theirs[k].copy_(v)
    rng = np.random.default_rng(common.sub_seed(run.seed, common.TRAFFIC))
    b = tr.batch
    idx = torch.as_tensor(rng.choice(tr.data.train.size, n_check * b, replace=False),
                          device=dev).view(n_check, b)
    labels = tr.train_set.labels[idx]
    lr = tr.plateau.lr
    prog = {"losses": []}
    for s in range(n_check):
        loss = tr.train_steps(idx[s:s + 1], labels[s:s + 1], lr)
        prog["losses"].append(float(loss[0]))
        if s == 0:
            acc = tr.opt_state
            norms = {k: float(v.sum().sqrt()) for k, v in ref.dense_leaves(acc.sum).items()}
            norms.update({f"tables/{f}": float((a.sum() * dm.d).sqrt())
                          for f, a in enumerate(acc.rows)})
            prog["norms"] = norms
    s = tr.train_set
    batches = [(s.dense[i].cpu(), [x[i].cpu() for x in s.sparse], s.labels[i].cpu())
               for i in idx]
    prog["touched"] = [torch.unique(x[idx].reshape(-1)).long() for x in s.sparse]
    prog["rows"] = [t[r].cpu() for t, r in zip(tr.params["tables"], prog["touched"])]
    prog["touched"] = [r.cpu() for r in prog["touched"]]
    prog["dense"] = {k: v.detach().cpu().clone() for k, v in ref.dense_leaves(
        {k: tr.params[k] for k in ("bottom", "cross", "top")}).items()}
    prog["logits"] = tr.split_logits("val").cpu()
    for _ in range(2):
        val = tr.validate()
    prog["auc"] = val["auc"]
    return batches, lr, prog


def follow(run, start: dict, batches: list, lr: float, prec: ref.Precision, prog: dict,
           fault: ref.Fault = ref.Fault()) -> dict:
    """The reference's run of the checked steps from the seeded weights
    (remade on the device one table at a time), with ``prec`` and
    ``fault``; then its logits of every held-out sample at the params the
    program reached (``prog``'s touched rows over the seeded tables, and
    its dense parameters), read to judge the program's logits at the same
    point."""
    dev = torch.device(run.device)
    if run.device == "cuda":
        ref.tf32_off()
    dm = start["dims"]
    seed = common.sub_seed(run.seed, common.PARAMS)
    tables = list(ref.init_tables(seed, dm, dev))
    dense0 = ref.init_dense(seed, dm, dev)
    touched = [r.to(dev) for r in prog["touched"]]
    rows0 = [t[r].clone() for t, r in zip(tables, touched)]
    bt = [(x.to(dev), [i.to(dev) for i in ids], y.to(dev)) for x, ids, y in batches]
    out = ref.train_steps(tables, dense0, bt, lr, prec, fault)
    out["rows"] = [t[r].clone() for t, r in zip(tables, touched)]
    out["rows0"] = rows0
    out["dense0"] = ref.dense_leaves(dense0)
    with torch.no_grad():
        for t, r, v in zip(tables, touched, prog["rows"]):
            t[r] = v.to(dev)
    judged = {part: [{k: prog["dense"][f"{part}/{i}/{k}"].to(dev) for k in layer}
                     for i, layer in enumerate(dense0[part])] for part in dense0}
    out["logits"] = ref.logits(tables, judged, start["val"], prec, fault)
    del tables
    return out


def compare(run, prog: dict, want: dict, start: dict) -> dict:
    """The numbers compared, from the program's (or a stand-in's) outputs
    ``prog`` and the reference's ``want``: each step's loss (``loss_gap``:
    the largest gap over the reference's loss); the first gradient's norm
    (``grad_gap``) and the params' change after the last checked step
    (``change_gap``), each by the worst leaf, a table's touched rows one
    leaf: the gap between the two norms over the larger of the reference's
    norm and the median leaf's, leaves whose reference gradient is under a
    thousandth of the median leaf's left out; the held-out logits at the
    program's params (``logit_gap``: the norm of their difference over the
    norm of the reference's); and, read only, ``auc_gap``: the program's
    validation AUC against the AUC of its own logits counted again in
    float64."""
    dev = want["logits"].device
    run.check("loss_gap", max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"])))
    g_ref = want["norms"]
    median = float(np.median(list(g_ref.values())))
    live = [k for k, v in g_ref.items() if v >= 1e-3 * median]
    run.check("grad_gap", max(abs(prog["norms"][k] - g_ref[k]) / max(g_ref[k], median)
                              for k in live))
    c_ref, c_prog = {}, {}
    for k in live:
        if k.startswith("tables/"):
            f = int(k.split("/")[1])
            r0 = want["rows0"][f]
            c_ref[k] = float(torch.linalg.vector_norm(want["rows"][f] - r0))
            c_prog[k] = float(torch.linalg.vector_norm(prog["rows"][f].to(dev) - r0))
        else:
            p0 = want["dense0"][k]
            c_ref[k] = float(torch.linalg.vector_norm(want["dense"][k] - p0))
            c_prog[k] = float(torch.linalg.vector_norm(prog["dense"][k].to(dev) - p0))
    c_median = float(np.median(list(c_ref.values())))
    run.check("change_gap", max(abs(c_prog[k] - c_ref[k]) / max(c_ref[k], c_median)
                                for k in live))
    lg = prog["logits"].to(dev)
    run.check("logit_gap", float(torch.linalg.vector_norm(lg - want["logits"])
                                 / torch.linalg.vector_norm(want["logits"])))
    judged = ref.auc(prog["logits"], start["labels"])
    run.check("auc_gap", abs(prog["auc"] - judged))
    readings = {"losses": prog["losses"], "losses_ref": want["losses"],
                "left_out": sorted(set(g_ref) - set(live)), "auc": prog["auc"],
                "auc_judged": judged, "auc_ref": ref.auc(want["logits"], start["labels"]),
                "touched_rows": [int(r.shape[0]) for r in want["rows0"]]}
    run.note("reference", **readings)
    return readings
