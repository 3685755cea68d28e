"""Training traffic: whole epochs of ``Trainer.fit``'s loop body (train the
epoch, which refreshes the neighbourhood tables first; validate on every
validation pair; step the plateau schedule), without its checkpoint writes
and early stopping, from epoch ``start_epoch`` until ``--seconds`` have
passed.

Set-up loads the corpus's CSVs through the port's ingest and builds the
trainer, installs the seeded weights, refreshes the tables twice (the
second replays the refresh's CUDA graph) from the seed's walk stream, then
drives the very trainer the window uses through its first ``check_steps``
steps, through the window's own call (``Trainer.train_steps``) at the
window's epoch, on distinct train pairs, one step a call so that its state
can be read between them; and validates twice (capturing the embedding and
ranks graphs). Once the window has closed, the plain reference follows
those steps and the refresh before them (``follow``, ``compare``).

Metrics: ``train_ex_per_s`` is the training pairs of the window's epochs
over the window's wall time, refresh, steps and validation included.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..reference import pinsage as ref
from . import common


def run(run) -> None:
    from movie_recommendation_engine_tpu_torch.train import optim

    mix = run.spec["mix"]
    start_epoch, n_check = int(mix["start_epoch"]), int(mix["check_steps"])
    cfg = common.port_config(run, common.corpus(run))

    with run.setup():
        eng = common.engine(run, cfg)
        tr = eng.trainer
        params0, tables, batches, num_hard, lr, prog = checked_start(run, tr, cfg, start_epoch,
                                                                     n_check)
        tables = [(i.cpu(), w.cpu()) for i, w in tables]
        rung = [type(pm).__name__ for pm in tr.pool_mats]
        hub = [e for e in tr.log.history if e["event"].startswith("hub_pool")]
        val_pairs = tr.val_pairs
    run.note("setup", setup_s=run.setup_s, rung=rung, hub=hub, num_hard=num_hard,
             check_losses=prog["losses"], val_hr=prog["hr"])

    epochs, n_pairs = [], 0
    captures0 = len(tr.graphs.events) + len(tr.graphs.programs.events)
    from movie_recommendation_engine_tpu_torch.core.graphs import COUNTER_NAMES, read_counts
    counts0 = read_counts()
    log0 = len(tr.log.history)
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
                    val = tr.evaluate(val_pairs)
                    stats["val_seconds"] = time.perf_counter() - tv
                tr.plateau = optim.plateau_step(
                    tr.plateau, stats["loss"], factor=cfg.train.lr_plateau_factor,
                    patience=cfg.train.lr_plateau_patience)
            stats.update({f"val_{k}": v for k, v in val.items()})
            cap = cfg.train.max_pairs_per_epoch
            pairs = tr.train_pairs.shape[0] if cap is None else min(cap, tr.train_pairs.shape[0])
            stats["pairs"] = pairs
            epochs.append(stats)
            n_pairs += pairs
            ep += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
    run.e2e["train_ex_per_s"] = n_pairs / run.window_s
    counts = [b - a for a, b in zip(counts0, read_counts())]
    captures = len(tr.graphs.events) + len(tr.graphs.programs.events) - captures0
    run.records.update(
        epochs=epochs, launches=dict(zip(COUNTER_NAMES, counts)),
        shapes=_pool_shapes(tr, cfg, num_hard), cfg=cfg, num_hard=num_hard,
        steps=sum(_steps(e["pairs"], cfg.train.batch_size, tr.steps_per_call) for e in epochs),
        embed_passes=len(epochs),
        refresh_s=[e["seconds"] for e in tr.log.history[log0:] if e["event"] == "neighborhoods"])
    run.attempted = len(epochs)
    run.note("window", epochs=len(epochs), window_s=run.window_s, captures_in_window=captures,
             launches=run.records["launches"],
             per_epoch=[{k: e[k] for k in ("loss", "step_ms_avg", "refresh_seconds",
                                           "step_wall_seconds", "val_seconds", "num_hard")}
                        for e in epochs[:3] + epochs[3:][-1:]])
    if captures:
        run.note("warning", what="graphs captured inside the window", count=captures)

    start = common.Start(eng)
    prog = {k: (v.cpu() if torch.is_tensor(v) else
                {n: t.cpu() for n, t in v.items()} if k in ("m1", "params") else v)
            for k, v in prog.items()}
    del eng, tr
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    want = follow(run, start, params0, tables, batches, num_hard, lr, ref.Precision("f32"),
                  prog["params"])
    compare(run, prog, want, params0, start)


def checked_start(run, tr, cfg, start_epoch: int, n_check: int):
    """Set-up's work on the trainer the window uses: the seeded weights, a
    refresh (eager) and a second from the seed's walk stream (which
    captures the refresh graph), then ``n_check`` steps through
    ``Trainer.train_steps`` at the window's epoch on distinct train pairs
    from the seed's step stream, one a call so that Adam's first moment can
    be read after the first; then validation twice (capturing the embedding
    and ranks graphs). Returns (weights, the checked refresh's tables, the
    batches, num_hard, lr, the program's outputs)."""
    params0 = common.make_params(common.sub_seed(run.seed, common.PARAMS),
                                 **common.model_dims(cfg), device=tr.device)
    common.install_params(tr, params0)
    tr.epoch = start_epoch
    tr.refresh_neighborhoods()
    tr.generator.manual_seed(common.sub_seed(run.seed, common.WALKS))
    tr.refresh_neighborhoods()
    tables = [(i.detach().clone(), w.detach().clone()) for i, w in tr.nbr_tables]
    rng = np.random.default_rng(common.sub_seed(run.seed, common.TRAFFIC))
    bsz = min(cfg.train.batch_size, tr.train_pairs.shape[0] // n_check)
    rows = tr.train_pairs[rng.choice(tr.train_pairs.shape[0], n_check * bsz, replace=False)]
    batches = rows.reshape(n_check, bsz, 2)
    num_hard = tr.epoch_batches(start_epoch)[4]
    lr = tr.plateau.lr
    tr.generator.manual_seed(common.sub_seed(run.seed, common.STEPS))
    prog = {"losses": []}
    for s in range(n_check):
        loss = tr.train_steps(batches[s:s + 1, :, 0], batches[s:s + 1, :, 1], lr,
                              float(start_epoch), num_hard)
        prog["losses"].append(float(loss[0]))
        if s == 0:
            prog["m1"] = {k: v.detach().clone() for k, v in ref.leaves(tr.opt_state.mu).items()}
    prog["params"] = {k: v.detach().clone() for k, v in ref.leaves(tr.params).items()}
    for _ in range(2):
        val = tr.evaluate(tr.val_pairs)
    prog["hr"] = {k: val[f"hit_rate@{k}"] for k in cfg.eval.k_values}
    prog["emb"] = tr.movie_embeddings().detach().clone()
    return params0, tables, batches, num_hard, lr, prog


def _steps(pairs: int, batch: int, per_call: int) -> int:
    """Steps an epoch of ``pairs`` takes: whole batches, padded to whole
    blocks of ``min(per_call, batches)`` (``Trainer.epoch_batches``)."""
    batches = -(-pairs // batch)
    block = min(per_call, batches)
    return -(-batches // block) * block


def _pool_shapes(tr, cfg, num_hard: int) -> dict:
    """The gather-pool calls of one step and one embedding pass, for the
    kernel roofline reader: (rows reached, width, rows pooled, slots)."""
    from movie_recommendation_engine_tpu_torch.ops.hub_pool import HubPool

    n, h = tr.table_rows, cfg.model.hidden_dim
    b = cfg.train.batch_size
    batch_rows = 2 * b + min(cfg.train.num_negative_samples, tr.data.num_movies) + b * num_hard
    layers = []
    for pm in tr.pool_mats:
        if isinstance(pm, HubPool):
            layers.append(int(pm.res_nbrs.shape[1]))
    return {"n": n, "d": h, "batch_rows": batch_rows, "hub_residuals": layers,
            "gather_impl": tr.gather_impl}


def follow(run, start, params0, tables, batches, num_hard: int, lr: float,
           prec: ref.Precision, emb_params: dict, loss_rows: int | None = None) -> dict:
    """The reference's run of the refresh (``tables_mismatch`` against the
    program's ``tables``) and of the checked steps from ``params0``; then
    its embedding pass and validation at ``emb_params``, the params the
    program reached (read to judge the program's embedding pass and
    validation at the same point: the steps are judged on their own, and
    Adam's first steps turn the smallest gradient differences into sign
    flips that a comparison of two embedding passes would read as error)."""
    dev = torch.device(run.device)
    if run.device == "cuda":
        ref.tf32_off()
    mine = common.tables_gap(run, start, tables, dev)
    x = start.x.to(dev)
    eff, info = ref.pooling_tables(start.model, mine, start.rows, start.num_movies)
    run.note("reference_rung", precision=prec.kind, **info)
    tr = start.train
    gen = torch.Generator(device=dev).manual_seed(common.sub_seed(run.seed, common.STEPS))
    draws = [ref.draw_step(gen, start.num_movies,
                           min(tr["num_negative_samples"], start.num_movies),
                           batches.shape[1], num_hard, start.rows, start.model["hidden_dim"],
                           start.model["num_layers"], start.model["dropout"], dev)
             for _ in range(batches.shape[0])]
    bt = [(torch.as_tensor(b[:, 0], device=dev), torch.as_tensor(b[:, 1], device=dev))
          for b in batches]
    out = ref.train_steps(params0, x, eff, bt, draws, lr, start.model["dropout"],
                          tr["nce_temperature"], prec, loss_rows)
    out["m1"] = {k: 0.1 * v for k, v in out["first_grads"].items()}
    judged = ref.rebuild(params0, {k: v.to(dev) for k, v in emb_params.items()})
    out["emb"] = ref.embed_all(judged, x, eff, prec)
    pairs = torch.as_tensor(start.val_pairs, device=dev)
    out["hr"] = ref.hit_rates(out["emb"], pairs, start.k_values, tf32=prec.kind == "fp8")
    return out


def compare(run, prog: dict, want: dict, params0: dict, start) -> dict:
    """The numbers compared, from the program's (or the control's) outputs
    ``prog`` and the reference's ``want``: each step's loss (``loss_gap``:
    the largest gap over the reference's loss); the first gradient as the
    optimizer got it (``grad_gap``, from Adam's first moment after one step)
    and the params' change after the last checked step (``change_gap``),
    each by the worst leaf: the gap between the two norms over the larger
    of the reference's norm and the median leaf's, leaves whose reference
    gradient is under a thousandth of the median leaf's left out; the
    embedding pass's largest row gap (``emb_gap``); and validation's
    largest HR@k gap (``hr_gap``) from ranks taken again in float64 over the
    embeddings that validation ranked."""
    dev = want["emb"].device
    run.check("loss_gap", max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"])))
    g_ref = {k: float(torch.linalg.vector_norm(v)) for k, v in want["first_grads"].items()}
    median = float(np.median(list(g_ref.values())))
    live = [k for k, v in g_ref.items() if v >= 1e-3 * median]
    g_prog = {k: float(torch.linalg.vector_norm(prog["m1"][k].to(dev) / 0.1)) for k in live}
    run.check("grad_gap", max(abs(g_prog[k] - g_ref[k]) / max(g_ref[k], median) for k in live))
    p0 = ref.leaves(params0)
    c_ref = {k: float(torch.linalg.vector_norm(want["params"][k] - p0[k])) for k in live}
    c_prog = {k: float(torch.linalg.vector_norm(prog["params"][k].to(dev) - p0[k]))
              for k in live}
    c_median = float(np.median(list(c_ref.values())))
    run.check("change_gap", max(abs(c_prog[k] - c_ref[k]) / max(c_ref[k], c_median)
                                for k in live))
    worst, median_row = common.row_gap(prog["emb"].to(dev), want["emb"])
    run.check("emb_gap", worst)
    pairs = torch.as_tensor(start.val_pairs, device=dev)
    judged = ref.hit_rates(prog["emb"].to(dev), pairs, start.k_values, dtype=torch.float64)
    run.check("hr_gap", max(abs(prog["hr"][k] - judged[k]) for k in start.k_values))
    readings = {"losses": prog["losses"], "losses_ref": want["losses"],
                "emb_gap_median": median_row, "left_out": sorted(set(g_ref) - set(live)),
                "hr": prog["hr"], "hr_judged": judged, "hr_ref": want["hr"]}
    run.note("reference", **readings)
    return readings
