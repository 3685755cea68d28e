"""HSTU training traffic (``model.arch="hstu"``): whole epochs of the port's
sequence trainer over every training user's history (batches of users, each
history cut to its newest ``hstu_max_len`` inputs, every position supervised
against its own negatives), each followed by validation on every user and
the plateau schedule, without ``fit``'s checkpoint writes and early
stopping, from epoch ``start_epoch`` until ``--seconds`` have passed.

Set-up loads the corpus's CSVs through the port's ingest, builds the
trainer, installs the seeded weights (the PARAMS stream,
``reference.hstu.init``), then drives the very trainer the window uses
through ``check_steps`` steps of distinct train users (the TRAFFIC stream),
through the window's own call (``SeqTrainer.train_steps``), one step a call
so that Adam's first moment can be read after the first, its generator
seeded from the STEPS stream; then validates twice (capturing the encoding
and ranks graphs). Once the window has closed and the program is freed, the
plain reference (``reference/hstu.py``) follows those steps from the same
weights with the same draws and encodes the validation users at the params
the program reached.

Metrics: ``train_ex_per_s`` is the supervised positions (real next-item
targets) of the window's epochs over the window's wall time, steps and
validation included. ``run.records["hstu"]`` holds each epoch's counts and
the model's sizes for ``benchmarks/yardstick/hstu.py``.
"""

from __future__ import annotations

import gc
import io
import time

import numpy as np
import torch

from ..reference import hstu as ref
from . import common


def dims(cfg) -> ref.Dims:
    m = cfg.model
    return ref.Dims(m.embed_dim, m.num_layers, m.hstu_heads, m.hstu_dqk, m.hstu_dv,
                    m.hstu_max_len, ref.TIME_BUCKETS, m.dropout, ref.LINEAR_DROPOUT)


def engine(run, cfg):
    """``api.Engine`` on the run's device, its log kept in memory."""
    from movie_recommendation_engine_tpu_torch import api
    from movie_recommendation_engine_tpu_torch.core.logging import MetricsLogger

    t0 = time.perf_counter()
    eng = api.Engine(cfg, logger=MetricsLogger(stream=io.StringIO(), pretty=False),
                     device=run.device)
    tr, h = eng.trainer, eng.trainer.hist
    lengths = h.history_lengths[h.history_lengths > 0]
    run.note("engine", seconds=time.perf_counter() - t0, rows=eng.data.num_movies,
             users=eng.data.num_users, ratings=int(eng.data.user_idx.shape[0]),
             train_users=int(tr.train_users.shape[0]),
             history_mean=float(lengths.mean()), history_median=float(np.median(lengths)),
             history_min=int(lengths.min()),
             share_full_window=float((h.train_lengths >= tr.window).mean()))
    return eng


def run(run) -> None:
    from movie_recommendation_engine_tpu_torch.train import optim

    mix = run.spec["mix"]
    start_epoch, n_check = int(mix["start_epoch"]), int(mix["check_steps"])
    cfg = common.port_config(run, common.corpus(run))

    with run.setup():
        eng = engine(run, cfg)
        tr = eng.trainer
        params0, batches, lr, prog = checked_start(run, tr, cfg, n_check)
    run.note("setup", setup_s=run.setup_s, check_losses=prog["losses"], val_hr10=prog["hr"])

    epochs, n_pos = [], 0
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
            n_pos += stats["positions"]
            ep += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
    run.e2e["train_ex_per_s"] = n_pos / run.window_s
    captures = len(tr.graphs.events) + len(tr.graphs.programs.events) - captures0
    dm = dims(cfg)
    run.records.update(epochs=epochs, hstu={
        "dims": dm._asdict(), "negatives": cfg.train.num_negative_samples,
        "epochs": [{k: e[k] for k in ("positions", "slots", "pad_slots", "real_slots",
                                      "attn_pairs")} for e in epochs]})
    run.attempted = len(epochs)
    run.note("window", epochs=len(epochs), window_s=run.window_s, captures_in_window=captures,
             per_epoch=[{k: e[k] for k in ("loss", "step_ms_avg", "step_wall_seconds",
                                           "val_seconds", "positions", "pad_slots",
                                           "val_hit_rate@10", "val_ndcg@10")}
                        for e in epochs[:3] + epochs[3:][-1:]])
    if captures:
        run.note("warning", what="graphs captured inside the window", count=captures)

    start = prog.pop("start")
    prog = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
                else v.cpu() if torch.is_tensor(v) else v) for k, v in prog.items()}
    del eng, tr
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    want = follow(run, start, params0, batches, lr, ref.Precision("f32"), prog["params"])
    compare(run, prog, want, params0, start)


def checked_start(run, tr, cfg, n_check: int):
    """Set-up's work on the trainer the window uses: the seeded weights,
    ``n_check`` steps through ``SeqTrainer.train_steps`` on distinct train
    users, one a call (Adam's first moment read after the first), then
    validation twice. Returns (weights, the checked windows [S, B, window]
    ids and ts on the host, lr, the program's outputs with ``start``: what
    the reference reads)."""
    dev = tr.device
    params0 = ref.init(common.sub_seed(run.seed, common.PARAMS), tr.num_items, dims(cfg), dev)
    common.install_params(tr, params0)
    rng = np.random.default_rng(common.sub_seed(run.seed, common.TRAFFIC))
    bsz = min(cfg.train.batch_size, tr.train_users.shape[0] // n_check)
    users = rng.choice(tr.train_users, n_check * bsz, replace=False).reshape(n_check, bsz)
    rows = torch.as_tensor(users, device=dev)
    ids, ts = tr.train_ids[rows], tr.train_ts[rows]
    lr = tr.plateau.lr
    tr.generator.manual_seed(common.sub_seed(run.seed, common.STEPS))
    prog = {"losses": []}
    for s in range(n_check):
        loss = tr.train_steps(ids[s:s + 1], ts[s:s + 1], lr)
        prog["losses"].append(float(loss[0]))
        if s == 0:
            prog["m1"] = {k: v.detach().clone() for k, v in ref.leaves(tr.opt_state.mu).items()}
    prog["params"] = {k: v.detach().clone() for k, v in ref.leaves(tr.params).items()}
    for _ in range(2):
        val = tr.validate()
    prog["hr"] = val["hit_rate@10"]
    prog["states"], targets = tr.user_states("val")
    prog["items"] = tr.movie_embeddings().detach().clone()
    v_ids, v_ts, v_pos, _, _ = tr._eval_set("val")
    q = targets.shape[0]
    prog["start"] = {"batches": (ids.cpu(), ts.cpu()), "val_ids": v_ids[:q].cpu(),
                     "val_ts": v_ts[:q].cpu(), "val_pos": v_pos[:q].cpu(),
                     "targets": targets.cpu(), "num_items": tr.num_items,
                     "dims": dims(cfg), "negatives": cfg.train.num_negative_samples,
                     "temperature": cfg.train.nce_temperature}
    return params0, (ids.cpu(), ts.cpu()), lr, prog


def follow(run, start: dict, params0: dict, batches, lr: float, prec: ref.Precision,
           emb_params: dict, half: bool = False, bias: bool = True) -> dict:
    """The reference's run of the checked steps from ``params0`` with the
    draws of the STEPS stream, then its user states and item table at
    ``emb_params``, the params the program reached (judged there, as the
    PinSage cells judge their embedding pass)."""
    dev = torch.device(run.device)
    if run.device == "cuda":
        ref.tf32_off()
    dm = start["dims"]
    ids, ts = (x.to(dev) for x in batches)
    gen = torch.Generator(device=dev).manual_seed(common.sub_seed(run.seed, common.STEPS))
    draws = [ref.draw_step(gen, ids.shape[1], ids.shape[2] - 1, start["negatives"],
                           start["num_items"], dm, dev) for _ in range(ids.shape[0])]
    out = ref.train_steps(params0, list(zip(ids, ts)), draws, lr, dm, start["temperature"],
                          prec, half, bias)
    out["m1"] = {k: 0.1 * v for k, v in out["first_grads"].items()}
    judged = ref.rebuild(params0, {k: v.to(dev) for k, v in emb_params.items()})
    out["states"] = ref.user_states(judged, start["val_ids"].to(dev), start["val_ts"].to(dev),
                                    start["val_pos"].to(dev), dm, prec, bias=bias)
    out["items"] = ref.item_table(judged)
    out["hr"] = ref.hit_rate(out["states"], out["items"], start["targets"].to(dev), 10,
                             dtype=torch.float32)
    return out


def compare(run, prog: dict, want: dict, params0: dict, start: dict) -> dict:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` as
    ``drivers/train.py:compare`` defines them; ``emb_gap``: the largest row
    gap of the validation user states and of the item table at the params
    the program reached; ``hr_gap``: the program's validation HR@10 against
    its own states and table ranked again in float64."""
    dev = want["items"].device
    run.check("loss_gap", max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"])))
    g_ref = {k: float(torch.linalg.vector_norm(v)) for k, v in want["first_grads"].items()}
    median = float(np.median(list(g_ref.values())))
    live = [k for k, v in g_ref.items() if v >= 1e-3 * median]
    g_prog = {k: float(torch.linalg.vector_norm(prog["m1"][k].to(dev) / 0.1)) for k in live}
    run.check("grad_gap", max(abs(g_prog[k] - g_ref[k]) / max(g_ref[k], median) for k in live))
    p0 = ref.leaves(params0)
    c_ref = {k: float(torch.linalg.vector_norm(want["params"][k] - p0[k].to(dev)))
             for k in live}
    c_prog = {k: float(torch.linalg.vector_norm(prog["params"][k].to(dev) - p0[k].to(dev)))
              for k in live}
    c_median = float(np.median(list(c_ref.values())))
    run.check("change_gap", max(abs(c_prog[k] - c_ref[k]) / max(c_ref[k], c_median)
                                for k in live))
    s_worst, s_median = common.row_gap(prog["states"].to(dev), want["states"])
    i_worst, i_median = common.row_gap(prog["items"].to(dev), want["items"])
    run.check("emb_gap", max(s_worst, i_worst))
    judged = ref.hit_rate(prog["states"].to(dev), prog["items"].to(dev),
                          start["targets"].to(dev), 10)
    run.check("hr_gap", abs(prog["hr"] - judged))
    readings = {"losses": prog["losses"], "losses_ref": want["losses"],
                "states_gap": s_worst, "states_gap_median": s_median, "items_gap": i_worst,
                "items_gap_median": i_median, "left_out": sorted(set(g_ref) - set(live)),
                "hr10": prog["hr"], "hr10_judged": judged, "hr10_ref": want["hr"]}
    run.note("reference", **readings)
    return readings
