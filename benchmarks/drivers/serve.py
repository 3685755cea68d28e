"""Open-loop serving traffic: requests arrive at a fixed mean rate and are
submitted to ``BatchingRecommender.submit`` on a schedule, whatever the
server's state; each request is timed from when it was due to when its
future got its answer.

Set-up loads the corpus, builds the trainer with the seeded weights,
refreshes the tables once from the seed's walk stream, embeds the corpus
once, builds the server (which captures its search buckets), composes
every request's query as the server's ``recommend_by_item`` does, and
offers ``warm_s`` seconds of the mix first. The generator shares the
interpreter with the server, as a front end in the server's process
would, at the interpreter's own switch interval; set-up ends with the heap
frozen (``harness.Run.setup``), which the port does not do. The schedule:
``round(rate * seconds)`` arrivals with exponential gaps drawn from the
seed and scaled to span the window exactly, so every seed sends the same
number of requests. Each request asks by one item, drawn in proportion to
its ratings in the corpus, for the mix's ``k``, the item itself excluded.

After the window (and up to ``drain_s`` for the last answers) the plain
reference recomputes the tables and the embeddings and judges a sample of
the answers, drawn from the seed, against exact search over the embeddings
the server searched.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from ..reference import pinsage as ref
from . import common


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of ``round(rate * seconds)``
    arrivals: exponential gaps from ``seed``, scaled so that the schedule
    spans the window."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(seed).exponential(1.0, n + 1)
    t = np.cumsum(gaps)
    return t[:n] * (seconds / t[n])


def requests(data, emb: np.ndarray, n: int, rng: np.random.Generator):
    """(queries [n, D] f32, excludes): ``n`` items drawn in proportion to
    their ratings, each asking by its own row, itself excluded."""
    counts = np.bincount(data.movie_idx, minlength=data.num_movies).astype(np.float64)
    items = rng.choice(data.num_movies, size=n, p=counts / counts.sum())
    return emb[items], [np.asarray([m]) for m in items.tolist()]


def drive(rec, due: np.ndarray, queries: np.ndarray, excludes: list, k: int,
          drain_s: float, keep=()) -> dict:
    """Submits request i at ``due[i]`` seconds after the start (sleeping
    until then, never spinning: a spinning thread would hold the
    interpreter lock the server's worker needs); records when each was
    submitted, when
    its answer came and whether it came without an error, and keeps the
    answers of the requests in ``keep`` (the check's sample) only."""
    n = due.shape[0]
    done = np.full(n, np.nan)
    sent = np.full(n, np.nan)
    ok = np.zeros(n, dtype=bool)
    keep = set(int(i) for i in keep)
    answers: dict = {}
    errors = [0]
    left = [n]
    lock, all_done = threading.Lock(), threading.Event()

    def settle():
        with lock:
            left[0] -= 1
            if left[0] == 0:
                all_done.set()

    def finish(i):
        def cb(fut):
            done[i] = time.perf_counter()
            try:
                got = fut.result()
                ok[i] = True
                if i in keep:
                    answers[i] = got
            except Exception:  # a failed request counts as missing
                errors[0] += 1
            settle()
        return cb

    t0 = time.perf_counter()
    for i in range(n):
        wait = t0 + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        sent[i] = time.perf_counter()
        try:
            fut = rec.submit(queries[i], k, exclude=excludes[i])
        except Exception:
            errors[0] += 1
            settle()
            continue
        fut.add_done_callback(finish(i))
    t_sent = time.perf_counter()
    all_done.wait(timeout=drain_s)
    return {"t0": t0, "due": t0 + due, "sent": sent, "done": done, "ok": ok,
            "answers": answers, "errors": errors[0], "t_sent": t_sent}


def warm_up(rec, data, emb, mix: dict, k: int, rng) -> dict:
    """``warm_s`` seconds of the mix at the cell's rate before the window
    (set-up): the server's host path, its pinned host buffers and every
    search bucket reach their steady state under load."""
    seconds = float(mix["warm_s"])
    due = schedule(float(mix["rate_per_s"]), seconds, int(rng.integers(2 ** 62)))
    queries, excludes = requests(data, emb, due.shape[0], rng)
    out = drive(rec, due, queries, excludes, k, float(mix["drain_s"]))
    lat = (out["done"] - out["due"]) * 1e3
    return {"requests": int(due.shape[0]), "p99_ms": float(np.nanpercentile(lat, 99)),
            "late_ms_max": float(np.nanmax(out["sent"] - out["due"]) * 1e3)}


def run(run) -> None:
    from movie_recommendation_engine_tpu_torch.retrieval.server import BatchingRecommender

    mix = {**run.spec["mix"], **run.params}
    k = int(mix["k"])
    cfg = common.port_config(run, common.corpus(run))
    dev = torch.device(run.device)

    with run.setup():
        eng = common.engine(run, cfg)
        tr = eng.trainer
        params0 = common.make_params(common.sub_seed(run.seed, common.PARAMS),
                                     **common.model_dims(cfg), device=dev)
        common.install_params(tr, params0)
        tr.generator.manual_seed(common.sub_seed(run.seed, common.WALKS))
        tr.refresh_neighborhoods()
        tables = [(i.detach().cpu(), w.detach().cpu()) for i, w in tr.nbr_tables]
        emb = tr.movie_embeddings().detach().cpu().numpy()
        rec = BatchingRecommender(emb, method=cfg.search.search_method, cfg=cfg,
                                  max_batch=cfg.serve.max_batch, max_wait_ms=cfg.serve.max_wait_ms,
                                  max_k=cfg.serve.max_k, device=dev)
        rng = np.random.default_rng(common.sub_seed(run.seed, common.TRAFFIC))
        due = schedule(float(mix["rate_per_s"]), run.seconds, int(rng.integers(2 ** 62)))
        queries, excludes = requests(eng.data, emb, due.shape[0], rng)
        pick = np.sort(rng.choice(due.shape[0], size=min(int(mix["check_requests"]),
                                                         due.shape[0]), replace=False))
        warm = warm_up(rec, eng.data, emb, mix, k, rng)
    run.note("warm_up", **warm)
    run.note("setup", setup_s=run.setup_s, requests=int(due.shape[0]),
             rate_per_s=float(mix["rate_per_s"]), method=cfg.search.search_method)

    rec.reset_stats()
    try:
        with run.window():
            with run.span("serve"):
                out = drive(rec, due, queries, excludes, k, float(mix["drain_s"]), pick)
        with rec._lock:      # the server's own counters of the window
            num_requests, num_batches = rec._stats.num_requests, rec._stats.num_batches
    finally:
        rec.close()
    late = out["sent"] - out["due"]
    lat_ms = (out["done"] - out["due"]) * 1e3
    answered = out["ok"] & ~np.isnan(out["done"])
    run.attempted = int(due.shape[0])
    run.failed = int((~answered).sum())
    # A failed or unanswered request counts as missing every latency limit.
    lat_all = np.where(answered, lat_ms, np.inf).tolist()
    from ..harness import percentile
    tail = {q: percentile(lat_all, q) for q in (50, 90, 95, 99)}
    p99 = tail[99]
    if np.isfinite(tail[50]):
        run.e2e["serve_p50_ms"] = tail[50]
    run.records["p99_ms"] = p99 if np.isfinite(p99) else None
    completed_in_window = float(np.sum(out["done"][answered] <= out["t0"] + run.seconds))
    run.records.update(num_requests=num_requests, num_batches=num_batches)
    run.note("window", requests=int(due.shape[0]), answered=int(answered.sum()),
             errors=out["errors"], offered_per_s=float(due.shape[0] / run.seconds),
             completed_per_s=completed_in_window / run.seconds,
             latency_ms={f"p{q}": v for q, v in tail.items()},
             generator_late_ms_p50=float(np.nanpercentile(late, 50) * 1e3),
             generator_late_ms_p99=float(np.nanpercentile(late, 99) * 1e3),
             generator_late_ms_max=float(np.nanmax(late) * 1e3),
             num_batches=num_batches, mean_batch=num_requests / max(num_batches, 1),
             backlog_at_close=int(np.sum(~(out["done"] <= out["t0"] + run.seconds))),
             window_s=run.window_s, gc_gen2_pauses_ms=[
                 p * 1e3 for p in run.records["gc_gen2_pauses_s"]],
             latest=[[float(out["due"][i] - out["t0"]), float(late[i] * 1e3)]
                     for i in np.argsort(-np.nan_to_num(late))[:8]],
             slowest=[[float(out["due"][i] - out["t0"]), float(lat_ms[i])]
                      for i in np.argsort(-np.nan_to_num(lat_ms))[:8]])

    start = common.Start(eng)
    del eng, tr, rec
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    pick = [int(i) for i in pick if answered[i]]
    served = {"emb": torch.as_tensor(emb), "queries": queries[pick],
              "excludes": [excludes[i] for i in pick],
              "ids": [out["answers"][i]["indices"] for i in pick],
              "scores": [out["answers"][i]["scores"] for i in pick]}
    want = follow(run, start, params0, tables, ref.Precision("f32"))
    compare(run, served, want, k)


def follow(run, start, params0, tables, prec: ref.Precision) -> dict:
    """The reference's tables (``tables_mismatch``) and embedding pass."""
    dev = torch.device(run.device)
    if run.device == "cuda":
        ref.tf32_off()
    mine = common.tables_gap(run, start, tables, dev)
    eff, info = ref.pooling_tables(start.model, mine, start.rows, start.num_movies)
    run.note("reference_rung", precision=prec.kind, **info)
    return {"emb": ref.embed_all(params0, start.x.to(dev), eff, prec)}


def compare(run, served: dict, want: dict, k: int) -> None:
    """``emb_gap``: the largest row gap between the embeddings the server
    searched and the reference's; ``rank_gap`` and ``score_gap``: the
    sample's answers judged in float64 against exact search over the
    embeddings the server searched (``reference.pinsage.search_gaps``)."""
    dev = want["emb"].device
    e = served["emb"].to(dev)
    worst, median_row = common.row_gap(e, want["emb"])
    run.check("emb_gap", worst)
    rank, score = ref.search_gaps(e, torch.as_tensor(served["queries"], device=dev),
                                  served["excludes"], served["ids"], served["scores"], k)
    run.check("rank_gap", rank)
    run.check("score_gap", score)
    run.note("reference", emb_gap_median=median_row, judged=len(served["ids"]))
