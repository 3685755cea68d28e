"""Open-loop serving traffic through the LSH index: ``drivers/serve.py``'s
schedule, requests, drive and warm-up (imported), with the server's index
the popcount LSH of the mix's ``search`` overrides (the Hamming kernel and
an exact rerank of its shortlist), its hyperplanes drawn from the seed's
PARAMS stream and injected (``planes=``).

LSH answers are not exact search's, so the check is its own: after the
window the plain reference recomputes the tables and the embeddings
(``emb_gap``, ``tables_mismatch``, as the item cell) and answers the
check's sample again from the embeddings the server searched and the same
hyperplanes (``reference/lsh.py``): ``id_mismatch``, the share of sampled
answers whose ids (in order) differ from the reference's; ``score_gap``,
the widest gap between a served score and minus its id's squared distance
in float64; and ``rank_gap``, the widest amount by which an answer's
farthest item lies above the k-th distance that any shortlist of the
rounded signatures reaches (``reference.lsh.answers``' ``sure``; a missing
or extra id reads infinite), which an answer altered with its scores kept
true to its ids still shows.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from ..reference import lsh as lsh_ref
from ..reference import pinsage as ref
from . import common
from .serve import drive, follow, requests, schedule, warm_up


def run(run) -> None:
    from movie_recommendation_engine_tpu_torch.retrieval.server import BatchingRecommender

    mix = {**run.spec["mix"], **run.params}
    k = int(mix["k"])
    cfg = common.port_config(run, common.corpus(run))
    dev = torch.device(run.device)
    s = cfg.search

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
        planes = lsh_ref.planes(common.sub_seed(run.seed, common.PARAMS), emb.shape[1],
                                s.lsh_bits, s.lsh_tables)
        rec = BatchingRecommender(emb, method=s.search_method, cfg=cfg,
                                  max_batch=cfg.serve.max_batch, max_wait_ms=cfg.serve.max_wait_ms,
                                  max_k=cfg.serve.max_k, device=dev, planes=planes)
        rng = np.random.default_rng(common.sub_seed(run.seed, common.TRAFFIC))
        due = schedule(float(mix["rate_per_s"]), run.seconds, int(rng.integers(2 ** 62)))
        queries, excludes = requests(eng.data, emb, due.shape[0], rng)
        pick = np.sort(rng.choice(due.shape[0], size=min(int(mix["check_requests"]),
                                                         due.shape[0]), replace=False))
        warm = warm_up(rec, eng.data, emb, mix, k, rng)
    run.note("warm_up", **warm)
    run.note("setup", setup_s=run.setup_s, requests=int(due.shape[0]),
             rate_per_s=float(mix["rate_per_s"]), method=s.search_method, rerank=s.lsh_rerank)

    rec.reset_stats()
    try:
        with run.window():
            with run.span("serve"):
                out = drive(rec, due, queries, excludes, k, float(mix["drain_s"]), pick)
        with rec._lock:      # the server's own counters of the window
            num_requests, num_batches = rec._stats.num_requests, rec._stats.num_batches
        shortlist = max(rec.index.rerank, rec._search_k)
    finally:
        rec.close()
    lat_ms = (out["done"] - out["due"]) * 1e3
    answered = out["ok"] & ~np.isnan(out["done"])
    run.attempted = int(due.shape[0])
    run.failed = int((~answered).sum())
    from ..harness import percentile
    lat_all = np.where(answered, lat_ms, np.inf).tolist()
    tail = {q: percentile(lat_all, q) for q in (50, 90, 95, 99)}
    if np.isfinite(tail[50]):
        run.e2e["serve_p50_ms"] = tail[50]
    run.records["p99_ms"] = tail[99] if np.isfinite(tail[99]) else None
    run.records.update(num_requests=num_requests, num_batches=num_batches)
    close = out["t0"] + run.seconds
    run.note("window", requests=int(due.shape[0]), answered=int(answered.sum()),
             errors=out["errors"], offered_per_s=float(due.shape[0] / run.seconds),
             completed_per_s=float(np.sum(out["done"][answered] <= close)) / run.seconds,
             latency_ms={f"p{q}": v for q, v in tail.items()}, num_batches=num_batches,
             mean_batch=num_requests / max(num_batches, 1), shortlist=shortlist,
             backlog_at_close=int(np.sum(~(out["done"] <= close))), window_s=run.window_s)

    start = common.Start(eng)
    del eng, tr, rec
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    pick = [int(i) for i in pick if answered[i]]
    served = {"emb": torch.as_tensor(emb), "queries": queries[pick],
              "excludes": [excludes[i] for i in pick],
              "ids": [list(out["answers"][i]["indices"]) for i in pick],
              "scores": [list(out["answers"][i]["scores"]) for i in pick]}
    want = follow(run, start, params0, tables, ref.Precision("f32"))
    compare(run, served, want, planes, k, shortlist)


def compare(run, served: dict, want: dict, planes: torch.Tensor, k: int, c: int) -> None:
    """``emb_gap`` (as the item cell); ``id_mismatch``, ``score_gap`` and
    ``rank_gap`` of the sample against ``reference.lsh.answers`` over the
    embeddings the server searched."""
    dev = want["emb"].device
    e = served["emb"].to(dev)
    worst, median_row = common.row_gap(e, want["emb"])
    run.check("emb_gap", worst)
    ids, want, sure = lsh_ref.answers(e, planes,
                                      torch.as_tensor(served["queries"], device=dev),
                                      served["excludes"], k, c)
    differ = sum(a != [int(x) for x in b] for a, b in zip(ids, served["ids"]))
    run.check("id_mismatch", differ / max(len(ids), 1))
    ed = e.double()
    score_gap = rank_gap = 0.0
    differ_gaps = []
    for q, got, sc, a, ref_sc, kth in zip(served["queries"], served["ids"], served["scores"],
                                          ids, want, sure):
        if len(got) != len(ref_sc):
            rank_gap = float("inf")
            continue
        if not got:
            continue
        qd = torch.as_tensor(q, device=dev).double()
        rows = ed[torch.as_tensor([int(x) for x in got], device=dev)]
        dist = ((rows - qd) ** 2).sum(1)
        score_gap = max(score_gap, float((torch.as_tensor(sc, device=dev).double()
                                          + dist).abs().max()))
        gap = float(dist.max()) - kth
        rank_gap = max(rank_gap, gap)
        if a != [int(x) for x in got]:
            # How near the query's signature came to another bit, which
            # would move the reference's shortlist.
            proj = torch.einsum("d,tdb->tb", qd, planes.to(dev).double())
            l1 = torch.einsum("d,tdb->tb", qd.abs(), planes.to(dev).double().abs())
            differ_gaps.append((gap, float(dist.max()) + ref_sc[-1],
                                float((proj.abs() / l1).min())))
    run.check("score_gap", score_gap)
    run.check("rank_gap", rank_gap)
    run.note("reference", emb_gap_median=median_row, judged=len(ids), differ=differ,
             shortlist=c, differ_rank_gaps=sorted(differ_gaps, reverse=True)[:8])
