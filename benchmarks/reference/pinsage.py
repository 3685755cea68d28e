"""Plain PyTorch reference of what the benchmark's cells run: the walk
tables, the pooling operators' semantics, the PinSage train step with its
NCE loss and Adam, the full embedding pass, validation ranks and exact
search.

Written from the PinSage description (Ying et al., KDD 2018) and the
configuration's settings, not from the port: it imports nothing of the
program and takes none of its tables, operators or weights. It starts from
what the benchmark hands both sides (the seeded weights, the interactions,
the feature table and the pairs of the program's ingest; the generator seed
of each draw) and works everything else out again in float32 (TF32 off) or,
as the control, with every matmul operand and every pooled table rounded to
float8 e4m3 (``Precision("fp8")``): the precision below the configuration's
bf16.

Semantics followed (and where they are the configuration's choices):

- Walks: from every item, ``num_walks`` walks of ``walk_length`` hops; a hop
  picks the first edge of the current row whose cumulative rating share is
  at least a uniform draw. Uniforms come from a ``torch.Generator`` seeded
  by the benchmark, ``[walk_length, rows * num_walks]`` per chunk of 16,384
  start rows and per layer, chunk-major (the draw order is the stream the
  benchmark seeds both sides with).
- Importance neighbourhoods: the ``K`` most visited items (only item nodes
  count), ties to the lower id; weights are visit counts over the kept
  total; empty slots hold the sentinel id (the node count) and weight 0.
- Pooling: the configuration's ``model.pool_impl=auto`` rung. Up to
  ``dense_pool_max_rows`` rows every layer pools its whole table. Above it,
  each layer keeps the ``head`` columns of largest total weight (``N/8``,
  4,096 to 16,384) and each row's ``residual`` heaviest other entries, the
  residual doubled once where more than the gate's share of the weight
  would be dropped; rows are renormalized over what they keep.
- Model: ``relu(x W_in)``; per layer ``l2norm(relu([h W_self, pool(h)]
  W_update))``; inverted dropout after the hidden layers; the last layer
  and ``l2norm(h W_out)`` over the step's rows only; NCE over the positive,
  the shared negatives and each query's hard negatives.
- Draws of a step: a random permutation of the items (its first ``R`` are
  the shared negatives), then ``[B, H]`` uniform random items (the hard
  negatives: with ``min_rank`` above the walks' reach the rank window is
  empty and every hard negative is a random item), then one keep mask per
  hidden layer (``uniform < 1 - rate``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EPS = 1e-12
CHUNK = 16384
_ROW = 2 ** 32          # a search key: row * 2**32 + the float32 bits of a share


class Precision:
    """``f32``: float32 with TF32 off. ``fp8``: the control, every matmul
    operand and every pooled table rounded to float8 e4m3 with a scale per
    tensor (max magnitude to 448), then computed as ``f32``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8', got {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        scale = x.detach().abs().amax().clamp_min(EPS) / 448.0
        y = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (y - x).detach()          # rounded forward, straight-through backward


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---- graph and walk tables --------------------------------------------------

class Graph(NamedTuple):
    indptr: torch.Tensor     # [V+1] int64
    indices: torch.Tensor    # [E] int64
    keys: torch.Tensor       # [E] int64: row * 2**32 + the bits of the f32 cumprob
    num_nodes: int


def bipartite_graph(user_idx, movie_idx, ratings, num_movies: int, num_users: int,
                    device) -> Graph:
    """Items 0..M-1, users M..M+U-1; every rating is an edge both ways,
    weighted by the rating; a row's edges in the order of the ratings
    (item rows after the user rows' edges' sources, stably). Cumulative
    shares are exact: ratings are half stars, so the float64 sums are. A
    non-negative float32's bits order as its value, so a row's keys order as
    its cumulative shares and a search of ``row * 2**32 + bits(u)`` finds the
    first share at least ``u``, exactly."""
    u = np.asarray(user_idx, np.int64) + num_movies
    m = np.asarray(movie_idx, np.int64)
    r = np.asarray(ratings, np.float64)
    src, dst, w = np.concatenate([u, m]), np.concatenate([m, u]), np.concatenate([r, r])
    order = np.argsort(src, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    v = num_movies + num_users
    indptr = np.zeros(v + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=v), out=indptr[1:])
    csum = np.cumsum(w)
    before = np.concatenate([[0.0], csum])       # before[i]: the sum of the first i edges
    base = before[indptr[:-1]][src]
    total = (before[indptr[1:]] - before[indptr[:-1]])[src]
    cum = ((csum - base) / total).astype(np.float32)
    cum[indptr[1:][np.diff(indptr) > 0] - 1] = 1.0
    keys = src * _ROW + cum.view(np.int32).astype(np.int64)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return Graph(t(indptr), t(dst), t(keys), v)


def _walk(g: Graph, starts: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """[walkers, hops] visited nodes (the sentinel where a walk halted)."""
    if not bool(((uniforms >= 0) & (uniforms <= 1)).all()):
        raise RuntimeError("uniform draws outside [0, 1]")
    ticks = uniforms.float().view(torch.int32).long()
    cur, alive, out = starts, torch.ones_like(starts, dtype=torch.bool), []
    for hop in range(uniforms.shape[0]):
        lo, hi = g.indptr[cur], g.indptr[cur + 1]
        pos = torch.searchsorted(g.keys, cur * _ROW + ticks[hop])
        pos = torch.minimum(pos, hi - 1).clamp(0, g.indices.shape[0] - 1)
        record = alive & (hi > lo)
        out.append(torch.where(record, g.indices[pos], g.num_nodes))
        cur = torch.where(record, g.indices[pos], cur)
        alive = record
    return torch.stack(out, dim=1)


def _top_visited(visited: torch.Tensor, k: int, sentinel: int,
                 restrict_below: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[b, k] ids and weights from each row's visits [b, m]."""
    b, m = visited.shape
    rows = torch.arange(b, device=visited.device).repeat_interleave(m)
    v = visited.reshape(-1)
    ok = v < restrict_below
    uniq, counts = torch.unique(rows[ok] * (sentinel + 1) + v[ok], return_counts=True)
    r, node = uniq // (sentinel + 1), uniq % (sentinel + 1)
    order = torch.argsort(r * (m + 1) * (sentinel + 1) + (m - counts) * (sentinel + 1) + node)
    r, node, counts = r[order], node[order], counts[order]
    first = torch.searchsorted(r, torch.arange(b, device=r.device))
    rank = torch.arange(r.shape[0], device=r.device) - first[r]
    keep = rank < k
    r, node, counts, rank = r[keep], node[keep], counts[keep], rank[keep]
    total = torch.zeros(b, dtype=torch.int64, device=r.device).index_add_(0, r, counts)
    ids = torch.full((b, k), sentinel, dtype=torch.int32, device=r.device)
    w = torch.zeros((b, k), dtype=torch.float32, device=r.device)
    ids[r, rank] = node.to(torch.int32)
    w[r, rank] = counts.float() / total[r].float()
    return ids, w


def walk_tables(g: Graph, rows: int, num_layers: int, num_walks: int, walk_length: int,
                k: int, restrict_below: int, generator: torch.Generator
                ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """One ([rows, k] ids, weights) table per layer, every row's walks
    drawn from ``generator`` in the order the module docstring states."""
    dev = g.indptr.device
    ids = torch.empty((num_layers, rows, k), dtype=torch.int32, device=dev)
    wts = torch.empty((num_layers, rows, k), dtype=torch.float32, device=dev)
    for s in range(0, rows, CHUNK):
        b = min(CHUNK, rows - s)
        starts = torch.arange(s, s + b, device=dev).repeat_interleave(num_walks)
        for layer in range(num_layers):
            u = torch.rand((walk_length, b * num_walks), generator=generator, device=dev)
            visited = _walk(g, starts, u).reshape(b, num_walks * walk_length)
            ids[layer, s:s + b], wts[layer, s:s + b] = _top_visited(
                visited, k, g.num_nodes, restrict_below)
    return [(ids[i], wts[i]) for i in range(num_layers)]


# ---- the pooling rung's semantics -------------------------------------------

def _normalized(ids: torch.Tensor, w: torch.Tensor, limit: int) -> torch.Tensor:
    w = torch.where(ids < limit, w.double(), 0.0)
    s = w.sum(dim=1, keepdim=True)
    return torch.where(s > 0, w / s.clamp_min(EPS), 0.0)


def _hub_keep(ids: torch.Tensor, w: torch.Tensor, n: int, head: int,
              residual: int) -> tuple[torch.Tensor, float]:
    cols = ids.long().clamp(0, n - 1)
    mass = torch.zeros(n, dtype=torch.float64, device=ids.device)
    mass.index_add_(0, cols.reshape(-1), w.reshape(-1))
    head_ids = torch.sort(mass, descending=True, stable=True).indices[:min(head, n)]
    is_head = torch.zeros(n, dtype=torch.bool, device=ids.device)
    is_head[head_ids] = True
    in_head = is_head[cols] & (w > 0)
    tail = torch.where(~in_head & (w > 0), w, 0.0)
    slots = torch.sort(tail, dim=1, descending=True, stable=True).indices[:, :residual]
    in_res = torch.zeros_like(in_head).scatter_(1, slots, True) & (tail > 0)
    keep = in_head | in_res
    total = float(w.sum())
    dropped = 1.0 - float(w[keep].sum()) / total if total > 0 else 0.0
    return keep, dropped


def auto_head(n: int) -> int:
    """N/8 columns, at least 4,096, at most 32 KB of bf16 slab a row."""
    return min(max(4096, n // 8), 16384)


def pooling_tables(model: dict, tables, rows: int, limit: int):
    """Each layer's effective (ids, weights) under ``model``'s rung (the
    port's ``Config.model`` fields), and a description of the rung:
    ``{"rung": "dense" | "hubf", "dropped": [...], "residual": [...]}``."""
    if model["pool_impl"] != "auto" or model["aggregator_type"] != "importance":
        raise NotImplementedError("the reference covers model.pool_impl=auto with "
                                  "importance pooling")
    out = [(ids, _normalized(ids, w, limit)) for ids, w in tables]
    if rows <= model["dense_pool_max_rows"]:
        return out, {"rung": "dense"}
    head = model["hub_pool_head"] if model["hub_pool_head"] > 0 else auto_head(rows)
    if not (model["auto_hub_final"]
            and len(tables) * rows * min(head, rows) * 2 <= model["auto_hub_final_max_bytes"]):
        raise NotImplementedError("the reference covers the hub rung with its last layer hubbed")
    cap = (model["hub_pool_max_dropped_mass"] if model["hub_pool_max_dropped_mass"] >= 0
           else model["block_pool_max_dropped_mass"])
    pruned, info = [], {"rung": "hubf", "dropped": [], "residual": []}
    for ids, w in out:
        r = model["hub_pool_residual"]
        keep, dropped = _hub_keep(ids, w, rows, head, r)
        if dropped > cap and min(2 * r, ids.shape[1]) > r:
            r = min(2 * r, ids.shape[1])
            keep, dropped = _hub_keep(ids, w, rows, head, r)
        if dropped > cap:
            raise NotImplementedError("a hub layer fails its gate: the program falls back "
                                      "to another rung, which the reference does not cover")
        info["dropped"].append(dropped)
        info["residual"].append(r)
        kept = torch.where(keep, w, 0.0)
        s = kept.sum(dim=1, keepdim=True)
        pruned.append((ids, torch.where(s > 0, kept / s.clamp_min(EPS), 0.0)))
    return pruned, info


# ---- the model --------------------------------------------------------------

def _lin(p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.q(x) @ prec.q(p["w"]) + p["b"]


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(EPS)


def pool(h: torch.Tensor, ids: torch.Tensor, w: torch.Tensor, prec: Precision) -> torch.Tensor:
    """``sum_k w[:, k] * h[ids[:, k]]`` (weights already masked and
    normalized; masked slots carry weight 0)."""
    hq = prec.q(h)
    idx = ids.long().clamp(0, h.shape[0] - 1)
    wf = w.float()
    out = torch.zeros((ids.shape[0], h.shape[1]), dtype=torch.float32, device=h.device)
    for k in range(ids.shape[1]):
        out = out + wf[:, k:k + 1] * hq[idx[:, k]]
    return out


def _conv(c: dict, h_self: torch.Tensor, pooled: torch.Tensor, prec: Precision) -> torch.Tensor:
    z = _lin(c["update"], torch.cat([_lin(c["self"], h_self, prec), pooled], dim=1), prec)
    return _l2n(torch.relu(z))


def forward_batch(params: dict, x: torch.Tensor, tables, nodes: torch.Tensor,
                  keep: list[torch.Tensor], rate: float, prec: Precision) -> torch.Tensor:
    """Embeddings [len(nodes), E] of the train step's rows."""
    convs = params["convs"]
    h = torch.relu(_lin(params["input_proj"], x, prec))
    for i, c in enumerate(convs[:-1]):
        h = _conv(c, h, pool(h, *tables[i], prec), prec)
        h = torch.where(keep[i], h / (1.0 - rate), 0.0)
    idx = nodes.long().clamp(0, h.shape[0] - 1)
    ids, w = tables[len(convs) - 1]
    hb = _conv(convs[-1], h[idx], pool(h, ids[idx], w[idx], prec), prec)
    return _l2n(_lin(params["output_proj"], hb, prec))


@torch.no_grad()
def embed_all(params: dict, x: torch.Tensor, tables, prec: Precision) -> torch.Tensor:
    """Every row's embedding [N, E] (no dropout)."""
    h = torch.relu(_lin(params["input_proj"], x, prec))
    for i, c in enumerate(params["convs"]):
        h = _conv(c, h, pool(h, *tables[i], prec), prec)
    return _l2n(_lin(params["output_proj"], h, prec))


def nce_loss(q: torch.Tensor, p: torch.Tensor, negs: torch.Tensor, hard: torch.Tensor | None,
             tau: float) -> torch.Tensor:
    logits = [(q * p).sum(dim=1, keepdim=True), q @ negs.T]
    if hard is not None:
        logits.append(torch.einsum("bd,bhd->bh", q, hard))
    return -torch.log_softmax(torch.cat(logits, dim=1) / tau, dim=1)[:, 0].mean()


class Draws(NamedTuple):
    negatives: torch.Tensor          # [R] int64
    hard: torch.Tensor | None        # [B, H] int64
    keep: list[torch.Tensor]         # per hidden layer, [N, hidden] bool


def draw_step(generator: torch.Generator, num_movies: int, num_negatives: int, batch: int,
              num_hard: int, rows: int, hidden: int, num_layers: int, rate: float,
              device) -> Draws:
    negs = torch.randperm(num_movies, generator=generator, device=device)[:num_negatives]
    hard = None
    if num_hard > 0:
        hard = torch.randint(0, num_movies, (batch, num_hard), generator=generator,
                             device=device, dtype=torch.int32).long()
    keep = [torch.rand((rows, hidden), generator=generator, device=device) < 1.0 - rate
            for _ in range(num_layers - 1)]
    return Draws(negs.long(), hard, keep)


def step_loss(params: dict, x, tables, q, p, d: Draws, rate: float, tau: float,
              prec: Precision, loss_rows: int | None = None) -> torch.Tensor:
    """The step's NCE loss; ``loss_rows`` (a planted fault) takes the mean
    over the batch's first rows only."""
    b, r = q.shape[0], d.negatives.shape[0]
    parts = [q.long(), p.long(), d.negatives] + ([] if d.hard is None else [d.hard.reshape(-1)])
    emb = forward_batch(params, x, tables, torch.cat(parts), d.keep, rate, prec)
    hard = None if d.hard is None else emb[2 * b + r:].reshape(b, d.hard.shape[1], -1)
    u = b if loss_rows is None else loss_rows
    return nce_loss(emb[:u], emb[b:b + u], emb[2 * b:2 * b + r],
                    None if hard is None else hard[:u], tau)


def leaves(params: dict) -> dict[str, torch.Tensor]:
    """The parameter tree as ``{"convs/0/self/w": tensor, ...}``."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}{k}/", node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}/", v)
        else:
            out[prefix[:-1]] = node
    walk("", params)
    return out


def rebuild(params: dict, flat: dict[str, torch.Tensor]) -> dict:
    """``params``' tree with the leaves of ``flat``."""
    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}{k}/", v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(f"{prefix}{i}/", v) for i, v in enumerate(node)]
        return flat[prefix[:-1]]
    return walk("", params)


class Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8, bias-corrected) over flat leaves."""

    def __init__(self, flat: dict[str, torch.Tensor]):
        self.m = {k: torch.zeros_like(v) for k, v in flat.items()}
        self.v = {k: torch.zeros_like(v) for k, v in flat.items()}
        self.t = 0

    def step(self, flat: dict, grads: dict, lr: float) -> dict:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        out = {}
        for k, p in flat.items():
            g = grads[k]
            self.m[k] = 0.9 * self.m[k] + 0.1 * g
            self.v[k] = 0.999 * self.v[k] + 0.001 * g * g
            out[k] = p - lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + 1e-8)
        return out


def train_steps(params: dict, x, tables, batches, draws: list[Draws], lr: float, rate: float,
                tau: float, prec: Precision, loss_rows: int | None = None) -> dict:
    """The steps over ``batches`` [(q, p)], from ``params``: each step's
    loss, the first step's gradient and the params after the last."""
    flat = {k: v.detach().clone() for k, v in leaves(params).items()}
    opt, losses, first_grads = Adam(flat), [], None
    for (q, p), d in zip(batches, draws):
        live = {k: v.clone().requires_grad_() for k, v in flat.items()}
        loss = step_loss(rebuild(params, live), x, tables, q, p, d, rate, tau, prec, loss_rows)
        g = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
        grads = {k: (torch.zeros_like(v) if gi is None else gi)
                 for (k, v), gi in zip(live.items(), g)}
        if first_grads is None:
            first_grads = grads
        losses.append(float(loss.detach()))
        flat = opt.step(flat, grads, lr)
    return {"losses": losses, "first_grads": first_grads, "params": flat}


# ---- evaluation and search --------------------------------------------------

@torch.no_grad()
def hit_rates(emb: torch.Tensor, pairs: torch.Tensor, ks, chunk: int = 1024,
              dtype=torch.float32, tf32: bool = False) -> dict:
    """HR@k: the share of (query, truth) pairs whose truth ranks within k,
    a rank being 1 + the items scored above the truth by dot product,
    computed in ``dtype`` (``tf32``: float32 products in TF32, the
    control's precision for float32 ranks)."""
    emb = emb.to(dtype)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _hit_rates(emb, pairs, ks, chunk)
    finally:
        tf32_off()


def _hit_rates(emb, pairs, ks, chunk):
    ranks = [torch.zeros(0, dtype=torch.int64, device=emb.device)]
    for s in range(0, pairs.shape[0], chunk):
        qi, gi = pairs[s:s + chunk, 0].long(), pairs[s:s + chunk, 1].long()
        sims = emb[qi] @ emb.T
        gt = (emb[qi] * emb[gi]).sum(dim=1, keepdim=True)
        ranks.append(1 + (sims > gt).sum(dim=1))
    ranks = torch.cat(ranks)
    return {k: float((ranks <= k).double().mean()) if ranks.numel() else 0.0 for k in ks}


@torch.no_grad()
def search_gaps(emb: torch.Tensor, queries: torch.Tensor, excludes: list, ids: list,
                scores: list, k: int) -> tuple[float, float]:
    """Judges exact-search answers in float64 over ``emb``: (the widest
    amount by which an answer's last distance lies above the true k-th
    nearest non-excluded item's, the widest gap between an answer's score and
    minus its item's true squared distance). A missing or extra id reads
    infinite."""
    e = emb.double()
    sq = (e * e).sum(dim=1)
    worst_rank, worst_score = 0.0, 0.0
    for i in range(queries.shape[0]):
        q = queries[i].double()
        dist = (q * q).sum() + sq - 2.0 * (e @ q)
        dist[torch.as_tensor(excludes[i], dtype=torch.long, device=e.device)] = float("inf")
        want = min(k, int(torch.isfinite(dist).sum()))
        got = torch.as_tensor(ids[i], dtype=torch.long, device=e.device)
        if got.shape[0] != want or (got.shape[0] and not torch.isfinite(dist[got]).all()):
            return float("inf"), float("inf")
        if want == 0:
            continue
        kth = torch.topk(dist, want, largest=False).values[-1]
        worst_rank = max(worst_rank, float(dist[got].max() - kth))
        s = torch.as_tensor(scores[i], dtype=torch.float64, device=e.device)
        worst_score = max(worst_score, float((s + dist[got]).abs().max()))
    return worst_rank, worst_score
