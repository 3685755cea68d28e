"""The train step and the embedding pass over a (data, model) mesh.

Port of ``movie_recommendation_engine_tpu/parallel/sharding.py``. Where JAX
annotates shardings on one jitted program and lets the partitioner insert
collectives, each rank runs its share explicitly:

- the full-graph layers over its rows of the row-sharded tables, with ``h``
  all-gathered over the model axis before each pooling
  (``models/pinsage.py``; the gather-pool kernels run on every rank);
- the batch layer and the loss over its share of the step's rows: the
  queries, positives, shared random negatives and hard negatives are each
  split over all ``d*m`` ranks, so that the ranks' losses sum to the loss
  of the whole batch; the random negatives (and, for ``batch_hard``, the
  positives) are all-gathered with autograd, and batch norm sums its
  statistics over every rank;
- the gradient summed over every rank, then the same Adam step on each.

No rank computes another's share, so no gradient is counted twice. With no
group and no shard, ``step_loss`` is the single-device step itself (the
trainer runs it either way).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..core import tree
from ..models import losses, pinsage
from ..train import optim
from . import collectives as coll
from .mesh import BatchStats, RowShard, batch_slice, share_sizes


class ShardedStepConfig(NamedTuple):
    aggregator: str = "importance"
    loss: str = "max_margin"       # max_margin | batch_hard | curriculum | cosine | nce
    margin: float = 0.1
    epoch: float = 0.0
    max_epochs: int = 10
    hard_neg_factor: float = 2.0
    nce_temperature: float = 0.1
    valid_limit: int | None = None
    dtype: Any = torch.bfloat16
    dropout: float = 0.0
    gather_impl: str = "xla"
    train_path: str = "pinsage"    # "mlp": the MLP path and the cosine objective


def _dense_fast_path(params, pool_mats) -> bool:
    """A dense matrix for every layer: the all-matmul forwards."""
    return (len(pool_mats) == len(params["convs"])
            and all(torch.is_tensor(pm) for pm in pool_mats))


def _rows(table: torch.Tensor, idx: torch.Tensor, shard: RowShard | None) -> torch.Tensor:
    return table[idx.long()] if shard is None else coll.sharded_rows(table, idx, shard.group)


def step_loss(scfg: ShardedStepConfig, params, x_table, nbrs_l, w_l, pool_mats,
              q: torch.Tensor, p: torch.Tensor, rand_negs: torch.Tensor,
              hard_negs: torch.Tensor | None, generator=None, keep=None, bwd_layouts=None,
              shard: RowShard | None = None, world=None) -> torch.Tensor:
    """The rank's share of the step's loss over the global batch ``q``, ``p``
    [B], the shared random negatives [R] and the hard negatives [B, H]:
    the shares of all ranks of ``world`` sum to the loss of the batch
    (``world=None``: one process, the whole loss)."""
    parts, r = coll.size(world), coll.rank(world)
    b, n_rand = q.shape[0], rand_negs.shape[0]
    bs, rs = batch_slice(b, r, parts), batch_slice(n_rand, r, parts)
    q_r, p_r, rand_r = q[bs], p[bs], rand_negs[rs]
    hard_r = None if hard_negs is None else hard_negs[bs]
    b_r = q_r.shape[0]
    nodes = [q_r, p_r, rand_r] + ([] if hard_r is None else [hard_r.reshape(-1)])
    all_nodes = torch.cat([x.to(torch.int32) for x in nodes])
    rows = 2 * b + n_rand + (0 if hard_negs is None else hard_negs.numel())
    stats = None if world is None else BatchStats(world, rows)
    drop = dict(dropout_rate=scfg.dropout, generator=generator, dropout_keep=keep)
    if scfg.train_path == "mlp":
        emb = pinsage.mlp_forward(params, _rows(x_table, all_nodes, shard), scfg.dtype)
    elif _dense_fast_path(params, pool_mats):
        emb = pinsage.pooled_forward_batch_dense(
            params, x_table, list(pool_mats), all_nodes, dtype=scfg.dtype, shard=shard,
            batch_stats=stats, **drop)
    else:
        emb = pinsage.pooled_forward_batch(
            params, x_table, list(nbrs_l), list(w_l), all_nodes, valid_limit=scfg.valid_limit,
            dtype=scfg.dtype, aggregator=scfg.aggregator, pool_mats=pool_mats,
            gather_impl=scfg.gather_impl,
            bwd_layouts=bwd_layouts if scfg.gather_impl == "pallas" else None,
            shard=shard, batch_stats=stats, **drop)
    n_r = rand_r.shape[0]
    q_emb, p_emb = emb[:b_r], emb[b_r:2 * b_r]
    r_emb = emb[2 * b_r:2 * b_r + n_r]
    h_emb = (emb[2 * b_r + n_r:].reshape(b_r, hard_r.shape[1], -1)
             if hard_r is not None else None)

    kind = scfg.loss if scfg.train_path != "mlp" else "cosine"
    gathered = []
    if kind == "batch_hard":
        p_all = coll.all_gather_rows(p_emb, world, share_sizes(b, parts))
        gathered.append(p_all)
    elif kind != "cosine":
        r_emb = coll.all_gather_rows(r_emb, world, share_sizes(n_rand, parts))
        gathered.append(r_emb)
    if b_r == 0:
        # No rows here: a zero that still reaches every collective above,
        # so that the backward's collectives run on every rank.
        return sum(t.sum() for t in [emb, *gathered]) * 0.0
    if kind == "cosine":
        loss = losses.cosine_objective(q_emb, p_emb)
    elif kind == "batch_hard":
        loss = losses.batch_hard_triplet_loss(q_emb, p_emb, scfg.margin,
                                              batch_positives=p_all, offset=bs.start)
    elif kind == "max_margin":
        loss = losses.shared_pool_max_margin_loss(q_emb, p_emb, r_emb, scfg.margin)
    elif kind == "nce":
        loss = losses.nce_loss(q_emb, p_emb, r_emb, h_emb, temperature=scfg.nce_temperature)
    else:
        loss = losses.curriculum_loss(
            q_emb, p_emb, r_emb, h_emb, scfg.epoch, margin=scfg.margin,
            max_epochs=scfg.max_epochs, hard_negative_factor=scfg.hard_neg_factor)
    # Every loss is a mean over the batch's queries: the share's mean,
    # weighted by its part of the batch.
    return loss if parts == 1 else loss * (b_r / b)


def loss_and_grads(loss_fn, params, world=None) -> tuple[torch.Tensor, Any]:
    """``loss_fn(params)`` (the rank's share) and its gradient in every
    parameter (zeros for the ones the loss does not read, as JAX's), each
    summed over ``world``: the loss and gradient of the whole batch."""
    flat = tree.flatten(params)
    leaves = [x.detach().requires_grad_() for x in flat.values()]
    loss = loss_fn(tree.unflatten(dict(zip(flat, leaves))))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    loss = loss.detach()
    if coll.size(world) > 1:
        buf = coll.all_reduce_(torch.cat([loss.reshape(1).float()]
                                         + [g.reshape(-1) for g in grads]), world)
        loss, sizes = buf[0], [g.numel() for g in grads]
        grads = [x.view_as(g) for x, g in zip(torch.split(buf[1:], sizes), grads)]
    return loss, tree.unflatten(dict(zip(flat, grads)))


def make_sharded_train_step(mesh, scfg: ShardedStepConfig, shard: RowShard | None = None):
    """``step(params, opt_state, x_table, nbrs_l, w_l, pool_mats, q, p,
    rand_negs, hard_negs, lr, generator=None, keep=None, bwd_layouts=None)
    -> (params, opt_state, loss)``: one Adam step of every rank of ``mesh``
    on the global batch, ``x_table`` / ``nbrs_l`` / ``w_l`` / ``pool_mats``
    holding the rank's rows under ``shard`` (``mesh=None``: one process)."""
    import torch.distributed as dist

    world = None if mesh is None else dist.group.WORLD

    def step(params, opt_state, x_table, nbrs_l, w_l, pool_mats, q, p, rand_negs,
             hard_negs, lr, generator=None, keep=None, bwd_layouts=None):
        loss, grads = loss_and_grads(
            lambda prm: step_loss(scfg, prm, x_table, nbrs_l, w_l, pool_mats, q, p,
                                  rand_negs, hard_negs, generator, keep, bwd_layouts,
                                  shard, world), params, world)
        params, opt_state = optim.adam_update(grads, opt_state, params, lr)
        return params, opt_state, loss

    return step


def embed(scfg: ShardedStepConfig, params, x_table, nbrs_l, w_l, pool_mats,
          shard: RowShard | None = None) -> torch.Tensor:
    """The full pooled forward (the MLP path under ``train_path="mlp"``):
    embeddings of every row of ``x_table``, the rank's rows under ``shard``."""
    if scfg.train_path == "mlp":
        return pinsage.mlp_forward(params, x_table, scfg.dtype)
    if _dense_fast_path(params, pool_mats):
        return pinsage.pooled_forward_dense(params, x_table, list(pool_mats),
                                            dtype=scfg.dtype, shard=shard)
    return pinsage.pooled_forward(
        params, x_table, list(nbrs_l), list(w_l), valid_limit=scfg.valid_limit,
        dtype=scfg.dtype, aggregator=scfg.aggregator, pool_mats=pool_mats,
        gather_impl=scfg.gather_impl, shard=shard)


def sharded_embed_fn(mesh, scfg: ShardedStepConfig, shard: RowShard | None = None):
    """``embed(params, x_table, nbrs_l, w_l, pool_mats=()) -> [C, E]``: the
    corpus embedding pass over the mesh, its output left row-sharded (the
    rank's rows, for ``retrieval.sharded.ShardedExactIndex``)."""
    def run(params, x_table, nbrs_l, w_l, pool_mats=()):
        return embed(scfg, params, x_table, nbrs_l, w_l, pool_mats, shard)

    return run
