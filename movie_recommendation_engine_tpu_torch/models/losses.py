"""Training losses, as PyTorch functions on f32 embeddings.

Port of ``movie_recommendation_engine_tpu/models/losses.py``: max-margin
ranking (paired, per-row or shared negatives), batch-hard triplet, the
curriculum combiner, the reference's shipped negative-mean-cosine objective
and the sampled-softmax (InfoNCE) loss that the trainer uses by default.
"""

from __future__ import annotations

import torch


def max_margin_loss(query: torch.Tensor, positive: torch.Tensor,
                    negative: torch.Tensor, margin: float = 0.1) -> torch.Tensor:
    """Hinge ``max(0, margin + max_neg_sim - pos_sim)``. ``negative`` is
    [B, N, D] (per row), [N, D] with N != B (a shared pool: max over it) or
    [B, D] (one paired negative per row; a pool of exactly B rows is read as
    paired, as in the JAX function)."""
    pos_sim = (query * positive).sum(dim=1)
    if negative.dim() == 3:
        max_neg = torch.einsum("bd,bnd->bn", query, negative).amax(dim=1)
    elif negative.dim() == 2 and negative.shape[0] != query.shape[0]:
        max_neg = (query @ negative.T).amax(dim=1)
    else:
        max_neg = (query * negative).sum(dim=1)
    return torch.relu(margin + max_neg - pos_sim).mean()


def shared_pool_max_margin_loss(query: torch.Tensor, positive: torch.Tensor,
                                negative_pool: torch.Tensor,
                                margin: float = 0.1) -> torch.Tensor:
    """Hinge against the hardest of N shared negatives per query."""
    pos_sim = (query * positive).sum(dim=1)
    max_neg = (query @ negative_pool.T).amax(dim=1)
    return torch.relu(margin + max_neg - pos_sim).mean()


def batch_hard_triplet_loss(query: torch.Tensor, positive: torch.Tensor,
                            margin: float = 0.1, batch_positives: torch.Tensor | None = None,
                            offset: int = 0) -> torch.Tensor:
    """Hardest in-batch negative from the masked query-positive similarity
    matrix. ``batch_positives`` is the whole batch's positives where
    ``query`` / ``positive`` are rows ``offset..`` of it (a rank's share)."""
    cand = positive if batch_positives is None else batch_positives
    sim = query @ cand.T
    eye = torch.eye(query.shape[0], cand.shape[0], dtype=sim.dtype, device=sim.device)
    if offset:
        eye = torch.roll(eye, offset, dims=1)
    hardest = (sim * (1.0 - eye) - eye * 1e9).amax(dim=1)
    pos_sim = (query * positive).sum(dim=1)
    return torch.relu(margin + hardest - pos_sim).mean()


def curriculum_loss(query: torch.Tensor, positive: torch.Tensor,
                    random_negatives: torch.Tensor,
                    hard_negatives: torch.Tensor | None, epoch: float | torch.Tensor,
                    margin: float = 0.1, max_epochs: int = 10,
                    hard_negative_factor: float = 2.0) -> torch.Tensor:
    """Base hinge on the random negatives (a 2-D pool is always shared) plus
    ``min(epoch, max_epochs) / max_epochs * hard_negative_factor`` times the
    hinge on the hard negatives [B, H, D]. ``epoch`` is a number or a 0-d
    tensor on the embeddings' device (as JAX's traced epoch: a new epoch
    changes no captured step); the weight is computed in f32 in JAX's
    order."""
    if random_negatives.dim() == 2:
        base = shared_pool_max_margin_loss(query, positive, random_negatives, margin)
    else:
        base = max_margin_loss(query, positive, random_negatives, margin)
    if hard_negatives is None:
        return base
    hard = max_margin_loss(query, positive, hard_negatives, margin)
    epoch = torch.as_tensor(epoch, dtype=torch.float32, device=query.device)
    hard_weight = torch.clamp(epoch, max=float(max_epochs)) / max_epochs * hard_negative_factor
    return base + hard_weight * hard


def cosine_objective(query: torch.Tensor, positive: torch.Tensor) -> torch.Tensor:
    """The reference's shipped simplified objective: ``-mean(sum(q * p))``."""
    return -(query * positive).sum(dim=1).mean()


def nce_loss(query: torch.Tensor, positive: torch.Tensor,
             negative_pool: torch.Tensor,
             hard_negatives: torch.Tensor | None = None,
             temperature: float = 0.1) -> torch.Tensor:
    """Cross-entropy of the positive against the shared negative pool [N, D]
    and the optional per-query hard negatives [B, H, D]; log-softmax in f32."""
    logits = [((query * positive).sum(dim=1) / temperature)[:, None],
              (query @ negative_pool.T) / temperature]
    if hard_negatives is not None:
        logits.append(torch.einsum("bd,bhd->bh", query, hard_negatives) / temperature)
    logits = torch.cat(logits, dim=1).float()
    return -torch.log_softmax(logits, dim=1)[:, 0].mean()
