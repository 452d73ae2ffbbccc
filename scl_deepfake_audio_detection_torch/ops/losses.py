"""Loss library.

Counterpart of ``scl_deepfake_audio_detection_tpu/ops/losses.py`` (SupCon
lives in ``ops/supcon.py``): cross-entropy as the training loss uses it,
negative-energy OOD scores, mixup CE, the distillation KLD and the
rank-consistency family.  ``nll_on_log_probs`` keeps the reference's double
softmax: torch ``CrossEntropyLoss`` applied to outputs that are already
log-probabilities.  The rank losses visit the pairs in the JAX module's
order (``jnp.tril_indices``'s, row-major) and average the kept ones.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch; logits [N, C], labels [N] int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


def nll_on_log_probs(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``CrossEntropyLoss()(log_probs, labels)``: a second log-softmax over
    inputs that are already log-probabilities."""
    return cross_entropy(log_probs, labels)


def neg_energy(logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Negative free energy -T*logsumexp(logits/T) per row
    (reference ``loss_metrics.py:39-56``; Liu et al., NeurIPS 2020)."""
    return -temperature * torch.logsumexp(logits / temperature, dim=1)


def neg_energy_reg_loss(energy: torch.Tensor, margin_in: float, margin_out: float,
                        flag_in: bool) -> torch.Tensor:
    """Energy regulariser (reference ``loss_metrics.py:59-79``)."""
    if flag_in:
        return torch.mean(torch.relu(energy - margin_in) ** 2)
    return torch.mean(torch.relu(margin_out - energy) ** 2)


def mixup_ce(logits: torch.Tensor, y1: torch.Tensor, y2: Optional[torch.Tensor] = None,
             gammas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mixup cross-entropy (reference ``loss_metrics.py:216-250``):
    gamma*CE(logits,y1) + (1-gamma)*CE(logits,y2), mean over the batch."""
    if (y2 is None) != (gammas is None):
        raise ValueError("mixup_ce needs y2 and gammas together (or neither "
                         "for plain CE)")
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll1 = -logp.gather(1, y1.long()[:, None])[:, 0]
    if y2 is None:
        return nll1.mean()
    nll2 = -logp.gather(1, y2.long()[:, None])[:, 0]
    return torch.mean(gammas * nll1 + (1.0 - gammas) * nll2)


def kld_distill(logits_s: torch.Tensor, logits_t: torch.Tensor,
                temp: float = 20.0) -> torch.Tensor:
    """Distillation KLD with temperature (reference ``loss_metrics.py:258-279``):
    KL(teacher || student) * T^2, batchmean reduction."""
    logp_s = torch.log_softmax(logits_s / temp, dim=-1)
    logp_t = torch.log_softmax(logits_t / temp, dim=-1)
    kl = torch.sum(torch.exp(logp_t) * (logp_t - logp_s), dim=-1)
    return torch.sum(kl) / logits_s.shape[0] * temp * temp


def _neg_cosine(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    x1, x2 = x1.reshape(-1), x2.reshape(-1)
    denom = torch.clamp(torch.linalg.vector_norm(x1) * torch.linalg.vector_norm(x2), min=1e-8)
    return -torch.dot(x1, x2) / denom


def _margin_ranking(x1: torch.Tensor, x2: torch.Tensor, margin: float = 0.1) -> torch.Tensor:
    """torch margin_ranking_loss with target=+1: mean(relu(-(x1-x2)+margin))."""
    return torch.mean(torch.relu(-(x1 - x2) + margin))


def _pairs(bs: int):
    """(rows, cols) of the strict lower triangle, row-major as
    ``jnp.tril_indices(bs, k=-1)``."""
    rows, cols = torch.tril_indices(bs, bs, offset=-1)
    return rows.tolist(), cols.tolist()


def rank_consistency(x: torch.Tensor, metric: Optional[Callable] = None,
                     anchor: Optional[torch.Tensor] = None,
                     diff_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Anchored rank consistency (reference ``loss_metrics.py:284-363``):
    every strict-lower-triangle difference vector ``diff[i, j] = x[j] -
    x[i]`` (i > j) against an anchor (default ``diff[1, 0]``, whose own cell
    is skipped) under ``metric`` (default negative cosine), averaged."""
    if diff_mat is None:
        diff_mat = x[None, :] - x[:, None]  # diff_mat[i, j] = x[j] - x[i]
    bs = diff_mat.shape[0]
    if bs < 3:
        return diff_mat.new_zeros(())
    metric = metric or _neg_cosine
    if anchor is None:
        anchor, skip = diff_mat[1, 0], (1, 0)
    else:
        skip = None
    vals = [metric(anchor, diff_mat[r, c]) for r, c in zip(*_pairs(bs)) if (r, c) != skip]
    return torch.stack(vals).mean()


def rank_consistency_v2(x: torch.Tensor, metric: Optional[Callable] = None,
                        diff_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Neighbour-difference rank consistency (reference ``loss_metrics.py:366-438``)."""
    if diff_mat is None:
        diff_mat = x[None, :] - x[:, None]
    bs = diff_mat.shape[0]
    if bs < 3:
        return diff_mat.new_zeros(())
    metric = metric or _margin_ranking
    vals = []
    for col in range(bs - 2):
        for row in range(col + 2, bs):
            vals.append(metric(diff_mat[row - 1, col], diff_mat[row, col]))
    for row in range(2, bs):
        for col in range(1, row):
            vals.append(metric(diff_mat[row, col], diff_mat[row, col - 1]))
    return torch.stack(vals).mean()


def rank_consistency_v3(x: torch.Tensor, metric: Optional[Callable] = None) -> torch.Tensor:
    """All-pairs ranking loss (reference ``loss_metrics.py:441-496``): every
    x[i] should rank above every x[j] for i > j."""
    bs = x.shape[0]
    if bs < 2:
        return x.new_zeros(())
    metric = metric or _margin_ranking
    return torch.stack([metric(x[r], x[c]) for r, c in zip(*_pairs(bs))]).mean()
