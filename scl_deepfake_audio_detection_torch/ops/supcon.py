"""Supervised contrastive loss (SupCon), the SCL training objective.

Counterpart of ``scl_deepfake_audio_detection_tpu/ops/supcon.py``, with every
numerics quirk of the reference kept, since they shape the trained optimum:

- the LogSumExp max is taken over ``logits * self_mask`` (the diagonal is
  zeroed before the max, not left out), with no gradient through it;
- the exponent is ``exp((logits - max) * self_mask) * self_mask``;
- the contrast set is the view-major concat, and the positive mask tiles the
  label mask ``(anchor_count, n_views)`` and drops the diagonal;
- an anchor with no positive contributes 0 (the reference gives NaN).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Similarity = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def seq_similarity(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Mean-over-time frame similarity: [A, T, D] x [C, T, D] -> [A, C]."""
    return torch.einsum("atd,ctd->ac", a.float(), c.float()) / a.shape[1]


def flat_similarity(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain dot-product similarity on flat feature vectors [N, D]."""
    return a.float() @ c.float().t()


def supcon_loss(
    feat: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    sim_metric: Optional[Similarity] = seq_similarity,
    temperature: float = 0.07,
    contra_mode: str = "all",
    length_norm: bool = False,
) -> torch.Tensor:
    """SupCon over multi-view features.

    feat: [bs, n_views, ...]; the trailing dims go to ``sim_metric`` (or are
    flattened for the dot product when it is None).  labels: [bs]; same-label
    pairs are positives.  Exclusive with ``mask`` [bs, bs].
    contra_mode: 'all' (every view anchors) or 'one' (the first view)."""
    if labels is not None and mask is not None:
        raise ValueError("cannot define both labels and mask")
    if contra_mode not in ("all", "one"):
        raise ValueError(f"unknown contra_mode: {contra_mode!r}")
    if length_norm:
        feat = feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True) + 1e-12)

    bs, nv = feat.shape[0], feat.shape[1]
    if labels is not None:
        labels = labels.reshape(-1)
        mask = (labels[:, None] == labels[None, :]).float()
    elif mask is None:
        mask = torch.eye(bs, device=feat.device)
    else:
        mask = mask.float()

    contrast = torch.cat([feat[:, i] for i in range(nv)], dim=0)  # view-major
    if contra_mode == "one":
        anchor, anchor_count = feat[:, 0], 1
    else:
        anchor, anchor_count = contrast, nv
    if sim_metric is None:
        logits = flat_similarity(anchor.reshape(anchor.shape[0], -1),
                                 contrast.reshape(contrast.shape[0], -1))
    else:
        logits = sim_metric(anchor, contrast)
    logits = logits / temperature

    n_anchor, n_contrast = bs * anchor_count, bs * nv
    row = torch.arange(n_anchor, device=feat.device)[:, None]
    col = torch.arange(n_contrast, device=feat.device)[None, :]
    self_mask = (row != col).float()
    pos_mask = mask.repeat(anchor_count, nv) * self_mask

    logits_max = (logits * self_mask).amax(dim=1, keepdim=True).detach()
    shifted = logits - logits_max
    exp_logits = torch.exp(shifted * self_mask) * self_mask
    log_prob = shifted - torch.log(exp_logits.sum(dim=1, keepdim=True))

    n_pos = pos_mask.sum(dim=1)
    mean_log_prob_pos = torch.where(
        n_pos > 0, (pos_mask * log_prob).sum(dim=1) / n_pos.clamp(min=1.0),
        torch.zeros_like(n_pos))
    return -mean_log_prob_pos.reshape(anchor_count, bs).mean()
