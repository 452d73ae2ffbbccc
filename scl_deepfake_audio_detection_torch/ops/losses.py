"""Cross-entropy as the training loss uses it.

Counterpart of ``cross_entropy`` and ``nll_on_log_probs`` in
``scl_deepfake_audio_detection_tpu/ops/losses.py``.  ``nll_on_log_probs``
keeps the reference's double softmax: torch ``CrossEntropyLoss`` applied to
outputs that are already log-probabilities.  The rest of that module (energy,
mixup, KLD, rank losses) belongs to other models and is not ported yet.
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch; logits [N, C], labels [N] int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


def nll_on_log_probs(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``CrossEntropyLoss()(log_probs, labels)``: a second log-softmax over
    inputs that are already log-probabilities."""
    return cross_entropy(log_probs, labels)
