"""The score step (counterpart of ``Engine.score_step`` in
``scl_deepfake_audio_detection_tpu/train/engine.py``).  Training comes with
the next slice."""

from __future__ import annotations

import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models.base import eval_scores
from scl_deepfake_audio_detection_torch.ops.layers import dewire_pcm16


def score_step(model: nn.Module, wav) -> torch.Tensor:
    """wav [B, T] (numpy or tensor; fp32, or int16 PCM wire) -> the eval
    score columns [B, 2] on the model's device.  The result is not copied
    to the host, so the caller can keep the next batch in flight."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        wav = torch.as_tensor(wav).to(device, non_blocking=True)
        return eval_scores(model, model.apply(dewire_pcm16(wav), train=False))
