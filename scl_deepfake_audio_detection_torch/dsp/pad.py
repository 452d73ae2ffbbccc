"""Length normalisation: eval padding and the multiview co-random-crop.

Counterpart of ``scl_deepfake_audio_detection_tpu/dsp/pad.py``:
- eval ``pad`` (reference ``datautils/asvspoof_2019_augall_3.py:49-60``):
  truncate to 64600, or zero-pad / tile-repeat up to it;
- train ``batch_pad_for_multiview`` (``wav_augmentation.py:209-282``): the
  views of an anchor group are length-matched to view 0 (tiled or
  zero-padded), then one random 64000-sample crop is taken from all of
  them, so every view covers the same stretch of speech.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def pad_eval(x: np.ndarray, padding_type: str = "zero", max_len: int = 64600) -> np.ndarray:
    n = x.shape[0]
    if n >= max_len:
        return x[:max_len]
    if padding_type == "repeat":
        reps = max_len // n + 1
        return np.tile(x, reps)[:max_len]
    if padding_type == "zero":
        out = np.zeros(max_len, dtype=x.dtype)
        out[:n] = x
        return out
    raise ValueError(f"padding_type must be 'zero' or 'repeat', got {padding_type!r}")


def _match_length(x: np.ndarray, length: int, repeat_pad: bool) -> np.ndarray:
    if x.shape[0] >= length:
        return x[:length]
    if repeat_pad:
        reps = length // x.shape[0] + 1
        return np.tile(x, reps)[:length]
    out = np.zeros(length, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def multiview_pad(views: Sequence[np.ndarray], length: int, repeat_pad: bool = True,
                  random_trim: bool = True,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Co-crop 1-D waveforms to [V, length] at one offset: every view is
    length-matched to view 0; a longer group takes one random start (with
    ``random_trim``), a shorter one is tiled (``repeat_pad``) or
    zero-padded up to ``length``."""
    rng = rng or np.random.default_rng()
    base_len = views[0].shape[0]
    matched = [_match_length(v, base_len, repeat_pad) for v in views]
    if base_len < length:
        matched = [_match_length(v, length, repeat_pad) for v in matched]
        start = 0
    elif random_trim and base_len > length:
        start = int(rng.random() * (base_len - length))
    else:
        start = 0
    return np.stack([v[start : start + length] for v in matched], axis=0)
