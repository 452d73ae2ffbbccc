"""Length normalisation: eval padding and the multiview co-random-crop.

Counterpart of ``scl_deepfake_audio_detection_tpu/dsp/pad.py``:
- eval ``pad`` (reference ``datautils/asvspoof_2019_augall_3.py:49-60``):
  truncate to 64600, or zero-pad / tile-repeat up to it;
- train ``batch_pad_for_multiview`` (``wav_augmentation.py:209-282``): the
  views of an anchor group are length-matched to view 0 (tiled or
  zero-padded), then one random 64000-sample crop is taken from all of
  them, so every view covers the same stretch of speech;
- the silence trims ``wav_rand_sil_trim`` and
  ``batch_siltrim_for_multiview`` (``wav_augmentation.py:78-206``), over
  the energy VAD's speech bounds (``dsp/vad.speech_bounds_samples``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from scl_deepfake_audio_detection_torch.dsp.vad import speech_bounds_samples


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


def rand_sil_trim(
    x: np.ndarray,
    sr: int = 16000,
    random_trim_sil: bool = False,
    rng: Optional[np.random.Generator] = None,
):
    """Trim leading and trailing silence by the energy VAD; with
    ``random_trim_sil`` keep a random fraction of it (``wav_rand_sil_trim``,
    ``wav_augmentation.py:78-140``).

    Returns ``(trimmed, start, end)`` with ``trimmed = x[start:end]``; a
    degenerate range (or one starting at 0, the reference's guard) passes
    the input through unchanged."""
    start, end = speech_bounds_samples(x, sr)
    if random_trim_sil:
        rng = rng or np.random.default_rng()
        prob = rng.random()
        start = int(start * prob)
        end = int((x.shape[0] - end) * prob) + end
    if 0 < start < end:
        return x[start:end], start, end
    return x, 0, x.shape[0]


def multiview_silence_trim(
    views: Sequence[np.ndarray],
    sr: int = 16000,
    random_trim_sil: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> List[np.ndarray]:
    """Co-trim every view at the silence bounds of view 0
    (``batch_siltrim_for_multiview``, ``wav_augmentation.py:170-206``), so
    that the views stay sample-aligned."""
    _, start, end = rand_sil_trim(views[0], sr, random_trim_sil, rng)
    if 0 < start < end:
        return [v[start:end] for v in views]
    return list(views)


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
