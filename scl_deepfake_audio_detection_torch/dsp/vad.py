"""Framing for the energy VAD.  Only ``frame_signal`` is ported, which
``dsp/augment`` uses; the rest of the JAX package's ``dsp/vad.py`` comes
with Slice H."""

from __future__ import annotations

import numpy as np


def frame_signal(x: np.ndarray, frame_len: int, frame_shift: int) -> np.ndarray:
    """[T] -> [n_frames, frame_len], 'nodelay' framing (the tail dropped)."""
    n = 1 + (x.shape[0] - frame_len) // frame_shift if x.shape[0] >= frame_len else 0
    idx = np.arange(frame_len)[None, :] + frame_shift * np.arange(n)[:, None]
    return x[idx]
