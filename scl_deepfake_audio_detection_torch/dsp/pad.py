"""Eval-side fixed-length policy (reference ``pad``,
``datautils/asvspoof_2019_augall_3.py:49-60``): truncate to ``max_len``, or
zero-pad / tile-repeat up to it."""

from __future__ import annotations

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
