"""Eval score-file writer, byte-compatible with the JAX package's
(``scl_deepfake_audio_detection_tpu/train/scoring.py``) and the reference's
``utt cm0 cm1`` format.  Floats print as ``str(float(x))`` of the float32
value."""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch


def _fmt(x: float) -> str:
    return str(float(x))


def _pipelined(batches, launch, depth: int = 2):
    """Keep ``depth`` scoring calls in flight before reading results back.

    ``launch(wav)`` returns a device tensor while the card still computes;
    reading with a lag overlaps the next batch's host work and transfer
    with the previous batch's compute."""
    pending = deque()
    for wav, utts in batches:
        pending.append((utts, launch(wav)))
        if len(pending) > depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def produce_evaluation_file(
    batches: Iterable[Tuple[np.ndarray, list]],
    score_fn: Callable,
    out_path: str,
    progress: Optional[Callable[[int], None]] = None,
) -> None:
    """``utt cm0 cm1`` lines.  ``score_fn`` maps wav [B, T] -> log_probs
    [B, 2]; padded tail rows (beyond len(utts)) are dropped."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".", exist_ok=True)
    done = 0
    with open(out_path, "w") as f:
        for utts, lp_dev in _pipelined(batches, score_fn):
            lp = _to_numpy(lp_dev)[: len(utts)]
            for utt, row in zip(utts, lp):
                f.write(f"{utt} {_fmt(row[0])} {_fmt(row[1])}\n")
            done += len(utts)
            if progress:
                progress(done)
