"""Observability: tensorboard scalars and profiler traces.

Counterpart of ``scl_deepfake_audio_detection_tpu/train/tblog.py``, after
the reference's tensorboardX scalars (``main.py:18,399,407-414``: per-epoch
train/val accuracy, total loss and a per-loss-name group) and its profiling
trainer (``core_scripts/nn_manager/nn_manager_profile.py``):

- scalars through ``torch.utils.tensorboard`` when it imports, else a no-op
  writer; ``metrics.jsonl`` (``Engine.fit``) is always written;
- traces from ``torch.profiler`` (host and, on the card, CUDA activity),
  written as a Chrome trace file under the trace directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


def tensorboard_available() -> bool:
    """Whether ``torch.utils.tensorboard`` imports (it needs the
    ``tensorboard`` package)."""
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
    except Exception:
        return False
    return True


class ScalarWriter:
    """Tensorboard scalar writer with a silent no-op fallback."""

    def __init__(self, logdir: Optional[str]):
        self._w = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                os.makedirs(logdir, exist_ok=True)
                self._w = SummaryWriter(logdir)
            except Exception:
                self._w = None

    def scalars(self, record: Dict[str, float], step: int) -> None:
        """One epoch record: every number as a top-level scalar, and the
        per-loss terms again under ``loss_detail/``."""
        if self._w is None:
            return
        for k, v in record.items():
            if isinstance(v, (int, float)):
                self._w.add_scalar(k, v, step)
        for k, v in record.items():
            if k.startswith(("train_L_", "val_L_")) and isinstance(v, (int, float)):
                self._w.add_scalar(f"loss_detail/{k}", v, step)

    def close(self) -> None:
        if self._w is not None:
            self._w.flush()
            self._w.close()


@contextlib.contextmanager
def trace_epoch(logdir: Optional[str]):
    """Record a ``torch.profiler`` trace of the block (one epoch) and write
    it to ``<logdir>/trace_<time>.json`` (Chrome trace format; open it in
    Perfetto or ``chrome://tracing``).  No-op when ``logdir`` is None."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))
