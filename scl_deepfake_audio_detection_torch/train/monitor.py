"""Training monitor: per-epoch/per-step loss and time matrices.

Capability match for the vendored NII ``Monitor``
(``core_scripts/op_manager/op_process_monitor.py:21-60``): records a
[epochs x steps] matrix of every named loss plus wall time, tracks the best
epoch, serializes for exact resume, and prints compact epoch summaries.
Counterpart of ``scl_deepfake_audio_detection_tpu/train/monitor.py`` (the
same code).  Backed by plain numpy; its state is a tree of arrays plus a
JSON-able meta dict, so ``state_dict()`` round-trips through
``train/checkpoint.save`` (the meta as ``extra``) and ``load``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np


class Monitor:
    def __init__(self, num_epochs: int, steps_per_epoch: int):
        self.num_epochs = num_epochs
        self.steps_per_epoch = steps_per_epoch
        self.time_mat = np.zeros((num_epochs, steps_per_epoch), np.float32)
        self.loss_mats: Dict[str, np.ndarray] = {}
        self.seen_steps = np.zeros(num_epochs, np.int32)
        self.best_epoch: int = -1
        self.best_value: float = float("inf")
        self._t0: Optional[float] = None

    # ------------------------------------------------------------- recording
    def start_step(self) -> None:
        self._t0 = time.time()

    def log_step(self, epoch: int, step: int, losses: Dict[str, float]) -> None:
        if self._t0 is not None:
            self.time_mat[epoch, step] = time.time() - self._t0
            self._t0 = None
        for name, val in losses.items():
            if name not in self.loss_mats:
                self.loss_mats[name] = np.zeros(
                    (self.num_epochs, self.steps_per_epoch), np.float32
                )
            self.loss_mats[name][epoch, step] = float(val)
        self.seen_steps[epoch] = max(self.seen_steps[epoch], step + 1)

    def end_epoch(self, epoch: int, criterion: Optional[float] = None) -> bool:
        """Returns True if this epoch is the new best (lower criterion; the
        mean total loss when none is given)."""
        if criterion is None:
            criterion = self.epoch_mean(epoch).get("loss", float("inf"))
        if criterion < self.best_value:
            self.best_value = float(criterion)
            self.best_epoch = epoch
            return True
        return False

    # --------------------------------------------------------------- queries
    def epoch_mean(self, epoch: int) -> Dict[str, float]:
        n = max(int(self.seen_steps[epoch]), 1)
        out = {k: float(m[epoch, :n].mean()) for k, m in self.loss_mats.items()}
        out["time"] = float(self.time_mat[epoch, :n].sum())
        return out

    def summary(self, epoch: int) -> str:
        m = self.epoch_mean(epoch)
        losses = " ".join(f"{k}={v:.5f}" for k, v in m.items() if k != "time")
        return f"epoch {epoch:03d} | {losses} | {m['time']:.1f}s"

    # ----------------------------------------------------------------- state
    def state_dict(self) -> dict:
        return {
            "time_mat": self.time_mat,
            "loss_mats": dict(self.loss_mats),
            "seen_steps": self.seen_steps,
            "meta": {
                "num_epochs": self.num_epochs,
                "steps_per_epoch": self.steps_per_epoch,
                "best_epoch": self.best_epoch,
                "best_value": self.best_value,
            },
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "Monitor":
        meta = d["meta"]
        mon = cls(int(meta["num_epochs"]), int(meta["steps_per_epoch"]))
        mon.time_mat = np.asarray(d["time_mat"])
        mon.loss_mats = {k: np.asarray(v) for k, v in d["loss_mats"].items()}
        mon.seen_steps = np.asarray(d["seen_steps"])
        mon.best_epoch = int(meta["best_epoch"])
        mon.best_value = float(meta["best_value"])
        return mon
