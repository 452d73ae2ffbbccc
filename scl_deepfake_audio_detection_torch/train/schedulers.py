"""Learning-rate policy library.

Capability match for the vendored NII optimizer wrapper's scheduler menu
(``core_scripts/op_manager/lr_scheduler.py:25+``: ReduceLROnPlateau, StepLR,
ExponentialLR, CosineAnnealingWarmRestarts) plus the active path's CyclicLR
(which lives in ``train/optim.py:cyclic_exp_lr``).

Counterpart of ``scl_deepfake_audio_detection_tpu/train/schedulers.py``
(the same code).  All schedules are host-side closed forms or tiny stateful
objects producing a plain float per epoch, which the caller hands to
``train/optim.set_learning_rate``.
"""

from __future__ import annotations

import math
from typing import Optional


def step_lr(epoch: int, base_lr: float, step_size: int = 30, gamma: float = 0.1) -> float:
    """torch StepLR: decay by gamma every step_size epochs."""
    return base_lr * gamma ** (epoch // step_size)


def exponential_lr(epoch: int, base_lr: float, gamma: float = 0.9) -> float:
    """torch ExponentialLR: base * gamma^epoch."""
    return base_lr * gamma**epoch


def cosine_warm_restarts(
    epoch: float, base_lr: float, t0: int = 10, t_mult: int = 1,
    eta_min: float = 0.0,
) -> float:
    """torch CosineAnnealingWarmRestarts value at (possibly fractional) epoch."""
    if t_mult == 1:
        t_cur = epoch % t0
        t_i = t0
    else:
        n = math.floor(math.log(epoch / t0 * (t_mult - 1) + 1, t_mult))
        t_cur = epoch - t0 * (t_mult**n - 1) / (t_mult - 1)
        t_i = t0 * t_mult**n
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2


class ReduceLROnPlateau:
    """torch-semantics plateau scheduler: shrink LR by ``factor`` after
    ``patience`` epochs without improvement (default mode 'min' on val loss,
    like the NII wrapper's default)."""

    def __init__(
        self,
        base_lr: float,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 5,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        assert mode in ("min", "max")
        self.lr = base_lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1 - self.threshold)
        return metric > self.best * (1 + self.threshold)

    def step(self, metric: float) -> float:
        """Record this epoch's metric; returns the LR to use next epoch."""
        if self._improved(metric):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "bad_epochs": self.bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.lr, self.best, self.bad_epochs = d["lr"], d["best"], d["bad_epochs"]


SCHEDULES = {
    "cyclic": "train.optim.cyclic_exp_lr (active-path default)",
    "step": step_lr,
    "exponential": exponential_lr,
    "cosine_warm_restarts": cosine_warm_restarts,
    "plateau": ReduceLROnPlateau,
}
