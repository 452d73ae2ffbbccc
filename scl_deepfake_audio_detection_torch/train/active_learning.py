"""Active-learning training loop — capability match for the NII AL manager.

The reference vendors ``core_scripts/nn_manager/nn_manager_AL.py`` (643 LoC,
dead on its active path) whose capability is cycle-based pool selection:
optionally pre-train, then repeat {train K epochs -> score the unlabeled
pool with a model-defined retrieval criterion -> move N samples from the
pool into the training set}, with knobs for with/without replacement
(``:123,148``), training on only-new vs accumulated data (``:119,153``),
and a cache file recording the selected sample names so an interrupted AL
run resumes its selection history (``:314-320``).

Counterpart of ``scl_deepfake_audio_detection_tpu/train/active_learning.py``
(the same code).  Selection operates on *index lists* into the host-side
dataset/builder (cheap, order-stable), while scoring batches the whole pool
through ``train/engine.score_step`` on the card — the pool sweep is just
another fixed-shape scoring pass.  Criteria are pluggable pure functions over the model's
``[N, C]`` log-probs; 'entropy' (predictive uncertainty, the standard AL
default), 'margin', and 'random' ship here.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def criterion_entropy(log_probs: np.ndarray, rng) -> np.ndarray:
    """Predictive entropy, descending = most uncertain first.

    Saturated log_softmax outputs carry -inf for the losing classes;
    0 * -inf is NaN and a NaN score would silently sort the item LAST —
    permanently excluding it from selection — so those terms contribute
    their true limit, 0."""
    p = np.exp(log_probs)
    return -(p * np.where(p > 0.0, log_probs, 0.0)).sum(-1)


def criterion_margin(log_probs: np.ndarray, rng) -> np.ndarray:
    """Negative top-2 margin: small margin = uncertain = high score."""
    s = np.sort(log_probs, axis=-1)
    return -(s[..., -1] - s[..., -2])


def criterion_random(log_probs: np.ndarray, rng) -> np.ndarray:
    return rng.random(log_probs.shape[0])


CRITERIA: Dict[str, Callable] = {
    "entropy": criterion_entropy,
    "margin": criterion_margin,
    "random": criterion_random,
}


@dataclass
class ALConfig:
    """Mirrors the NII flags (``config_parse/arg_parse.py`` active-learning
    group / ``nn_manager_AL.py:116-153``)."""

    cycles: int = 4  # active_learning_cycle_num
    samples_per_cycle: int = 16  # active_learning_new_sample_per_cycle
    epochs_per_cycle: int = 1
    pre_train_epochs: int = 0  # active_learning_pre_train_epoch_num
    with_replacement: bool = False  # keep selected items in the pool
    use_new_data_only: bool = False  # train each cycle on only-new samples
    criterion: str = "entropy"
    cache_path: Optional[str] = None  # selection-history JSON (resume)
    seed: int = 0


@dataclass
class ALState:
    train_idx: List[int]
    pool_idx: List[int]
    history: List[List[int]] = field(default_factory=list)  # per-cycle picks

    def save(self, path: str) -> None:
        # atomic: this cache exists to survive interrupted runs, so the
        # write itself must survive a mid-write kill (tmp + os.replace,
        # same pattern as checkpoint._write_flat)
        import tempfile

        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)) or ".")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(
                    {"train": self.train_idx, "pool": self.pool_idx,
                     "history": self.history}, f,
                )
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "ALState":
        with open(path) as f:
            d = json.load(f)
        return cls(d["train"], d["pool"], d["history"])


def select_from_pool(
    scores: np.ndarray, pool_idx: Sequence[int], n: int
) -> List[int]:
    """Top-n pool indices by descending criterion score (stable order)."""
    order = np.argsort(-np.asarray(scores), kind="stable")[: max(n, 0)]
    return [pool_idx[i] for i in order]


def al_loop(
    cfg: ALConfig,
    train_idx: Sequence[int],
    pool_idx: Sequence[int],
    train_epochs_fn: Callable[[List[int], int], None],
    score_pool_fn: Callable[[List[int]], np.ndarray],
    log_fn: Optional[Callable[[int, Dict], None]] = None,
) -> ALState:
    """Run the AL cycles.

    ``train_epochs_fn(indices, num_epochs)``: train on the given dataset
    indices (the caller owns engine/params — typically a closure over
    ``Engine.fit`` with a sub-list loader).
    ``score_pool_fn(indices) -> [N, C] log-probs`` for the pool items (the
    scoring pass, e.g. ``score_step`` batches read back to the host).

    Resumes from ``cfg.cache_path`` when it exists: the recorded selection
    history is replayed (indices moved, no retraining of past cycles is
    re-run beyond the caller's checkpoints) — the NII cache-file behavior
    (``nn_manager_AL.py:314-337``).
    """
    state = ALState(list(train_idx), list(pool_idx))
    done_cycles = 0
    if cfg.cache_path and os.path.isfile(cfg.cache_path):
        state = ALState.load(cfg.cache_path)
        done_cycles = len(state.history)

    if cfg.pre_train_epochs and done_cycles == 0:
        train_epochs_fn(list(state.train_idx), cfg.pre_train_epochs)

    crit = CRITERIA[cfg.criterion]
    for cycle in range(done_cycles, cfg.cycles):
        if not state.pool_idx:
            break
        # per-cycle RNG keyed on (seed, cycle): a run resumed from the cache
        # after cycle k draws the same criterion stream at cycle k+1 as the
        # uninterrupted run (matters for criterion='random')
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, cycle]))
        scores = np.asarray(crit(score_pool_fn(list(state.pool_idx)), rng))
        picks = select_from_pool(scores, state.pool_idx, cfg.samples_per_cycle)
        if not cfg.with_replacement:
            state.pool_idx = [i for i in state.pool_idx if i not in set(picks)]
        state.train_idx = sorted(set(state.train_idx) | set(picks))
        state.history.append(list(picks))

        train_set = list(picks) if cfg.use_new_data_only else list(state.train_idx)
        train_epochs_fn(train_set, cfg.epochs_per_cycle)

        if log_fn:
            log_fn(cycle, {
                "picked": picks,
                "train_size": len(state.train_idx),
                "pool_size": len(state.pool_idx),
            })
        if cfg.cache_path:
            state.save(cfg.cache_path)
    return state
