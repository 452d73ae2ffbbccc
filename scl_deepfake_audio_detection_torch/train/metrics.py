"""EER for ``--early_metric eer``: the port's copy of ``det_curve`` and
``compute_eer`` from ``scl_deepfake_audio_detection_tpu/train/metrics.py``
(reference ``evaluate_metrics.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def det_curve(target_scores: np.ndarray,
              nontarget_scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(frr, far, thresholds) over all score thresholds; target = bonafide."""
    target_scores = np.asarray(target_scores, dtype=np.float64).ravel()
    nontarget_scores = np.asarray(nontarget_scores, dtype=np.float64).ravel()
    n_tar, n_non = target_scores.size, nontarget_scores.size
    if n_tar == 0 or n_non == 0:
        raise ValueError("both target and nontarget scores must be non-empty")
    scores = np.concatenate([target_scores, nontarget_scores])
    is_target = np.concatenate([np.ones(n_tar), np.zeros(n_non)])
    order = np.argsort(scores, kind="mergesort")  # stable: ties as the reference
    is_target = is_target[order]
    tar_below = np.cumsum(is_target)
    non_above = n_non - (np.arange(1, n_tar + n_non + 1) - tar_below)
    frr = np.concatenate([[0.0], tar_below / n_tar])
    far = np.concatenate([[1.0], non_above / n_non])
    thresholds = np.concatenate([[scores[order[0]] - 0.001], scores[order]])
    return frr, far, thresholds


def compute_eer(target_scores: np.ndarray,
                nontarget_scores: np.ndarray) -> Tuple[float, float]:
    """Equal error rate and its threshold."""
    frr, far, thresholds = det_curve(target_scores, nontarget_scores)
    idx = int(np.argmin(np.abs(frr - far)))
    return float((frr[idx] + far[idx]) / 2.0), float(thresholds[idx])
