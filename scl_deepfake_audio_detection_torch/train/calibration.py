"""Score calibration: affine LLR calibration and fusion, Cllr / minCllr,
actual DCF.  The port's copy of
``scl_deepfake_audio_detection_tpu/train/calibration.py``; pure numpy on
the host.

- ``logistic_calibration`` / ``logistic_fusion``: ``llr = a*s + b`` (or
  ``w @ scores + b`` over K systems) fit by balanced maximum likelihood,
  Newton iterations on the logistic loss with equal class weight (the
  linear calibration and fusion of Brümmer's FoCal/BOSARIS toolkits);
- ``cllr``: the log-likelihood-ratio cost in bits (Brümmer & du Preez
  2006), 0 for perfect LLRs and 1.0 for llr == 0;
- ``min_cllr``: Cllr after the optimal monotone (PAV) score mapping;
- ``act_dcf``: the normalised Bayes cost at the theoretical threshold for
  scores that claim to be LLRs, beside the swept-threshold minimum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Affine (Platt) calibration
# ---------------------------------------------------------------------------

def _balanced_logistic_fit(
    X_tar: np.ndarray, X_non: np.ndarray, max_iter: int, tol: float
) -> np.ndarray:
    """Balanced-ML logistic regression over [N, K] design rows (bias added
    here); Newton-Raphson with a tiny ridge for separable data.  Returns
    beta [K+1] = (weights..., bias)."""
    if X_tar.shape[0] == 0 or X_non.shape[0] == 0:
        raise ValueError("both score sets must be non-empty")
    X = np.concatenate([X_tar, X_non])
    X = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
    y = np.concatenate([np.ones(X_tar.shape[0]), np.zeros(X_non.shape[0])])
    w = np.concatenate([
        np.full(X_tar.shape[0], 0.5 / X_tar.shape[0]),
        np.full(X_non.shape[0], 0.5 / X_non.shape[0]),
    ])
    k = X.shape[1]
    beta = np.zeros(k)
    ridge = 1e-9 * np.eye(k)
    for _ in range(max_iter):
        z = X @ beta
        p = 1.0 / (1.0 + np.exp(-z))
        g = X.T @ (w * (p - y))
        h = (X * (w * p * (1.0 - p))[:, None]).T @ X + ridge
        step = np.linalg.solve(h, g)
        beta -= step
        if np.max(np.abs(step)) < tol:
            break
    return beta


def logistic_calibration(
    target_scores: np.ndarray,
    nontarget_scores: np.ndarray,
    max_iter: int = 100,
    tol: float = 1e-10,
) -> Tuple[float, float]:
    """Fit ``llr = a * score + b`` by balanced-ML logistic regression.

    Balanced class weighting (each class contributes total weight 1/2)
    makes the fitted output a proper log-likelihood ratio rather than a
    posterior at the training class ratio.  Returns (a, b)."""
    tar = np.asarray(target_scores, np.float64).reshape(-1, 1)
    non = np.asarray(nontarget_scores, np.float64).reshape(-1, 1)
    beta = _balanced_logistic_fit(tar, non, max_iter, tol)
    return float(beta[0]), float(beta[1])


def logistic_fusion(
    target_stack: np.ndarray,
    nontarget_stack: np.ndarray,
    max_iter: int = 100,
    tol: float = 1e-10,
) -> Tuple[np.ndarray, float]:
    """Fit ``llr = w @ scores + b`` over K systems' scores [N, K]
    (Brummer-style linear score fusion, the standard way challenge entries
    combine subsystems).  Returns (weights [K], bias)."""
    tar = np.asarray(target_stack, np.float64)
    non = np.asarray(nontarget_stack, np.float64)
    if tar.ndim != 2 or non.ndim != 2 or tar.shape[1] != non.shape[1]:
        raise ValueError("score stacks must be [N, K] with matching K")
    beta = _balanced_logistic_fit(tar, non, max_iter, tol)
    return beta[:-1].copy(), float(beta[-1])


def fuse_scores(stack: np.ndarray, weights: np.ndarray, bias: float) -> np.ndarray:
    """[N, K] system scores -> fused LLRs [N]."""
    return np.asarray(stack, np.float64) @ np.asarray(weights, np.float64) + bias


def apply_calibration(scores: np.ndarray, a: float, b: float) -> np.ndarray:
    """Raw scores -> calibrated LLRs."""
    return a * np.asarray(scores, np.float64) + b


# ---------------------------------------------------------------------------
# Cllr / minCllr
# ---------------------------------------------------------------------------

def _softplus(x: np.ndarray) -> np.ndarray:
    """log(1 + e^x), overflow-safe."""
    return np.logaddexp(0.0, x)


def cllr(target_llrs: np.ndarray, nontarget_llrs: np.ndarray) -> float:
    """Log-likelihood-ratio cost in bits (Brümmer & du Preez 2006)."""
    tar = np.asarray(target_llrs, np.float64).ravel()
    non = np.asarray(nontarget_llrs, np.float64).ravel()
    if tar.size == 0 or non.size == 0:
        raise ValueError("both LLR sets must be non-empty")
    log2 = np.log(2.0)
    return float(
        0.5 * (np.mean(_softplus(-tar)) + np.mean(_softplus(non))) / log2
    )


def pav(y: np.ndarray, w: Optional[np.ndarray] = None) -> np.ndarray:
    """Weighted isotonic (non-decreasing) regression by pool-adjacent-
    violators.  Returns the fitted values, same length as ``y``."""
    y = np.asarray(y, np.float64).ravel()
    w = np.ones_like(y) if w is None else np.asarray(w, np.float64).ravel()
    # blocks as (value, weight, count) merged right-to-left on violation
    vals: list = []
    wts: list = []
    cnts: list = []
    for yi, wi in zip(y, w):
        vals.append(yi)
        wts.append(wi)
        cnts.append(1)
        while len(vals) > 1 and vals[-2] >= vals[-1]:
            v2, w2, c2 = vals.pop(), wts.pop(), cnts.pop()
            vals[-1] = (vals[-1] * wts[-1] + v2 * w2) / (wts[-1] + w2)
            wts[-1] += w2
            cnts[-1] += c2
    return np.repeat(vals, cnts)


def min_cllr(
    target_scores: np.ndarray, nontarget_scores: np.ndarray
) -> float:
    """Cllr after the OPTIMAL monotone score-to-LLR mapping (PAV):
    the discrimination component of Cllr, invariant to any monotone
    transform of the scores (the BOSARIS ``minCllr``)."""
    tar = np.asarray(target_scores, np.float64).ravel()
    non = np.asarray(nontarget_scores, np.float64).ravel()
    if tar.size == 0 or non.size == 0:
        raise ValueError("both score sets must be non-empty")
    s = np.concatenate([tar, non])
    y = np.concatenate([np.ones(tar.size), np.zeros(non.size)])
    # balanced weights -> PAV fits the calibrated posterior at prior 1/2,
    # whose logit IS the optimal LLR
    w = np.concatenate([
        np.full(tar.size, 0.5 / tar.size), np.full(non.size, 0.5 / non.size)
    ])
    order = np.argsort(s, kind="mergesort")
    p = pav(y[order], w[order])
    eps = 1e-12  # PAV emits exact 0/1 at the ends; clamp for finite logits
    llr = np.log(np.clip(p, eps, 1 - eps)) - np.log(np.clip(1 - p, eps, 1 - eps))
    llr_unsorted = np.empty_like(llr)
    llr_unsorted[order] = llr
    return cllr(llr_unsorted[: tar.size], llr_unsorted[tar.size:])


# ---------------------------------------------------------------------------
# Actual DCF at the Bayes threshold
# ---------------------------------------------------------------------------

def act_dcf(
    target_llrs: np.ndarray,
    nontarget_llrs: np.ndarray,
    p_target: float = 0.05,
    c_miss: float = 1.0,
    c_fa: float = 1.0,
) -> Tuple[float, float]:
    """(actual, minimum) normalized detection cost at an operating point.

    ``actual`` thresholds the scores at the Bayes point for LLRs,
    ``-logit(effective prior)``; ``minimum`` sweeps all thresholds.  Their
    gap is the calibration loss at this operating point (well-calibrated
    LLRs make them match)."""
    tar = np.asarray(target_llrs, np.float64).ravel()
    non = np.asarray(nontarget_llrs, np.float64).ravel()
    if not 0.0 < p_target < 1.0:
        raise ValueError("p_target must be in (0, 1)")
    eff = p_target * c_miss / (p_target * c_miss + (1 - p_target) * c_fa)
    bayes_thr = -np.log(eff / (1.0 - eff))
    norm = min(p_target * c_miss, (1 - p_target) * c_fa)

    tar_sorted = np.sort(tar)
    non_sorted = np.sort(non)

    def dcf_at(thr: np.ndarray) -> np.ndarray:
        # vectorized over thresholds via sorted-search (a per-threshold
        # recount would make the full sweep O(N^2))
        pmiss = np.searchsorted(tar_sorted, thr, side="left") / tar.size
        pfa = 1.0 - np.searchsorted(non_sorted, thr, side="left") / non.size
        return (p_target * c_miss * pmiss + (1 - p_target) * c_fa * pfa) / norm

    actual = float(dcf_at(np.asarray([bayes_thr]))[0])
    sweep = np.concatenate([[min(tar_sorted[0], non_sorted[0]) - 1e-3],
                            np.sort(np.concatenate([tar, non]))])
    minimum = float(dcf_at(sweep).min())
    return actual, minimum
