"""Detection metrics: the port's copy of
``scl_deepfake_audio_detection_tpu/train/metrics.py`` (reference
``evaluate_metrics.py``).  Pure numpy on the host: the DET curve and EER
(``--early_metric eer``, ``--analyze``), confusion counts, min t-DCF
against the organizers' ASV scores, and the bootstrap intervals of
``--bootstrap_ci`` and ``--compare``."""

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


def confusion_counts(
    target_scores: np.ndarray, nontarget_scores: np.ndarray, threshold: float
) -> Tuple[int, int, int, int]:
    """(tp, tn, fp, fn) at a threshold (reference ``evaluate_metrics.py:23-33``).

    A trial counts as positive (bonafide) when its score is strictly above
    the threshold.
    """
    target_scores = np.asarray(target_scores)
    nontarget_scores = np.asarray(nontarget_scores)
    tp = int(np.sum(target_scores > threshold))
    tn = int(np.sum(nontarget_scores <= threshold))
    fn = int(np.sum(target_scores <= threshold))
    fp = int(np.sum(nontarget_scores > threshold))
    return tp, tn, fp, fn


def accuracy_from_log_probs(log_probs: np.ndarray, labels: np.ndarray) -> float:
    """Fraction of argmax predictions matching labels (reference ``main.py:67``)."""
    pred = np.argmax(np.asarray(log_probs), axis=-1)
    labels = np.asarray(labels).reshape(-1)
    return float((pred == labels).mean())


# ---------------------------------------------------------------------------
# Tandem detection cost function (min t-DCF)
# ---------------------------------------------------------------------------
# The official ASVspoof headline metric alongside EER (Kinnunen et al.,
# "t-DCF: a Detection Cost Function for the Tandem Assessment of Spoofing
# Countermeasures and Automatic Speaker Verification", Odyssey 2018; revised
# form in IEEE/ACM TASLP 2020).  The reference repo reports EER only
# (``evaluate_metrics.py``); challenge rankings use min t-DCF, so users
# evaluating on ASVspoof 2019/2021 need it.  The ASV system is fixed at its
# EER operating point (the organizers' convention) and the CM threshold is
# swept.

#: ASVspoof 2019 cost model (t-DCF "legacy" v1).
TDCF_COSTS_ASVSPOOF19 = {
    "Pspoof": 0.05, "Ptar": 0.9405, "Pnon": 0.0095,
    "Cmiss_asv": 1.0, "Cfa_asv": 10.0, "Cmiss_cm": 1.0, "Cfa_cm": 10.0,
}

#: ASVspoof 2021 cost model (t-DCF "revised" v2: single Cmiss, constant C0).
TDCF_COSTS_ASVSPOOF21 = {
    "Pspoof": 0.05, "Ptar": 0.9405, "Pnon": 0.0095,
    "Cmiss": 1.0, "Cfa_asv": 10.0, "Cfa_cm": 10.0,
}


def asv_error_rates(
    tar_asv: np.ndarray,
    non_asv: np.ndarray,
    spoof_asv: np.ndarray,
    threshold: float | None = None,
) -> Tuple[float, float, float, float]:
    """ASV miss/false-alarm rates at a threshold (its EER threshold when
    None — the organizers' fixed operating point).

    Returns (Pfa_asv, Pmiss_asv, Pmiss_spoof_asv, Pfa_spoof_asv): nontarget
    accepts, target rejects, spoof rejects, spoof accepts."""
    tar_asv = np.asarray(tar_asv, np.float64)
    non_asv = np.asarray(non_asv, np.float64)
    spoof_asv = np.asarray(spoof_asv, np.float64)
    if spoof_asv.size == 0:
        # np.mean of an empty array is NaN, which would flow through the
        # cost coefficients unreported (NaN passes every <= guard)
        raise ValueError(
            "t-DCF needs spoof-trial ASV scores (Pfa_spoof_asv); the ASV "
            "score file contains none"
        )
    if threshold is None:
        _, threshold = compute_eer(tar_asv, non_asv)
    pfa = float(np.mean(non_asv >= threshold))
    pmiss = float(np.mean(tar_asv < threshold))
    pmiss_spoof = float(np.mean(spoof_asv < threshold))
    return pfa, pmiss, pmiss_spoof, 1.0 - pmiss_spoof


def tdcf_curve(
    bona_cm: np.ndarray,
    spoof_cm: np.ndarray,
    Pfa_asv: float,
    Pmiss_asv: float,
    Pfa_spoof_asv: float,
    version: str = "legacy",
    costs: dict | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Normalized t-DCF over every CM threshold -> (tdcf_norm, thresholds).

    ``version='legacy'`` is the ASVspoof 2019 form
    (t-DCF = C1*Pmiss_cm + C2*Pfa_cm, normalized by min(C1, C2));
    ``'revised'`` the 2021 form with the constant floor C0
    (t-DCF = C0 + C1*Pmiss_cm + C2*Pfa_cm over C0 + min(C1, C2))."""
    if version == "legacy":
        c = dict(TDCF_COSTS_ASVSPOOF19, **(costs or {}))
        c0 = 0.0
        c1 = (
            c["Ptar"] * (c["Cmiss_cm"] - c["Cmiss_asv"] * Pmiss_asv)
            - c["Pnon"] * c["Cfa_asv"] * Pfa_asv
        )
        c2 = c["Cfa_cm"] * c["Pspoof"] * Pfa_spoof_asv
    elif version == "revised":
        c = dict(TDCF_COSTS_ASVSPOOF21, **(costs or {}))
        c0 = (
            c["Ptar"] * c["Cmiss"] * Pmiss_asv
            + c["Pnon"] * c["Cfa_asv"] * Pfa_asv
        )
        c1 = c["Ptar"] * c["Cmiss"] - c0
        c2 = c["Cfa_cm"] * c["Pspoof"] * Pfa_spoof_asv
    else:
        raise ValueError(f"unknown t-DCF version: {version!r}")
    if c1 <= 0 or c2 <= 0:
        raise ValueError(
            "non-positive t-DCF cost coefficients: the ASV system performs "
            f"at or worse than chance at its operating point "
            f"(C1={c1:.4g}, C2={c2:.4g})"
        )
    # Pmiss_cm = FRR(bonafide rejected), Pfa_cm = FAR(spoof accepted) over
    # the same operating points as the DET curve
    pmiss_cm, pfa_cm, thresholds = det_curve(bona_cm, spoof_cm)
    tdcf = c0 + c1 * pmiss_cm + c2 * pfa_cm
    return tdcf / (c0 + min(c1, c2)), thresholds


def min_tdcf(
    bona_cm: np.ndarray,
    spoof_cm: np.ndarray,
    tar_asv: np.ndarray,
    non_asv: np.ndarray,
    spoof_asv: np.ndarray,
    version: str = "legacy",
    costs: dict | None = None,
    asv_threshold: float | None = None,
) -> Tuple[float, float]:
    """Minimum normalized t-DCF and the CM threshold achieving it, with the
    ASV system fixed at ``asv_threshold`` (its EER point when None)."""
    pfa, pmiss, _, pfa_spoof = asv_error_rates(
        tar_asv, non_asv, spoof_asv, asv_threshold
    )
    curve, thresholds = tdcf_curve(
        bona_cm, spoof_cm, pfa, pmiss, pfa_spoof, version=version, costs=costs
    )
    idx = int(np.argmin(curve))
    return float(curve[idx]), float(thresholds[idx])


def eer_bootstrap_ci(
    target_scores: np.ndarray,
    nontarget_scores: np.ndarray,
    n_boot: int = 1000,
    alpha: float = 0.05,
    seed: int = 0,
) -> Tuple[float, float]:
    """Percentile bootstrap (1-alpha) confidence interval on the EER.

    Trials resample with replacement independently within the bonafide and
    spoof pools (the standard nonparametric recipe for detection metrics,
    e.g. the ASVspoof/NIST SRE analysis tooling); the point estimate itself
    is ``compute_eer``.  Not in the reference (``evaluate_metrics.py`` has
    point estimates only), but EER differences between systems are routinely
    judged against exactly this interval.
    """
    tar = np.asarray(target_scores, np.float64).ravel()
    non = np.asarray(nontarget_scores, np.float64).ravel()
    if n_boot < 2:
        raise ValueError("n_boot must be >= 2")
    rng = np.random.default_rng(seed)
    eers = np.empty(n_boot)
    for i in range(n_boot):
        t = tar[rng.integers(0, tar.size, tar.size)]
        n = non[rng.integers(0, non.size, non.size)]
        eers[i], _ = compute_eer(t, n)
    lo, hi = np.quantile(eers, [alpha / 2.0, 1.0 - alpha / 2.0])
    return float(lo), float(hi)


def eer_diff_bootstrap(
    tar_a: np.ndarray,
    non_a: np.ndarray,
    tar_b: np.ndarray,
    non_b: np.ndarray,
    n_boot: int = 1000,
    alpha: float = 0.05,
    seed: int = 0,
) -> Tuple[float, float, float, float]:
    """PAIRED bootstrap comparison of two systems scored on the SAME trials.

    Resamples trial indices once per replicate and applies them to both
    systems (the correct treatment for correlated scores on identical
    audio); an unpaired comparison wildly overstates the uncertainty of the
    difference.  Inputs must be trial-aligned: ``tar_a[i]`` and ``tar_b[i]``
    score the same utterance.

    Returns (delta, lo, hi, p): the point EER difference A - B, its
    percentile (1 - alpha) interval, and the two-sided bootstrap p-value of
    delta != 0 (fraction of replicates crossing zero, doubled and clipped).
    """
    tar_a, tar_b = (np.asarray(x, np.float64).ravel() for x in (tar_a, tar_b))
    non_a, non_b = (np.asarray(x, np.float64).ravel() for x in (non_a, non_b))
    if tar_a.shape != tar_b.shape or non_a.shape != non_b.shape:
        raise ValueError("paired comparison needs trial-aligned score arrays")
    if n_boot < 2:
        raise ValueError("n_boot must be >= 2")
    eer_a, _ = compute_eer(tar_a, non_a)
    eer_b, _ = compute_eer(tar_b, non_b)
    delta = eer_a - eer_b
    rng = np.random.default_rng(seed)
    diffs = np.empty(n_boot)
    for i in range(n_boot):
        ti = rng.integers(0, tar_a.size, tar_a.size)
        ni = rng.integers(0, non_a.size, non_a.size)
        ea, _ = compute_eer(tar_a[ti], non_a[ni])
        eb, _ = compute_eer(tar_b[ti], non_b[ni])
        diffs[i] = ea - eb
    lo, hi = np.quantile(diffs, [alpha / 2.0, 1.0 - alpha / 2.0])
    # two-sided sign test on the bootstrap distribution
    p = 2.0 * min(np.mean(diffs >= 0.0), np.mean(diffs <= 0.0))
    return float(delta), float(lo), float(hi), float(min(p, 1.0))
