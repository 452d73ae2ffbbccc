"""Statistics utilities: streaming moments and multiple-comparison tests.

Counterpart of ``scl_deepfake_audio_detection_tpu/utils/stats.py`` (numpy
only, the same code).

Capability match for the vendored NII math tools
(``core_scripts/math_tools/stats.py:42-310``: online mean/std/cov over
batches, used for dataset normalization statistics; and
``core_scripts/math_tools/sig_test.py``: Bonferroni/Holm corrected
significance testing for comparing systems).

The accumulator uses Chan et al.'s parallel-merge form, so per-batch
updates are exact regardless of batch sizes (same guarantee the NII
implementation provides for its welford-style updates).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class OnlineStats:
    """Streaming per-dimension mean/variance (and optional covariance) over
    batches of shape [n, dim]."""

    def __init__(self, dim: int, track_cov: bool = False):
        self.dim = dim
        self.count = 0
        self.mean = np.zeros(dim, np.float64)
        self.m2 = np.zeros(dim, np.float64)
        self.cov_m2 = np.zeros((dim, dim), np.float64) if track_cov else None

    def update(self, batch: np.ndarray) -> None:
        batch = np.atleast_2d(np.asarray(batch, np.float64))
        n = batch.shape[0]
        if n == 0:
            return
        b_mean = batch.mean(axis=0)
        delta = b_mean - self.mean
        tot = self.count + n
        self.mean += delta * (n / tot)
        b_m2 = ((batch - b_mean) ** 2).sum(axis=0)
        self.m2 += b_m2 + delta**2 * (self.count * n / tot)
        if self.cov_m2 is not None:
            centered = batch - b_mean
            self.cov_m2 += centered.T @ centered
            self.cov_m2 += np.outer(delta, delta) * (self.count * n / tot)
        self.count = tot

    @property
    def var(self) -> np.ndarray:
        return self.m2 / max(self.count - 1, 1)

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(np.maximum(self.var, 0))

    @property
    def cov(self) -> Optional[np.ndarray]:
        if self.cov_m2 is None:
            return None
        return self.cov_m2 / max(self.count - 1, 1)

    def state_dict(self) -> dict:
        return {
            "count": self.count, "mean": self.mean, "m2": self.m2,
            **({"cov_m2": self.cov_m2} if self.cov_m2 is not None else {}),
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "OnlineStats":
        o = cls(len(np.asarray(d["mean"])), track_cov="cov_m2" in d)
        o.count = int(d["count"])
        o.mean = np.asarray(d["mean"], np.float64).copy()
        o.m2 = np.asarray(d["m2"], np.float64).copy()
        if o.cov_m2 is not None:
            o.cov_m2 = np.asarray(d["cov_m2"], np.float64).copy()
        return o


# ---------------------------------------------------------------------------
# paired significance tests with multiple-comparison correction
# ---------------------------------------------------------------------------


def _t_sf(t: float, df: float) -> float:
    """Two-sided survival p-value of Student's t via the regularized
    incomplete beta (scipy when present, else a normal approximation)."""
    try:
        from scipy import stats as ss

        return float(2 * ss.t.sf(abs(t), df))
    except ImportError:  # pragma: no cover
        from math import erfc, sqrt

        return float(erfc(abs(t) / sqrt(2)))


def paired_t_pvalue(a: Sequence[float], b: Sequence[float]) -> float:
    """Two-sided paired t-test p-value between per-trial scores of two
    systems."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = a - b
    n = len(d)
    sd = d.std(ddof=1)
    if sd == 0:
        return 1.0 if d.mean() == 0 else 0.0
    t = d.mean() / (sd / np.sqrt(n))
    return _t_sf(t, n - 1)


def bonferroni(pvalues: Sequence[float], alpha: float = 0.05) -> List[bool]:
    """Reject decisions under the Bonferroni correction."""
    m = len(pvalues)
    return [p <= alpha / m for p in pvalues]


def rank_norm(data: Sequence[float], data_range: Sequence[int]) -> List[float]:
    """Rank-normalize MOS-style integer scores (Rosenberg & Ramabhadran,
    Interspeech 2017): each possible score value maps to
    (mean rank of its occurrences - 1) / N, with unseen values mapping to
    -1 (reference ``core_scripts/math_tools/mos_norm.py:29-85``).

    >>> rank_norm([2, 1, 2, 10, 4, 5, 6, 4, 5, 7], [1, 10])[:4]
    [0.15, 0.0, 0.15, 0.9]
    """
    data = np.asarray(data)
    lo, hi = int(data_range[0]), int(data_range[1])
    bad = data[(data < lo) | (data > hi)]
    if bad.size:
        raise ValueError(
            f"rank_norm: {bad.size} score(s) outside data_range "
            f"[{lo}, {hi}], e.g. {bad[0]!r}"
        )
    order = np.sort(data, kind="quicksort")
    ranks = np.arange(len(order)) + 1
    mapping = {}
    for score in range(lo, hi + 1):
        idx = ranks[order == score]
        mapping[score] = (float(np.mean(idx)) - 1) / len(data) if len(idx) else -1
    return [mapping[x] for x in data]


def holm(pvalues: Sequence[float], alpha: float = 0.05) -> List[bool]:
    """Holm-Bonferroni step-down procedure (uniformly more powerful than
    plain Bonferroni at the same family-wise error rate)."""
    m = len(pvalues)
    order = np.argsort(pvalues)
    reject = [False] * m
    for rank, idx in enumerate(order):
        if pvalues[idx] <= alpha / (m - rank):
            reject[idx] = True
        else:
            break
    return reject
