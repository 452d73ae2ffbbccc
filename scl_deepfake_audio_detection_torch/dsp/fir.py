"""FIR design and application on the host, in numpy.

Counterpart of ``scl_deepfake_audio_detection_tpu/dsp/fir.py``.
``firwin_bandstop`` reproduces ``scipy.signal.firwin(c, [f1, f2],
window='hamming', fs=fs)``, the notch prototype that RawBoost chains
(reference ``datautils/RawBoost.py:43``).
"""

from __future__ import annotations

import numpy as np


def uniform(rng: np.random.Generator, a: float, b: float) -> float:
    """Uniform draw that accepts inverted bounds.  RawBoost's gain range
    inverts after the lin/non-lin bias shift; the reference's legacy
    ``np.random.uniform`` samples the reversed interval, where
    ``Generator.uniform`` would raise, so the bounds are ordered here."""
    lo, hi = (a, b) if a <= b else (b, a)
    return float(rng.uniform(lo, hi))


def hamming(n: int) -> np.ndarray:
    """Symmetric Hamming window (numpy/scipy convention)."""
    if n == 1:
        return np.ones(1)
    k = np.arange(n)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))


def firwin_bandstop(numtaps: int, f1: float, f2: float, fs: float) -> np.ndarray:
    """Hamming-windowed band-stop FIR with passbands [0, f1] and [f2, fs/2],
    unit gain at DC (scipy ``firwin`` with ``pass_zero=True``)."""
    if numtaps % 2 == 0:
        raise ValueError("band-stop FIR needs odd numtaps")
    nyq = fs / 2.0
    lo, hi = f1 / nyq, f2 / nyq
    m = np.arange(numtaps) - (numtaps - 1) / 2.0
    h = np.zeros(numtaps)
    for left, right in ((0.0, lo), (hi, 1.0)):  # ideal passband sincs
        h += right * np.sinc(right * m) - left * np.sinc(left * m)
    h *= hamming(numtaps)
    return h / np.sum(h)


def freq_response_max(b: np.ndarray, n: int = 512) -> float:
    """max |H(e^jw)| over the default ``scipy.signal.freqz`` grid (n points
    on [0, pi))."""
    return float(np.max(np.abs(np.fft.rfft(b, 2 * n)[:n])))


def design_notch_chain(
    rng: np.random.Generator,
    n_bands: int,
    min_f: float,
    max_f: float,
    min_bw: float,
    max_bw: float,
    min_coeff: int,
    max_coeff: int,
    min_g: float,
    max_g: float,
    fs: float,
) -> np.ndarray:
    """A chain of ``n_bands`` random notch filters with a random gain,
    peak-normalised (reference ``genNotchCoeffs``, ``RawBoost.py:28-48``):
    random centre, width and odd tap count per band, band edges clamped to
    (0, fs/2), the chain convolved together, then gain ``10^(G/20)``
    relative to the peak response."""
    b = np.ones(1)
    for _ in range(n_bands):
        fc = uniform(rng, min_f, max_f)
        bw = uniform(rng, min_bw, max_bw)
        c = int(uniform(rng, min_coeff, max_coeff))
        if c % 2 == 0:
            c += 1
        f1 = max(fc - bw / 2.0, 1.0 / 1000.0)
        f2 = min(fc + bw / 2.0, fs / 2.0 - 1.0 / 1000.0)
        b = np.convolve(firwin_bandstop(c, f1, f2, fs), b)
    g = uniform(rng, min_g, max_g)
    return (10.0 ** (g / 20.0)) * b / freq_response_max(b)


def filter_fir_centered(x: np.ndarray, b: np.ndarray) -> np.ndarray:
    """FIR with its group delay removed; the output has the input's length
    (reference ``filterFIR``, ``RawBoost.py:51-56``: pad, causal filter,
    drop N/2 at both ends, N = len(b) + 1)."""
    n = b.shape[0] + 1
    y = np.convolve(np.concatenate([x, np.zeros(n)]), b)[: x.shape[0] + n]
    return y[n // 2 : n // 2 + x.shape[0]]
