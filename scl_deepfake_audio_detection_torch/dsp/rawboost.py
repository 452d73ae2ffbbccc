"""RawBoost waveform augmentation (Tak et al., ICASSP 2022), on the host.

Counterpart of ``scl_deepfake_audio_detection_tpu/dsp/rawboost.py``: the
algorithms of the reference ``datautils/RawBoost.py`` and the 8-way dispatch
of its dataset modules (``asvspoof_2019_augall_3.py:377-439``):

  1  LnL convolutive noise   (notch FIR chains over the signal's powers)
  2  ISD impulsive noise     (signal-dependent noise on a random sample subset)
  3  SSI additive noise      (notch-coloured Gaussian noise at a random SNR)
  4=1+2+3  5=1+2  6=1+3  7=2+3  8=1||2 (in parallel, renormalised)

Draws come from an explicit ``np.random.Generator`` in the JAX package's
order, so both give the same output for one seed.  LnL runs the native FIR
chain (``native.lnl_apply``) where the host library builds, as the JAX
package does, and its numpy loop elsewhere.
"""

from __future__ import annotations

import numpy as np

from scl_deepfake_audio_detection_torch import native
from scl_deepfake_audio_detection_torch.dsp.fir import design_notch_chain, filter_fir_centered
from scl_deepfake_audio_detection_torch.utils.config import RawBoostConfig


def norm_wav(x: np.ndarray, always: bool = False) -> np.ndarray:
    """Peak-normalise; unless ``always``, only when |x| exceeds 1
    (reference ``RawBoost.py:20-25``)."""
    peak = np.max(np.abs(x)) if x.size else 0.0
    if always or peak > 1.0:
        return x / peak
    return x


def lnl_convolutive_noise(x: np.ndarray, cfg: RawBoostConfig, fs: int,
                          rng: np.random.Generator) -> np.ndarray:
    """Linear and non-linear convolutive noise (reference
    ``RawBoost.py:59-69``): each power x^i goes through its own random notch
    chain; from the second power on, the gain range is lowered by the
    lin/non-lin bias."""
    min_g, max_g = float(cfg.minG), float(cfg.maxG)
    chains = []
    for i in range(cfg.N_f):
        if i == 1:
            min_g -= cfg.minBiasLinNonLin
            max_g -= cfg.maxBiasLinNonLin
        chains.append(design_notch_chain(
            rng, cfg.nBands, cfg.minF, cfg.maxF, cfg.minBW, cfg.maxBW,
            cfg.minCoeff, cfg.maxCoeff, min_g, max_g, fs))
    if native.available():  # the fused power and FIR chain loop
        return native.lnl_apply(x.astype(np.float32), chains)
    y = np.zeros_like(x, dtype=np.float64)
    for i, b in enumerate(chains):
        y = y + filter_fir_centered(np.power(x, i + 1), b)
    y = y - np.mean(y)
    return norm_wav(y, always=False).astype(np.float32)


def isd_additive_noise(x: np.ndarray, cfg: RawBoostConfig,
                       rng: np.random.Generator) -> np.ndarray:
    """Impulsive signal-dependent noise (reference ``RawBoost.py:73-84``): a
    random ``beta`` % of the samples get g_sd * x * f, f the product of two
    uniform(-1, 1) draws."""
    beta = rng.uniform(0, cfg.P)
    n = int(x.shape[0] * beta / 100.0)
    pos = rng.permutation(x.shape[0])[:n]
    f = (2 * rng.random(n) - 1) * (2 * rng.random(n) - 1)
    y = x.astype(np.float64).copy()
    y[pos] = x[pos] + cfg.g_sd * x[pos] * f
    return norm_wav(y, always=False).astype(np.float32)


def ssi_additive_noise(x: np.ndarray, cfg: RawBoostConfig, fs: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Stationary signal-independent coloured noise at a random SNR
    (reference ``RawBoost.py:89-97``)."""
    noise = rng.normal(0.0, 1.0, x.shape[0])
    b = design_notch_chain(
        rng, cfg.nBands, cfg.minF, cfg.maxF, cfg.minBW, cfg.maxBW,
        cfg.minCoeff, cfg.maxCoeff, cfg.minG, cfg.maxG, fs)
    noise = norm_wav(filter_fir_centered(noise, b), always=True)
    snr = rng.uniform(cfg.SNRmin, cfg.SNRmax)
    noise = noise / np.linalg.norm(noise) * np.linalg.norm(x) / (10.0 ** (0.05 * snr))
    return (x + noise).astype(np.float32)


def process_rawboost(x: np.ndarray, fs: int, cfg: RawBoostConfig,
                     rng: np.random.Generator, algo: int | None = None) -> np.ndarray:
    """The 8-way dispatch; ``algo`` defaults to ``cfg.algo``, and any other
    value returns x unchanged."""
    algo = cfg.algo if algo is None else algo
    if algo == 1:
        return lnl_convolutive_noise(x, cfg, fs, rng)
    if algo == 2:
        return isd_additive_noise(x, cfg, rng)
    if algo == 3:
        return ssi_additive_noise(x, cfg, fs, rng)
    if algo == 4:
        x = lnl_convolutive_noise(x, cfg, fs, rng)
        x = isd_additive_noise(x, cfg, rng)
        return ssi_additive_noise(x, cfg, fs, rng)
    if algo == 5:  # "RawBoost12", the configs' choice
        x = lnl_convolutive_noise(x, cfg, fs, rng)
        return isd_additive_noise(x, cfg, rng)
    if algo == 6:
        x = lnl_convolutive_noise(x, cfg, fs, rng)
        return ssi_additive_noise(x, cfg, fs, rng)
    if algo == 7:
        x = isd_additive_noise(x, cfg, rng)
        return ssi_additive_noise(x, cfg, fs, rng)
    if algo == 8:
        a = lnl_convolutive_noise(x, cfg, fs, rng)
        b = isd_additive_noise(x, cfg, rng)
        return norm_wav((a + b).astype(np.float64), always=False).astype(np.float32)
    return x
