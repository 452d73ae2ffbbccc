"""Batched RawBoost on tensors: FFT convolution over whole batches of views.

Counterpart of ``scl_deepfake_audio_detection_tpu/dsp/rawboost_jax.py``.
The host path (``dsp/rawboost.py``) is the per-utterance numpy version of
the reference's DSP (``datautils/RawBoost.py``).  Here the notch chains are
still designed on the host (control flow, microseconds), and the FIR
convolutions run as batched rFFT * rFFT -> irFFT on the tensors' device:
cuFFT on the card, pocketfft on the CPU.

The random draws are a different stream from the JAX package's and from
the reference's unseeded ``np.random``: the distributions match, not the
values.  Every random function is a draw step over an explicit
``torch.Generator`` and a pure step that takes the draws as tensors
(``isd_additive_noise`` over ``isd_given``, ``ssi_additive_noise`` over
``ssi_given``, ``rawboost_batch`` over ``rawboost_batch_given``), so a test
can hand both packages the same draws.  The ISD stage keeps each sample
with an i.i.d. Bernoulli(beta) mask rather than an exact
``int(T*beta/100)``-sized subset: the same expected density at a fixed
shape.

``pack_chains`` puts chains of different lengths into one [B, n_f, NB]
tensor, each at the offset that lines its centred group delay up with the
buffer's, so ``fft_fir_centered`` equals ``fir.filter_fir_centered`` row by
row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from scl_deepfake_audio_detection_torch.dsp.fir import design_notch_chain
from scl_deepfake_audio_detection_torch.utils.config import RawBoostConfig


# ------------------------------------------------------------- host side

def design_lnl_chains(cfg: RawBoostConfig, fs: int,
                      rng: np.random.Generator) -> List[np.ndarray]:
    """The reference's per-power notch chains (``RawBoost.py:59-66``): the
    gains drop by the lin/non-lin bias from the second power on."""
    min_g, max_g = float(cfg.minG), float(cfg.maxG)
    chains = []
    for i in range(cfg.N_f):
        if i == 1:
            min_g -= cfg.minBiasLinNonLin
            max_g -= cfg.maxBiasLinNonLin
        chains.append(design_notch_chain(
            rng, cfg.nBands, cfg.minF, cfg.maxF, cfg.minBW, cfg.maxBW,
            cfg.minCoeff, cfg.maxCoeff, min_g, max_g, fs))
    return chains


def pack_chains(chains: Sequence[np.ndarray], nb: int) -> np.ndarray:
    """Variable-length taps into fixed [len(chains), nb] float64 buffers:
    chain i (length m) at offset (nb+1)//2 - (m+1)//2, so slicing at the
    buffer's delay gives ``filter_fir_centered(x, chain)``."""
    out = np.zeros((len(chains), nb), np.float64)
    for i, b in enumerate(chains):
        m = len(b)
        if m > nb:
            raise ValueError(f"chain {i} longer ({m}) than buffer ({nb})")
        off = (nb + 1) // 2 - (m + 1) // 2
        out[i, off:off + m] = b
    return out


# ----------------------------------------------------------- device side

def fft_fir_centered(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Centred FIR by FFT: x [..., T], b [..., NB] (batch dims broadcast) ->
    [..., T], equal to ``fir.filter_fir_centered`` per row.  The FFT length
    is exactly T + NB, the shortest linear convolution."""
    t, nb = x.shape[-1], b.shape[-1]
    n = t + nb
    y = torch.fft.irfft(torch.fft.rfft(x, n, dim=-1) * torch.fft.rfft(b, n, dim=-1),
                        n, dim=-1)
    d = (nb + 1) // 2
    return y[..., d:d + t]


def _cond_peak_norm(y: torch.Tensor) -> torch.Tensor:
    peak = y.abs().amax(dim=-1, keepdim=True)
    return torch.where(peak > 1.0, y / peak, y)


def _integer_pow(x: torch.Tensor, k: int) -> torch.Tensor:
    """x**k by binary exponentiation, the order of products that
    ``jax.lax.integer_pow`` uses."""
    acc = None
    while k:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k:
            x = x * x
    return acc


def lnl_convolutive_noise(wav: torch.Tensor, chains: torch.Tensor) -> torch.Tensor:
    """wav [B, T] fp32, chains [B, n_f, NB] (``pack_chains``) -> the sum over
    i of fir(wav^(i+1), chains[:, i]), de-meaned and peak-normalised where
    its peak exceeds 1."""
    n_f = chains.shape[1]
    powers = torch.stack([_integer_pow(wav, i + 1) for i in range(n_f)], dim=1)
    y = fft_fir_centered(powers.float(), chains.float()).sum(dim=1)
    y = y - y.mean(dim=-1, keepdim=True)
    return _cond_peak_norm(y).float()


@dataclass
class IsdDraws:
    """The ISD stage's draws for B rows of T samples: the threshold ``beta``
    [B, 1] (already scaled to U(0, P) percent), the mask's uniforms
    ``u_mask`` [B, T] and the two factor uniforms ``f1``, ``f2`` [B, T]."""

    beta: torch.Tensor
    u_mask: torch.Tensor
    f1: torch.Tensor
    f2: torch.Tensor


def draw_isd(b: int, t: int, p_max: float, generator: Optional[torch.Generator],
             device) -> IsdDraws:
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return IsdDraws(beta=u(b, 1) * p_max / 100.0, u_mask=u(b, t), f1=u(b, t), f2=u(b, t))


def isd_given(wav: torch.Tensor, beta: torch.Tensor, u_mask: torch.Tensor,
              f1: torch.Tensor, f2: torch.Tensor, g_sd: float) -> torch.Tensor:
    """Impulsive signal-dependent noise (``RawBoost.py:73-84``) from given
    draws: samples where ``u_mask < beta`` gain g_sd * wav * f with
    f = U(-1, 1) * U(-1, 1)."""
    f = (2 * f1 - 1) * (2 * f2 - 1)
    y = wav + torch.where(u_mask < beta, g_sd * wav * f, torch.zeros_like(wav))
    return _cond_peak_norm(y).float()


def isd_additive_noise(wav: torch.Tensor, generator: Optional[torch.Generator],
                       p_max: float, g_sd: float) -> torch.Tensor:
    d = draw_isd(wav.shape[0], wav.shape[1], p_max, generator, wav.device)
    return isd_given(wav, d.beta, d.u_mask, d.f1, d.f2, g_sd)


@dataclass
class SsiDraws:
    """The SSI stage's draws: unit Gaussian ``noise`` [B, T] and ``snr``
    [B, 1] in dB."""

    noise: torch.Tensor
    snr: torch.Tensor


def draw_ssi(b: int, t: int, snr_min: float, snr_max: float,
             generator: Optional[torch.Generator], device) -> SsiDraws:
    noise = torch.randn((b, t), generator=generator, device=device)
    snr = snr_min + (snr_max - snr_min) * torch.rand((b, 1), generator=generator,
                                                     device=device)
    return SsiDraws(noise=noise, snr=snr)


def ssi_given(wav: torch.Tensor, noise: torch.Tensor, chains: torch.Tensor,
              snr: torch.Tensor) -> torch.Tensor:
    """Stationary coloured noise at an SNR (``RawBoost.py:89-97``): the
    Gaussian through the notch chain [B, NB], peak-normalised, scaled to
    ``snr`` against the signal's norm."""
    noise = fft_fir_centered(noise.float(), chains.float())
    noise = noise / noise.abs().amax(dim=-1, keepdim=True)
    scale = (torch.linalg.vector_norm(wav, dim=-1, keepdim=True)
             / torch.linalg.vector_norm(noise, dim=-1, keepdim=True)
             / (10.0 ** (0.05 * snr)))
    return (wav + noise * scale).float()


def ssi_additive_noise(wav: torch.Tensor, generator: Optional[torch.Generator],
                       chains: torch.Tensor, snr_min: float, snr_max: float) -> torch.Tensor:
    d = draw_ssi(wav.shape[0], wav.shape[1], snr_min, snr_max, generator, wav.device)
    return ssi_given(wav, d.noise, chains, d.snr)


def rawboost_batch_given(wav: torch.Tensor, lnl_chains: torch.Tensor,
                         ssi_chains: torch.Tensor, cfg: RawBoostConfig,
                         isd: IsdDraws, ssi: SsiDraws,
                         algo: Optional[int] = None) -> torch.Tensor:
    """The reference's 8-way dispatch (``asvspoof_2019_augall_3.py:377-439``)
    from given draws; algorithms outside 1-8 return the input."""
    algo = cfg.algo if algo is None else algo

    def lnl(x):
        return lnl_convolutive_noise(x, lnl_chains)

    def isd_(x):
        return isd_given(x, isd.beta, isd.u_mask, isd.f1, isd.f2, cfg.g_sd)

    def ssi_(x):
        return ssi_given(x, ssi.noise, ssi_chains, ssi.snr)

    if algo == 1:
        return lnl(wav)
    if algo == 2:
        return isd_(wav)
    if algo == 3:
        return ssi_(wav)
    if algo == 4:
        return ssi_(isd_(lnl(wav)))
    if algo == 5:
        return isd_(lnl(wav))
    if algo == 6:
        return ssi_(lnl(wav))
    if algo == 7:
        return ssi_(isd_(wav))
    if algo == 8:  # the two in parallel, summed, then renormalised (:434-437)
        return _cond_peak_norm(lnl(wav) + isd_(wav)).float()
    return wav


def rawboost_batch(wav: torch.Tensor, generator: Optional[torch.Generator],
                   lnl_chains: torch.Tensor, ssi_chains: torch.Tensor,
                   cfg: RawBoostConfig, algo: Optional[int] = None) -> torch.Tensor:
    b, t = wav.shape
    isd = draw_isd(b, t, cfg.P, generator, wav.device)
    ssi = draw_ssi(b, t, cfg.SNRmin, cfg.SNRmax, generator, wav.device)
    return rawboost_batch_given(wav, lnl_chains, ssi_chains, cfg, isd, ssi, algo)


def make_batch_augmenter(cfg: RawBoostConfig, fs: int, batch: int, nb: int = 1024,
                         seed: int = 0, device="cuda"):
    """-> ``fn(wav [B, T], generator) -> [B, T]`` on ``device``, with fresh
    per-row chains designed on the host for every call (the reference
    designs new filters for every utterance)."""
    from scl_deepfake_audio_detection_torch.utils.device import resolve_device

    device = resolve_device(device)
    host_rng = np.random.default_rng(seed)

    def fn(wav, generator: Optional[torch.Generator]) -> torch.Tensor:
        lnl = np.stack([pack_chains(design_lnl_chains(cfg, fs, host_rng), nb)
                        for _ in range(batch)])
        ssi = np.stack([pack_chains([design_notch_chain(
            host_rng, cfg.nBands, cfg.minF, cfg.maxF, cfg.minBW, cfg.maxBW,
            cfg.minCoeff, cfg.maxCoeff, cfg.minG, cfg.maxG, fs)], nb)[0]
            for _ in range(batch)])
        to = dict(device=device, dtype=torch.float32)
        return rawboost_batch(torch.as_tensor(wav).to(**to), generator,
                              torch.as_tensor(lnl).to(**to), torch.as_tensor(ssi).to(**to),
                              cfg)

    return fn
