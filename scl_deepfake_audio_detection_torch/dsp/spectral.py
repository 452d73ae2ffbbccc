"""Spectral analysis tools: mel spectrogram, Griffin-Lim, LPC, frequency
warping.

Counterpart of ``scl_deepfake_audio_detection_tpu/dsp/spectral.py`` (the
vendored NII DSP extras, ``core_scripts/data_io/dsp_tools.py``: ``Melspec``
:26, ``LPClite`` :176, ``GriffinLim`` :761, frequency warping :853+).

- ``stft_mag``, ``melspec`` and ``warp_frequency`` are tensor functions
  that run on the input's device (``torch.fft.rfft``, one batched matmul
  against the filterbank).  The framing is the JAX package's: reflect
  padding of ``n_fft // 2``, a frame index matrix, ``np.hanning`` (the
  symmetric Hann window; ``torch.stft``'s default is the periodic one);
- the mel scale and filterbank, Griffin-Lim and the three LPC functions
  are host numpy / scipy, copied as they are.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=16)
def mel_filterbank(
    sr: int = 16000, n_fft: int = 1024, n_mels: int = 80,
    fmin: float = 0.0, fmax: Optional[float] = None,
) -> np.ndarray:
    """Triangular HTK-style mel filterbank [n_mels, n_fft//2 + 1]."""
    fmax = fmax if fmax is not None else sr / 2
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * hz / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for m in range(1, n_mels + 1):
        lo, ce, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, ce):
            fb[m - 1, k] = (k - lo) / max(ce - lo, 1)
        for k in range(ce, hi):
            fb[m - 1, k] = (hi - k) / max(hi - ce, 1)
    return fb


def stft_mag(
    wav: torch.Tensor, n_fft: int = 1024, hop: int = 256,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[..., T] -> magnitude [..., frames, n_fft//2+1], on wav's device.
    Centred (reflect-padded) framing; ``np.hanning`` by default."""
    if window is None:
        window = torch.from_numpy(np.hanning(n_fft).astype(np.float32))
    pad = n_fft // 2
    x = F.pad(wav.reshape(-1, wav.shape[-1]), (pad, pad), mode="reflect")
    x = x.reshape(*wav.shape[:-1], x.shape[-1])
    n_frames = 1 + (x.shape[-1] - n_fft) // hop
    idx = torch.from_numpy(np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :])
    frames = x[..., idx.to(x.device)] * window.to(x.device)
    return torch.fft.rfft(frames, dim=-1).abs()


def melspec(
    wav: torch.Tensor, sr: int = 16000, n_fft: int = 1024, hop: int = 256,
    n_mels: int = 80, log: bool = True, eps: float = 1e-10,
) -> torch.Tensor:
    """[..., T] -> (log-)mel spectrogram [..., frames, n_mels], on wav's
    device."""
    mag = stft_mag(wav, n_fft, hop)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(mag.device)
    mel = torch.matmul(mag**2, fb.t())
    return torch.log(mel + eps) if log else mel


def griffin_lim(
    mag: np.ndarray, n_fft: int = 1024, hop: int = 256, n_iter: int = 32,
    length: Optional[int] = None, seed: int = 0,
) -> np.ndarray:
    """Phase reconstruction from a magnitude spectrogram [frames, bins]
    (classic Griffin-Lim; dsp_tools.GriffinLim equivalent). scipy i/stft."""
    from scipy import signal

    mag = np.asarray(mag, np.float64).T  # scipy uses [bins, frames]
    rng = np.random.default_rng(seed)
    phase = np.exp(2j * np.pi * rng.random(mag.shape))
    win = "hann"
    for _ in range(n_iter):
        _, x = signal.istft(mag * phase, nperseg=n_fft, noverlap=n_fft - hop,
                            window=win)
        _, _, z = signal.stft(x, nperseg=n_fft, noverlap=n_fft - hop, window=win)
        z = z[:, : mag.shape[1]]
        phase = np.exp(1j * np.angle(np.pad(z, ((0, 0), (0, mag.shape[1] - z.shape[1])))))
    _, x = signal.istft(mag * phase, nperseg=n_fft, noverlap=n_fft - hop, window=win)
    if length is not None:
        x = x[:length] if len(x) >= length else np.pad(x, (0, length - len(x)))
    return x.astype(np.float32)


def lpc_analysis(frames: np.ndarray, order: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Frame-wise LPC via autocorrelation + Levinson-Durbin
    (dsp_tools.LPClite equivalent).

    frames: [n_frames, frame_len] (pre-windowed) -> (coeffs [n, order+1] with
    a[0]=1, gain [n]).
    """
    n, fl = frames.shape
    # autocorrelation r[0..order]
    spec = np.fft.rfft(frames, 2 * fl, axis=1)
    r = np.fft.irfft(np.abs(spec) ** 2, axis=1)[:, : order + 1]
    a = np.zeros((n, order + 1))
    a[:, 0] = 1.0
    err = r[:, 0].copy() + 1e-12
    for i in range(1, order + 1):
        acc = np.sum(a[:, 1:i] * r[:, i - 1:0:-1], axis=1) if i > 1 else 0.0
        k = -(r[:, i] + acc) / err
        a_new = a.copy()
        a_new[:, i] = k
        if i > 1:
            a_new[:, 1:i] = a[:, 1:i] + k[:, None] * a[:, i - 1:0:-1]
        a = a_new
        err = err * (1.0 - k**2)
    return a.astype(np.float32), np.sqrt(np.maximum(err, 0)).astype(np.float32)


def lpc_residual(frames: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Inverse-filter frames with their LPC coefficients -> excitation."""
    from scipy import signal

    out = np.empty_like(frames, dtype=np.float32)
    for i in range(frames.shape[0]):
        out[i] = signal.lfilter(coeffs[i], [1.0], frames[i]).astype(np.float32)
    return out


def lpc_synthesis(residual: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """All-pole resynthesis from excitation + coefficients."""
    from scipy import signal

    out = np.empty_like(residual, dtype=np.float32)
    for i in range(residual.shape[0]):
        out[i] = signal.lfilter([1.0], coeffs[i], residual[i]).astype(np.float32)
    return out


def warp_frequency(
    mag: torch.Tensor, alpha: float, n_bins: Optional[int] = None
) -> torch.Tensor:
    """Bilinear frequency warping of a magnitude spectrogram [..., bins]
    (VTLP-style; ``dsp_tools`` :853+), on mag's device.  alpha > 0
    stretches the low frequencies."""
    bins = mag.shape[-1] if n_bins is None else n_bins
    w = np.linspace(0, np.pi, bins)
    warped = w + 2.0 * np.arctan2(alpha * np.sin(w), 1.0 - alpha * np.cos(w))
    src = np.clip(warped / np.pi * (bins - 1), 0, bins - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, bins - 1)
    frac = torch.from_numpy((src - lo).astype(np.float32)).to(mag.device)
    lo, hi = (torch.from_numpy(i).to(mag.device) for i in (lo, hi))
    return mag[..., lo] * (1 - frac) + mag[..., hi] * frac
