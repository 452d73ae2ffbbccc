"""Waveform morphing between two signals.

Counterpart of ``scl_deepfake_audio_detection_tpu/dsp/morph.py``, host scipy
copied as it is (the reference's ``morph_wavform``,
``core_scripts/data_io/wav_augmentation.py:462-565``): four morph methods,
waveform mix, spectral-amplitude morph, phase morph, and both.  The STFT
framing is the reference's (fl=320, fs=160, nfft=1024).

The reference's quirks are kept, as the JAX package keeps them (they are
what the trained models saw):
- amplitude morphing is *geometric*: ``amp1**p * amp2**(1-p)`` (:518);
- method 2 keeps the phase of **wav1** (its docstring says wav2; the code
  uses ``pha1``, :524);
- methods 3 and 4 build ``amp*cos(pha1) + 1j*amp*sin(pha_morphed)``: the
  real part takes the un-morphed phase (:542, :559).  Kept, not fixed
  (``ROADMAP.md`` section 3 records it as the JAX package's behaviour).
"""

from __future__ import annotations

import numpy as np
from scipy import signal


def _trim_pair(wav1: np.ndarray, wav2: np.ndarray):
    length = min(wav1.shape[0], wav2.shape[0])
    d1 = wav1[:length, 0] if wav1.ndim > 1 else wav1[:length]
    d2 = wav2[:length, 0] if wav2.ndim > 1 else wav2[:length]
    return d1, d2


def _match(data: np.ndarray, like: np.ndarray) -> np.ndarray:
    out = np.zeros(like.shape[0], dtype=np.float32)
    n = min(len(data), len(out))
    out[:n] = data[:n]
    return out.reshape(like.shape) if like.ndim > 1 else out


def morph_waveform(
    wav1: np.ndarray,
    wav2: np.ndarray,
    para: float = 0.5,
    method=2,
    fl: int = 320,
    fs: int = 160,
    nfft: int = 1024,
) -> np.ndarray:
    """Morph wav1 toward wav2 with coefficient ``para`` (1.0 = pure wav1)."""
    d1, d2 = _trim_pair(wav1, wav2)

    if method in (1, "wav"):
        data = d1 * para + d2 * (1.0 - para)
    else:
        _, _, z1 = signal.stft(d1, nperseg=fl, noverlap=fl - fs, nfft=nfft)
        _, _, z2 = signal.stft(d2, nperseg=fl, noverlap=fl - fs, nfft=nfft)
        amp1, amp2 = np.abs(z1), np.abs(z2)
        if method in (2, "specamp"):
            pha1 = np.angle(z1)
            amp = np.power(amp1, para) * np.power(amp2, 1.0 - para)
            z = amp * np.cos(pha1) + 1j * amp * np.sin(pha1)
        elif method in (3, "phase"):
            pha1 = np.unwrap(np.angle(z1))
            pha2 = np.unwrap(np.angle(z2))
            pha = pha1 * para + pha2 * (1.0 - para)
            z = amp1 * np.cos(pha1) + 1j * amp1 * np.sin(pha)
        elif method in (4, "specamp-phase"):
            pha1 = np.unwrap(np.angle(z1))
            pha2 = np.unwrap(np.angle(z2))
            amp = np.power(amp1, para) * np.power(amp2, 1.0 - para)
            pha = pha1 * para + pha2 * (1.0 - para)
            z = amp * np.cos(pha1) + 1j * amp * np.sin(pha)
        else:
            raise ValueError(f"unknown morph method: {method!r}")
        _, data = signal.istft(z, nperseg=fl, noverlap=fl - fs, nfft=nfft)

    return _match(data, wav1)
