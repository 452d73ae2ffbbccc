"""Waveform augmentors: MUSAN noise, RIR reverb, pitch, speed, volume,
Gaussian noise, time and frequency masking.

Counterpart of ``scl_deepfake_audio_detection_tpu/dsp/augment.py``, the
reference's ``datautils/audio_augmentor/`` without pydub, librosa or ffmpeg.
Each augmentor is a function of (waveform, ``np.random.Generator``,
resources); caching and the YAML names live in ``data/augment_registry``.

It keeps the reference quirks that shape the training distribution:
- the online augmentors return samples at **int16 amplitude** (±32768),
  the scale of the pydub round trip (``audio_augmentor/utils.py:20-23``);
- background noise scales the *signal* by the gain ``SNR_dB * noise_dBFS /
  signal_dBFS`` (``background_noise.py:45-56``), not a textbook SNR mix;
- reverb peak-normalises after the full convolution (``reverb.py:33-46``);
- the Gaussian augmentor's shape error (``gaussian.py:39``) is fixed, with
  the same intent.
"""

from __future__ import annotations

import numpy as np

from scl_deepfake_audio_detection_torch.dsp.vad import frame_signal  # noqa: F401  (re-export)
from scl_deepfake_audio_detection_torch.utils.audio_io import resample


def _to_int16(x: np.ndarray) -> np.ndarray:
    """librosa_to_pydub: float [-1, 1] -> int16 sample values."""
    return (np.asarray(x, np.float64) * (1 << 15)).astype(np.int16)


def _dbfs(samples_i16: np.ndarray) -> float:
    """pydub ``AudioSegment.dBFS``: RMS relative to int16 full scale."""
    rms = np.sqrt(np.mean(samples_i16.astype(np.float64) ** 2))
    if rms == 0:
        return -np.inf
    return 20.0 * np.log10(rms / (1 << 15))


def background_noise(x: np.ndarray, noise: np.ndarray, rng: np.random.Generator,
                     min_snr_db: int = 5, max_snr_db: int = 15) -> np.ndarray:
    """MUSAN-style noise overlay (reference ``background_noise.py:40-56``),
    int16-scale float32.  ``noise`` is overlaid once, cut to the signal's
    length (pydub ``overlay``, no looping)."""
    sig = _to_int16(x)
    nse = _to_int16(noise)
    snr_db = rng.integers(min_snr_db, max_snr_db + 1)
    gain_db = snr_db * _dbfs(nse) / _dbfs(sig)
    scaled = sig.astype(np.float64) * (10.0 ** (gain_db / 20.0))
    out = scaled.copy()
    n = min(len(out), len(nse))
    out[:n] += nse[:n].astype(np.float64)
    return np.clip(out, -(1 << 15), (1 << 15) - 1).astype(np.float32)


def reverb(x: np.ndarray, rir: np.ndarray) -> np.ndarray:
    """RIR convolution, peak-normalised (reference ``reverb.py:33-46``),
    int16-scale float32; by FFT, where the reference's ``np.convolve`` is
    O(T L)."""
    n = len(x) + len(rir) - 1
    nfft = 1 << (n - 1).bit_length()
    y = np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(rir, nfft), nfft)[:n]
    y = y / np.max(np.abs(y))
    return _to_int16(y).astype(np.float32)


def volume(x: np.ndarray, rng: np.random.Generator, min_db: float = -10.0,
           max_db: float = 10.0) -> np.ndarray:
    """Random gain in dB (reference ``volume.py``), int16-scale."""
    gain = rng.uniform(min_db, max_db)
    out = _to_int16(x).astype(np.float64) * (10.0 ** (gain / 20.0))
    return np.clip(out, -(1 << 15), (1 << 15) - 1).astype(np.float32)


def gaussian_noise(x: np.ndarray, rng: np.random.Generator, min_amplitude: float = 0.001,
                   max_amplitude: float = 0.015) -> np.ndarray:
    """Additive white noise at a random amplitude (reference ``gaussian.py``),
    int16-scale."""
    amp = rng.uniform(min_amplitude, max_amplitude)
    y = x + amp * rng.standard_normal(x.shape[0]).astype(np.float32)
    return _to_int16(y).astype(np.float32)


# --- time scale and pitch (phase vocoder) ------------------------------------


def _stft(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    pad = n_fft // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    frames = frame_signal(xp, n_fft, hop)
    win = np.hanning(n_fft)
    return np.fft.rfft(frames * win, axis=1)


def _istft(spec: np.ndarray, n_fft: int, hop: int, length: int) -> np.ndarray:
    win = np.hanning(n_fft)
    frames = np.fft.irfft(spec, n_fft, axis=1) * win
    out = np.zeros(spec.shape[0] * hop + n_fft)
    env = np.zeros_like(out)
    for i, fr in enumerate(frames):
        out[i * hop : i * hop + n_fft] += fr
        env[i * hop : i * hop + n_fft] += win**2
    env[env < 1e-8] = 1.0
    out = out / env
    pad = n_fft // 2
    return out[pad : pad + length]


def time_stretch(x: np.ndarray, rate: float, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    """Phase-vocoder time stretch (tempo without pitch), in place of pydub's
    ``speedup`` (``speed.py:30-33``)."""
    spec = _stft(x, n_fft, hop)
    steps = np.arange(0, spec.shape[0], rate)
    phase = np.angle(spec[0])
    out = np.zeros((len(steps), spec.shape[1]), dtype=complex)
    expected = 2.0 * np.pi * hop * np.arange(spec.shape[1]) / n_fft
    for i, step in enumerate(steps):
        lo = int(np.floor(step))
        hi = min(lo + 1, spec.shape[0] - 1)
        frac = step - lo
        mag = (1 - frac) * np.abs(spec[lo]) + frac * np.abs(spec[hi])
        out[i] = mag * np.exp(1j * phase)
        dphi = np.angle(spec[hi]) - np.angle(spec[lo]) - expected
        dphi -= 2.0 * np.pi * np.round(dphi / (2.0 * np.pi))
        phase = phase + expected + dphi
    length = int(round(len(x) / rate))
    return _istft(out, n_fft, hop, length).astype(np.float32)


def speed(x: np.ndarray, rng: np.random.Generator, min_factor: float = 0.9,
          max_factor: float = 1.1) -> np.ndarray:
    """Random tempo change (reference ``speed.py``), int16-scale."""
    factor = rng.uniform(min_factor, max_factor)
    return _to_int16(time_stretch(x, factor)).astype(np.float32)


def pitch_shift(x: np.ndarray, rng: np.random.Generator, sr: int = 16000,
                min_semitones: int = -1, max_semitones: int = 1) -> np.ndarray:
    """Random semitone pitch shift (reference ``pitch.py:33-38``): librosa's
    recipe, a stretch at ``rate`` then a resample sr/rate -> sr, which keeps
    the duration.  int16-scale."""
    steps = int(rng.integers(min_semitones, max_semitones + 1))
    if steps == 0:
        return _to_int16(x).astype(np.float32)
    rate = 2.0 ** (-steps / 12.0)
    stretched = time_stretch(x, rate)
    shifted = resample(stretched, int(round(sr / rate)), sr)
    shifted = shifted[: len(x)]
    if len(shifted) < len(x):
        shifted = np.pad(shifted, (0, len(x) - len(shifted)))
    return _to_int16(shifted).astype(np.float32)


# --- masking (reference ``wav_augmentation.py:143-166,291-361``) -------------


def time_mask(x: np.ndarray, rng: np.random.Generator, sr: int = 16000) -> np.ndarray:
    """Zero a random segment of up to 0.2 s."""
    width = int(rng.random() * 0.2 * sr)
    start = max(int(rng.random() * (x.shape[0] - width)), 0)
    out = x.copy()
    out[start : start + width] = 0
    return out


def freq_mask(x: np.ndarray, rng: np.random.Generator, max_band_hz: float = 800.0,
              sr: int = 16000) -> np.ndarray:
    """Zero a random frequency band through an STFT round trip."""
    n_fft, hop = 1024, 256
    spec = _stft(x, n_fft, hop)
    n_bins = spec.shape[1]
    width = int(rng.random() * max_band_hz / (sr / 2) * n_bins)
    start = int(rng.random() * max(n_bins - width, 1))
    spec[:, start : start + width] = 0
    return _istft(spec, n_fft, hop, len(x)).astype(np.float32)
