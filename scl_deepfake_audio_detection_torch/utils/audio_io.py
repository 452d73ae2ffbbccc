"""WAV audio IO with the stdlib ``wave`` module and numpy.

Loads return mono float32 in [-1, 1] at the requested rate (librosa's
convention, which the reference uses).  FLAC and the other compressed
formats are not read yet.
"""

from __future__ import annotations

import math
import os
import wave
from typing import Tuple

import numpy as np


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (scipy)."""
    if sr_in == sr_out:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def load_audio(path: str, sr: int = 16000) -> np.ndarray:
    """Mono float32 at ``sr`` from a PCM WAV file."""
    ext = os.path.splitext(path)[1].lower()
    if ext != ".wav":
        raise RuntimeError(f"cannot decode {ext!r}: only WAV is read yet: {path}")
    data, file_sr = _read_wav(path)
    return resample(data, file_sr, sr)


def pcm16_encode(x: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> int16 PCM: the wire and file quantisation.  Lossless
    round trip for audio decoded from 16-bit sources."""
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def save_wav(path: str, x: np.ndarray, sr: int = 16000) -> None:
    """Mono PCM16 WAV writer."""
    pcm = pcm16_encode(np.asarray(x, np.float32)).astype("<i2")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
