"""Codec simulation: G.711 companding, telephone effect, lossy round-trips.

Counterpart of ``scl_deepfake_audio_detection_tpu/dsp/codec.py``, on the
port's own ``dsp/fir``, ``native`` and ``utils/audio_io``: the same
functions and tables, and the same order of random draws, so that one
numpy ``Generator`` picks the same codec and bitrate in both packages.

Capability match for the reference's telephone augmentor
(``datautils/audio_augmentor/telephone.py:23-72``: ALAW/ULAW/g722 codec +
bandpass via torchaudio's ffmpeg AudioEffector — flagged unstable in its own
``__init__.py:6``) and the codec round-trip ``wav_codec``
(``core_scripts/data_io/wav_augmentation.py:367-456``: mp3/opus via pydub).

No ffmpeg *binary* or torchaudio can be assumed, so:
- ALAW / ULAW are implemented natively (ITU-T G.711 reference math on
  int16 PCM) — bit-exact companding round trips, no external process;
- the telephone effect = bandpass FIR (300-3400 Hz default) + codec round
  trip: real G.722 (ADPCM) through the native codec module when available,
  else G.711 companding, all in-process;
- mp3/opus round-trips run through the native codec module (the ffmpeg
  *libraries* linked directly — ``native_src/scl_codec.cpp``), falling back to
  an ``ffmpeg`` binary when only that exists, and raise ``CodecUnavailable``
  otherwise (callers treat them as optional).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import numpy as np

from scl_deepfake_audio_detection_torch.dsp.fir import firwin_bandstop


class CodecUnavailable(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# G.711 companding (native)
# ---------------------------------------------------------------------------

_ALAW_A = 87.6


def _float_to_i16(x: np.ndarray) -> np.ndarray:
    return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)


def _i16_to_float(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32) / 32768.0


_SEG_AEND = np.array([0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF])
_SEG_UEND = np.array([0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF])
_ULAW_BIAS = 0x84
_ULAW_CLIP = 8159


def _seg_search(val: np.ndarray, table: np.ndarray) -> np.ndarray:
    """First segment index with val <= table[seg]; 8 when above all."""
    return np.sum(val[..., None] > table, axis=-1)


def alaw_encode(x: np.ndarray) -> np.ndarray:
    """float waveform [-1, 1] -> A-law bytes (ITU G.711 / g711.c
    ``linear2alaw``, vectorized; bit-exact vs CPython audioop)."""
    pcm = _float_to_i16(x).astype(np.int32) >> 3  # 13-bit
    mask = np.where(pcm >= 0, 0xD5, 0x55)
    pcm = np.where(pcm >= 0, pcm, -pcm - 1)
    seg = _seg_search(pcm, _SEG_AEND)
    low = np.where(seg < 2, (pcm >> 1) & 0x0F, (pcm >> np.minimum(seg, 7)) & 0x0F)
    aval = (np.minimum(seg, 7) << 4) | low
    aval = np.where(seg >= 8, 0x7F, aval)
    return ((aval ^ mask) & 0xFF).astype(np.uint8)


def alaw_decode(code: np.ndarray) -> np.ndarray:
    c = code.astype(np.int32) ^ 0x55
    t = (c & 0x0F) << 4
    seg = (c >> 4) & 0x07
    t = np.where(seg == 0, t + 8, np.where(seg == 1, t + 0x108, (t + 0x108) << np.maximum(seg - 1, 0)))
    val = np.where(c & 0x80, t, -t)
    return _i16_to_float(val.astype(np.int16))


def ulaw_encode(x: np.ndarray) -> np.ndarray:
    """float waveform -> mu-law bytes (g711.c ``linear2ulaw``, vectorized)."""
    pcm = _float_to_i16(x).astype(np.int32) >> 2  # 14-bit
    mask = np.where(pcm < 0, 0x7F, 0xFF)
    pcm = np.minimum(np.abs(pcm), _ULAW_CLIP) + (_ULAW_BIAS >> 2)
    seg = _seg_search(pcm, _SEG_UEND)
    uval = (np.minimum(seg, 7) << 4) | ((pcm >> (np.minimum(seg, 7) + 1)) & 0x0F)
    uval = np.where(seg >= 8, 0x7F, uval)
    return ((uval ^ mask) & 0xFF).astype(np.uint8)


def ulaw_decode(code: np.ndarray) -> np.ndarray:
    c = (~code.astype(np.int32)) & 0xFF
    t = ((c & 0x0F) << 3) + _ULAW_BIAS
    t = t << ((c >> 4) & 0x07)
    val = np.where(c & 0x80, _ULAW_BIAS - t, t - _ULAW_BIAS)
    return _i16_to_float(val.astype(np.int16))


def g711_roundtrip(x: np.ndarray, law: str = "alaw") -> np.ndarray:
    """Encode + decode — the quantization distortion a real G.711 link adds."""
    if law.lower() in ("alaw", "a-law", "a"):
        return alaw_decode(alaw_encode(x))
    if law.lower() in ("ulaw", "u-law", "mu", "mulaw", "u"):
        return ulaw_decode(ulaw_encode(x))
    raise ValueError(f"unknown companding law: {law!r}")


# ---------------------------------------------------------------------------
# parametric companding (vocoder-style, arbitrary quantization levels)
# ---------------------------------------------------------------------------
# The continuous mu-law / A-law formulas at arbitrary channel counts — the
# WaveNet-style quantizers of the reference's wav_tools
# (``core_scripts/data_io/wav_tools.py:34-139``), distinct from the
# table-driven 8-bit G.711 codecs above.


def mulaw_compand(
    x: np.ndarray, channels: int = 256, scale_to_int: bool = True
) -> np.ndarray:
    """mu-law compand a (-1, 1) waveform; int codes in [0, channels-1] or
    the companded float in (-1, 1) (``wav_tools.py:34-56``)."""
    mu = channels - 1.0
    y = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    if scale_to_int:
        y = ((y + 1) / 2 * mu + 0.5).astype(np.int32)
    return y


def mulaw_expand(
    y: np.ndarray, channels: int = 256, input_int: bool = True
) -> np.ndarray:
    """Invert :func:`mulaw_compand` (``wav_tools.py:57-80``)."""
    mu = channels - 1.0
    x = y / mu * 2 - 1.0 if input_int else np.asarray(y, np.float64)
    return np.sign(x) * (np.exp(np.abs(x) * np.log1p(mu)) - 1.0) / mu


def alaw_compand(
    x: np.ndarray,
    channels: int = 256,
    scale_to_int: bool = True,
    A: float = _ALAW_A,
) -> np.ndarray:
    """Continuous A-law compand (``wav_tools.py:82-107``): linear below
    |x| = 1/A, logarithmic above."""
    num = channels - 1.0
    ax = A * np.abs(x)
    y = np.where(ax >= 1, 1 + np.log(np.maximum(ax, 1.0)), ax)
    y = np.sign(x) * y / (1 + np.log(A))
    if scale_to_int:
        y = ((y + 1) / 2 * num + 0.5).astype(np.int32)
    return y


def alaw_expand(
    y: np.ndarray, channels: int = 256, input_int: bool = True, A: float = _ALAW_A
) -> np.ndarray:
    """Invert :func:`alaw_compand` (``wav_tools.py:109-139``)."""
    num = channels - 1.0
    x = y / num * 2 - 1.0 if input_int else np.asarray(y, np.float64)
    sign = np.sign(x)
    v = np.abs(x) * (1 + np.log(A))
    v = np.where(v >= 1, np.exp(np.minimum(v, 700.0) - 1), v)
    return sign * v / A


# ---------------------------------------------------------------------------
# telephone effect
# ---------------------------------------------------------------------------


def bandpass_fir(
    x: np.ndarray,
    sr: int = 16000,
    low: float = 300.0,
    high: float = 3400.0,
    numtaps: int = 101,
) -> np.ndarray:
    """Linear-phase bandpass via the complement of a band-stop design (uses
    the framework's windowed-sinc designer; centered filtering keeps length).
    """
    stop = firwin_bandstop(numtaps, low, high, sr)
    band = -stop
    band[numtaps // 2] += 1.0  # pass = delta - stop
    y = np.convolve(x, band, mode="full")
    d = numtaps // 2
    return y[d : d + len(x)].astype(np.float32)


# ffmpeg's adpcm_g722 QMF analysis+synthesis delay at 16 kHz (measured; the
# raw WAV container carries no gapless metadata to trim it automatically)
_G722_DELAY = 22


def g722_roundtrip(x: np.ndarray, sr: int = 16000) -> np.ndarray:
    """Real G.722 (ADPCM) encode/decode via the native codec module; the
    codec is specified at 16 kHz only. Raises CodecUnavailable otherwise."""
    from scl_deepfake_audio_detection_torch import native

    if sr != 16000 or not native.codec_available() or not native.encoder_available("g722"):
        raise CodecUnavailable("g722 needs the native codec module at 16 kHz")
    try:
        with tempfile.TemporaryDirectory() as d:
            mid = os.path.join(d, "mid.wav")
            native.encode_audio(mid, x, sr, "g722")
            y, _ = native.read_audio(mid)
    except (ValueError, RuntimeError) as e:
        # callers contract on CodecUnavailable to fall back (e.g. to G.711)
        raise CodecUnavailable(f"native g722 round trip failed: {e}") from e
    y = y[_G722_DELAY:]
    out = np.zeros(len(x), np.float32)
    n = min(len(x), len(y))
    out[:n] = y[:n]
    return out


def telephone_effect(
    x: np.ndarray,
    sr: int = 16000,
    encoding: str = "alaw",
    low: float = 300.0,
    high: float = 3400.0,
) -> np.ndarray:
    """Bandpass to telephone bandwidth, then a codec round trip (capability
    equivalent of TelephoneEncodingAugmentor: alaw / ulaw / g722)."""
    y = bandpass_fir(x, sr, low, high)
    if encoding.lower() in ("g722",):
        try:
            return g722_roundtrip(y, sr)
        except CodecUnavailable:
            # without the native module, approximate the ADPCM stage by
            # mu-law quantization at telephone bandwidth
            encoding = "ulaw"
    return g711_roundtrip(y, encoding)


# ---------------------------------------------------------------------------
# lossy codec round trip via ffmpeg (optional)
# ---------------------------------------------------------------------------

MP3_BITRATES = ("16k", "32k", "64k", "128k", "256k", "320k")
OPUS_BITRATES = ("6k", "12k", "24k", "48k", "96k")


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _parse_bitrate(bitrate: str) -> int:
    s = str(bitrate).strip().lower()
    return int(float(s[:-1]) * 1000) if s.endswith("k") else int(float(s))


def codec_roundtrip(
    x: np.ndarray,
    sr: int = 16000,
    codec: str = "mp3",
    bitrate: str = "64k",
) -> np.ndarray:
    """Encode/decode through a real lossy codec (reference ``wav_codec``,
    ``wav_augmentation.py:367-456``). Uses the native codec module (ffmpeg
    libraries linked in-process) when available, else an ffmpeg binary;
    raises CodecUnavailable otherwise so callers can fall back to G.711.
    Gapless metadata is honored, so the output is sample-aligned with the
    input (zero-padded/truncated to the same length)."""
    from scl_deepfake_audio_detection_torch import native

    ext = {"mp3": "mp3", "opus": "opus"}[codec]
    if native.codec_available() and native.encoder_available(codec):
        from scl_deepfake_audio_detection_torch.utils.audio_io import resample

        try:
            with tempfile.TemporaryDirectory() as d:
                mid = os.path.join(d, f"mid.{ext}")
                native.encode_audio(mid, x, sr, codec, _parse_bitrate(bitrate))
                y, mid_sr = native.read_audio(mid)
        except (ValueError, RuntimeError) as e:
            # e.g. an encoder that exists but rejects this sample rate —
            # callers contract on CodecUnavailable to fall back to G.711
            raise CodecUnavailable(f"native {codec} round trip failed: {e}") from e
        y = resample(y, mid_sr, sr)  # opus decodes at 48 kHz
    elif ffmpeg_available():
        from scl_deepfake_audio_detection_torch.utils.audio_io import (
            load_audio,
            save_wav,
        )

        with tempfile.TemporaryDirectory() as d:
            src = os.path.join(d, "in.wav")
            mid = os.path.join(d, f"mid.{ext}")
            out = os.path.join(d, "out.wav")
            save_wav(src, x, sr)
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "quiet", "-i", src, "-b:a",
                 bitrate, mid],
                check=True,
            )
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "quiet", "-i", mid, "-ar",
                 str(sr), out],
                check=True,
            )
            y = load_audio(out, sr)
    else:
        raise CodecUnavailable(
            "no native codec module and no ffmpeg binary on PATH"
        )
    n = min(len(x), len(y))
    res = np.zeros_like(x, dtype=np.float32)
    res[:n] = y[:n]
    return res


def random_codec(x: np.ndarray, rng: np.random.Generator, sr: int = 16000) -> np.ndarray:
    """Random mp3/opus round trip like the reference's wav_codec; falls back
    to a random G.711 law when no codec backend exists at all."""
    try:
        if rng.integers(2) == 0:
            return codec_roundtrip(x, sr, "mp3", MP3_BITRATES[rng.integers(6)])
        return codec_roundtrip(x, sr, "opus", OPUS_BITRATES[rng.integers(5)])
    except CodecUnavailable:
        return g711_roundtrip(x, "alaw" if rng.integers(2) == 0 else "ulaw")
