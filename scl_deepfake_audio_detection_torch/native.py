"""ctypes bindings for the native host libraries: the DSP loops of
``native_src/scl_host.cpp`` and the libav* audio decoder and encoder of
``native_src/scl_codec.cpp``.

Counterpart of ``scl_deepfake_audio_detection_tpu/native.py``, over the
port's own copies of its C++ sources.  These are host code built with
``g++``, not device kernels.  Each library is compiled at first use, never
at import, into ``BUILD_DIR`` under a name that hashes its source and
flags; the compiler writes a temporary file that ``os.replace`` moves into
place, so processes that build at once never load half a library.  When a
library does not build or load, ``available()`` or ``codec_available()``
is False and the callers take their numpy or stdlib path, as the JAX
package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent / "native_src"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
_CODEC_LIBS = ("-lavformat", "-lavcodec", "-lavutil")

_lock = threading.Lock()
# source stem -> why its library did not build (the compiler's last words)
BUILD_ERRORS: Dict[str, str] = {}
_lib: Optional[ctypes.CDLL] = None
_tried = False
_codec_lib: Optional[ctypes.CDLL] = None
_codec_tried = False


def _library_path(src: Path, flags) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _build(stem: str, libs=()) -> Optional[Path]:
    """The built library of ``native_src/<stem>.cpp``, compiled now if it is
    not there yet; None when the compiler fails."""
    src = _SRC_DIR / f"{stem}.cpp"
    so = _library_path(src, _FLAGS + tuple(libs))
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(src), *libs],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: another process sees the whole file or none
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        err = getattr(e, "stderr", None)
        lines = (err.decode(errors="replace") if err else str(e)).strip().splitlines()
        BUILD_ERRORS[stem] = "\n".join(lines[-3:])
        return None
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build("scl_host")
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        if lib.scl_abi_version() != 1:
            return None

        c_dp = ctypes.POINTER(ctypes.c_double)
        c_fp = ctypes.POINTER(ctypes.c_float)
        c_lp = ctypes.POINTER(ctypes.c_long)
        lib.scl_wav_read_f32.restype = ctypes.c_long
        lib.scl_wav_read_f32.argtypes = [
            ctypes.c_char_p, c_fp, ctypes.c_long, ctypes.POINTER(ctypes.c_int)]
        lib.scl_fir_centered.argtypes = [c_dp, ctypes.c_long, c_dp, ctypes.c_long, c_dp]
        lib.scl_lnl_apply.argtypes = [c_fp, ctypes.c_long, c_dp, c_lp, ctypes.c_int, c_fp]
        lib.scl_isd_apply.argtypes = [c_fp, ctypes.c_long, ctypes.c_double,
                                      ctypes.c_double, ctypes.c_uint64, c_fp]
        lib.scl_ssi_mix.argtypes = [c_fp, c_fp, ctypes.c_long, ctypes.c_double, c_fp]
        lib.scl_multiview_pad.argtypes = [
            ctypes.POINTER(c_fp), c_lp, ctypes.c_int, ctypes.c_long,
            ctypes.c_long, ctypes.c_int, ctypes.c_long, c_fp]
        lib.scl_mix_at_snr.argtypes = [c_fp, ctypes.c_long, c_fp, ctypes.c_long,
                                       ctypes.c_double, c_fp]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the host DSP library built and loaded."""
    return _load() is not None


def _load_codec() -> Optional[ctypes.CDLL]:
    global _codec_lib, _codec_tried
    with _lock:
        if _codec_lib is not None or _codec_tried:
            return _codec_lib
        _codec_tried = True
        so = _build("scl_codec", _CODEC_LIBS)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        if lib.scl_codec_abi_version() != 1:
            return None
        c_fp = ctypes.POINTER(ctypes.c_float)
        lib.scl_codec_last_error.restype = ctypes.c_char_p
        lib.scl_codec_encoder_available.argtypes = [ctypes.c_char_p]
        lib.scl_audio_open.restype = ctypes.c_void_p
        lib.scl_audio_open.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
        lib.scl_audio_copy.argtypes = [ctypes.c_void_p, c_fp]
        lib.scl_audio_close.argtypes = [ctypes.c_void_p]
        lib.scl_audio_encode.restype = ctypes.c_int
        lib.scl_audio_encode.argtypes = [
            ctypes.c_char_p, c_fp, ctypes.c_long, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_long]
        _codec_lib = lib
        return _codec_lib


def codec_available() -> bool:
    """True when the libav*-backed decode and encode library is usable."""
    return _load_codec() is not None


def encoder_available(codec: str) -> bool:
    lib = _load_codec()
    return bool(lib) and lib.scl_codec_encoder_available(codec.encode()) == 1


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode any audio file libav* reads (flac, mp3, ogg, opus, wav, ...)
    to mono float32 at its own sample rate."""
    lib = _load_codec()
    if lib is None:
        raise RuntimeError("native codec library unavailable")
    n = ctypes.c_long(0)
    sr = ctypes.c_int(0)
    handle = lib.scl_audio_open(path.encode(), ctypes.byref(n), ctypes.byref(sr))
    if not handle:
        raise ValueError(f"cannot decode {path}: {lib.scl_codec_last_error().decode()}")
    try:
        out = np.empty(n.value, np.float32)
        lib.scl_audio_copy(handle, _fptr(out))
    finally:
        lib.scl_audio_close(handle)
    return out, int(sr.value)


def encode_audio(path: str, x: np.ndarray, sr: int, codec: str, bitrate: int = 0) -> None:
    """Encode mono float32 to ``path`` (the container from the extension:
    .mp3, .opus, .flac, .wav for alaw/ulaw/g722); ``bitrate`` in bits/s,
    0 for the codec's default."""
    lib = _load_codec()
    if lib is None:
        raise RuntimeError("native codec library unavailable")
    xf = np.ascontiguousarray(x, np.float32)
    ret = lib.scl_audio_encode(path.encode(), _fptr(xf), len(xf), int(sr), codec.encode(),
                               int(bitrate))
    if ret != 0:
        raise ValueError(f"encode to {path} failed ({codec}): "
                         f"{lib.scl_codec_last_error().decode()}")


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _host_lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a PCM16 or float32 WAV to mono float32.  Raises ValueError on
    a file it cannot read."""
    lib = _host_lib()
    sr = ctypes.c_int(0)
    frames = lib.scl_wav_read_f32(path.encode(), None, 0, ctypes.byref(sr))
    if frames < 0:
        raise ValueError(f"cannot decode {path}")
    out = np.empty(frames, np.float32)
    got = lib.scl_wav_read_f32(path.encode(), _fptr(out), frames, ctypes.byref(sr))
    if got != frames:
        raise ValueError(f"short read on {path}")
    return out, int(sr.value)


def fir_centered(x: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _host_lib()
    x64 = np.ascontiguousarray(x, np.float64)
    b64 = np.ascontiguousarray(b, np.float64)
    y = np.empty_like(x64)
    lib.scl_fir_centered(_dptr(x64), len(x64), _dptr(b64), len(b64), _dptr(y))
    return y


def lnl_apply(x: np.ndarray, chains) -> np.ndarray:
    """sum_i fir(x^(i+1), chains[i]), de-meaned, then peak-normalised when
    it exceeds 1 (RawBoost's LnL given its filter chains)."""
    lib = _host_lib()
    xf = np.ascontiguousarray(x, np.float32)
    coeffs = np.ascontiguousarray(np.concatenate(chains), np.float64)
    offsets = np.zeros(len(chains) + 1, np.int64)
    np.cumsum([len(c) for c in chains], out=offsets[1:])
    out = np.empty_like(xf)
    lib.scl_lnl_apply(_fptr(xf), len(xf), _dptr(coeffs),
                      offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                      len(chains), _fptr(out))
    return out


def isd_apply(x: np.ndarray, p_max: float, g_sd: float, seed: int) -> np.ndarray:
    lib = _host_lib()
    xf = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(xf)
    lib.scl_isd_apply(_fptr(xf), len(xf), float(p_max), float(g_sd),
                      ctypes.c_uint64(seed), _fptr(out))
    return out


def ssi_mix(x: np.ndarray, noise: np.ndarray, snr_db: float) -> np.ndarray:
    lib = _host_lib()
    xf = np.ascontiguousarray(x, np.float32)
    nf = np.ascontiguousarray(noise, np.float32)
    out = np.empty_like(xf)
    lib.scl_ssi_mix(_fptr(xf), _fptr(nf), len(xf), float(snr_db), _fptr(out))
    return out


def multiview_pad(views, length: int, repeat_pad: bool, start: int) -> np.ndarray:
    """Co-crop views to [V, length] at the shared start offset (lengths
    matched to views[0]'s)."""
    lib = _host_lib()
    vs = [np.ascontiguousarray(v, np.float32) for v in views]
    ptrs = (ctypes.POINTER(ctypes.c_float) * len(vs))(*[_fptr(v) for v in vs])
    lens = np.array([len(v) for v in vs], np.int64)
    out = np.empty((len(vs), length), np.float32)
    lib.scl_multiview_pad(ptrs, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(vs),
                          int(lens[0]), length, int(bool(repeat_pad)), int(start), _fptr(out))
    return out


def mix_at_snr(x: np.ndarray, noise: np.ndarray, snr_db: float) -> np.ndarray:
    lib = _host_lib()
    xf = np.ascontiguousarray(x, np.float32)
    nf = np.ascontiguousarray(noise, np.float32)
    out = np.empty_like(xf)
    lib.scl_mix_at_snr(_fptr(xf), len(xf), _fptr(nf), len(nf), float(snr_db), _fptr(out))
    return out
