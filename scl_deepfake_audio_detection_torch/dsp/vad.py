"""Energy-based voice activity detection (silence handling).

Counterpart of ``scl_deepfake_audio_detection_tpu/dsp/vad.py``, host numpy
copied as it is (the reference's ``core_scripts/data_io/wav_tools.py:289-524``,
the Kinnunen & Li SAD recipe): frame energies ``20*log10(std)``
thresholded at ``max_energy - 30 dB`` and an absolute ``-55 dB`` floor,
short-segment smoothing in both directions, an optional silence-only-at-
the-edges mode, and windowed overlap-add reconstruction of the speech and
silence streams.  ``dsp/augment`` uses ``frame_signal``; ``dsp/pad``'s
silence trims use ``speech_bounds_samples``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def frame_signal(x: np.ndarray, frame_len: int, frame_shift: int) -> np.ndarray:
    """[T] -> [n_frames, frame_len], 'nodelay' framing (the tail dropped)."""
    n = 1 + (x.shape[0] - frame_len) // frame_shift if x.shape[0] >= frame_len else 0
    idx = np.arange(frame_len)[None, :] + frame_shift * np.arange(n)[:, None]
    return x[idx]


def _suppress_short_segments(tag: np.ndarray, min_len: float) -> np.ndarray:
    out = tag.copy()
    bound = np.diff(np.concatenate([[0], tag, [0]]))
    starts = np.flatnonzero(bound == 1)
    ends = np.flatnonzero(bound == -1)
    for s, e in zip(starts, ends):
        if e - s < min_len:
            out[s:e] = 0
    return out


def detect_speech_frames(
    x: np.ndarray,
    sr: int,
    frame_len: int = 320,
    frame_shift: int = 80,
    max_thres_below: float = 30.0,
    min_thres: float = -55.0,
    shortest_len_ms: float = 50.0,
    only_edge_silence: bool = False,
) -> np.ndarray:
    """Per-frame 0/1 speech tags."""
    if frame_shift >= frame_len:
        raise ValueError("frame shift must be smaller than frame length")
    frames = frame_signal(x, frame_len, frame_shift)
    energy = 20.0 * np.log10(np.std(frames, axis=1) + np.finfo(np.float32).eps)
    tag = ((energy > energy.max() - max_thres_below) & (energy > min_thres)).astype(int)

    min_seg = shortest_len_ms * sr / 1000.0 / frame_shift
    # drop short silences, then short speech bursts
    tag = 1 - _suppress_short_segments(1 - tag, min_seg)
    tag = _suppress_short_segments(tag, min_seg)

    if only_edge_silence:
        nz = np.flatnonzero(tag)
        if nz.size:
            tag[nz[0] : nz[-1]] = 1
    return tag


def split_speech_silence(
    x: np.ndarray,
    sr: int,
    frame_len: int = 320,
    frame_shift: int = 80,
    normalize: bool = True,
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(speech, silence, frame_tags) by Hamming-windowed overlap-add, the
    amplitude renormalised by the window envelope (reference
    ``wav_tools.py:452-479``)."""
    tag = detect_speech_frames(x, sr, frame_len, frame_shift, **kwargs)
    frames = frame_signal(x, frame_len, frame_shift)
    win = np.hamming(frame_len)

    def _ola(selected: np.ndarray) -> np.ndarray:
        buf = np.zeros(selected.shape[0] * frame_shift + frame_len, dtype=x.dtype)
        env = np.zeros_like(buf)
        for i, fr in enumerate(selected):
            buf[i * frame_shift : i * frame_shift + frame_len] += fr * win
            env[i * frame_shift : i * frame_shift + frame_len] += win
        if normalize:
            env[env < 1e-4] = 1.0
            buf = buf / env
        return buf

    return _ola(frames[tag == 1]), _ola(frames[tag == 0]), tag


def speech_bounds_samples(
    x: np.ndarray, sr: int, frame_shift: int = 80, **kwargs
) -> Tuple[int, int]:
    """(start, end) sample indices of the non-silence region (the trim of
    ``wav_rand_sil_trim``, reference ``wav_augmentation.py:110-123``)."""
    tag = detect_speech_frames(x, sr, frame_shift=frame_shift, only_edge_silence=True, **kwargs)
    nz = np.flatnonzero(tag)
    if nz.size == 0:
        return 0, x.shape[0]
    return int(nz[0] * frame_shift), int(nz[-1] * frame_shift)
