"""Packed decode cache for eval audio (``--decode_cache``).

Counterpart of ``scl_deepfake_audio_detection_tpu/data/decode_cache.py``,
file for file.  An eval list is scored once per checkpoint of a sweep, and
the reference decodes every file on every run; this cache decodes once
into one packed PCM16 file:

    <dir>/pcm16.bin    one flat little-endian int16 array
    <dir>/index.json   {"sample_rate": sr, "utts": {utt: [offset, length]}}

Reads are memmap slices.  PCM16 is lossless for 16-bit sources (LA19's
flac is 16-bit, and ``load_audio`` returns int16 / 32768 exactly).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np

from scl_deepfake_audio_detection_torch.utils.audio_io import pcm16_encode

_BIN = "pcm16.bin"
_INDEX = "index.json"


class DecodeCache:
    def __init__(self, cache_dir: str):
        self.dir = cache_dir
        self._index: Optional[dict] = None
        self._mm: Optional[np.memmap] = None
        idx_path = os.path.join(cache_dir, _INDEX)
        bin_path = os.path.join(cache_dir, _BIN)
        if os.path.exists(idx_path) and os.path.exists(bin_path):
            with open(idx_path) as f:
                index = json.load(f)
            mm = np.memmap(bin_path, dtype="<i2", mode="r")
            # the two files are renamed into place one after the other; a
            # kill between the renames can pair a new bin with a stale
            # index, so the pair counts only when the index spans the bin
            end = max((off + length for off, length in index["utts"].values()), default=0)
            if end == mm.size:
                self._index = index
                self._mm = mm

    @property
    def ready(self) -> bool:
        return self._index is not None

    @property
    def sample_rate(self) -> Optional[int]:
        return self._index["sample_rate"] if self._index else None

    def __len__(self) -> int:
        return len(self._index["utts"]) if self._index else 0

    def has(self, utt: str) -> bool:
        return bool(self._index) and utt in self._index["utts"]

    def get(self, utt: str) -> np.ndarray:
        """The unpadded mono float32 waveform of ``utt`` (KeyError if absent)."""
        off, length = self._index["utts"][utt]
        return self._mm[off : off + length].astype(np.float32) / 32768.0

    @classmethod
    def build(cls, cache_dir: str, utts: Sequence[str], load_fn: Callable[[str], np.ndarray],
              sample_rate: int = 16000, num_workers: int = 4,
              progress_every: int = 5000) -> "DecodeCache":
        """Decode ``utts`` on a thread pool (the native decoders release
        the GIL) and pack them.  Both files are written to temporary names
        and renamed, so a killed build leaves no half-valid cache."""
        os.makedirs(cache_dir, exist_ok=True)
        bin_tmp = os.path.join(cache_dir, _BIN + ".tmp")
        index = {"sample_rate": sample_rate, "utts": {}}
        offset = 0
        with open(bin_tmp, "wb") as out, ThreadPoolExecutor(max(1, num_workers)) as pool:
            for i, (utt, wav) in enumerate(zip(utts, pool.map(load_fn, utts))):
                pcm = pcm16_encode(np.asarray(wav, np.float32)).astype("<i2")
                out.write(pcm.tobytes())
                index["utts"][utt] = [offset, len(pcm)]
                offset += len(pcm)
                if progress_every and (i + 1) % progress_every == 0:
                    print(f"decode cache: {i + 1}/{len(utts)}", flush=True)
        idx_tmp = os.path.join(cache_dir, _INDEX + ".tmp")
        with open(idx_tmp, "w") as f:
            json.dump(index, f)
        os.replace(bin_tmp, os.path.join(cache_dir, _BIN))
        os.replace(idx_tmp, os.path.join(cache_dir, _INDEX))
        return cls(cache_dir)
