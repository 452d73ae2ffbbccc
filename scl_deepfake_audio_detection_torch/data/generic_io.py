"""Generic dir/ext/dim dataset IO — capability match for the vendored NII
generic data pipeline (the one SURVEY §2.2 row "Generic data io" covers).

Counterpart of ``scl_deepfake_audio_detection_tpu/data/generic_io.py``
(numpy only, the same code); the normaliser statistics come from the port's
own ``utils/stats.OnlineStats``, the audio IO from its ``utils/audio_io``.
``train/scoring.bucketed_batches`` uses ``pad_to_bucket``.

Reference capabilities reproduced (paths relative to /root/reference):

- raw float32 matrix + HTK feature-file IO
  (``core_scripts/data_io/io_tools.py:20-303``): column-count-described flat
  binaries and the 12-byte-header HTK format, little/big endian.
- directory/extension/dimension-descriptor datasets with per-feature
  temporal resolutions, truncation of long utterances into segments,
  minimum-length filtering and a persisted length cache
  (``core_scripts/data_io/default_data_io.py:93-1177``).
- dataset-level mean/std computed by streaming accumulation, persisted, and
  applied as load-time normalization (``default_data_io.py:1053-1392``,
  ``core_scripts/math_tools/stats.py:42-310`` — here via
  ``utils.stats.OnlineStats``), with the NII std floor rule (tiny std -> 1).
- variable-length batch collation by padding
  (``customize_collate_fn.py:48-160``) — with a twist: lengths round up
  to a bucket multiple so a stream of batches takes O(#buckets) shapes
  instead of O(#distinct lengths); a mask-aware model sees identical
  content.
- dataset concatenation with utterance-index adjustment
  (``customize_dataset.py:94-220``).

Design departures from the reference (deliberate):

- No torch ``Dataset``/``DataLoader`` inheritance — plain indexable objects
  feeding the framework's threaded prefetch loaders; batches are numpy,
  device placement happens where the batch is placed
  (``train/engine.place_batch``).
- ``collate_varlen`` returns ``(batch, lengths)`` so downstream code can
  mask — the reference relies on downstream ``pack_padded_sequence``.
- Stats ride one ``.npz`` per dataset instead of the two ``.bin`` blobs +
  ``.dic`` pickle trio; the *information* (per-dim mean/std + length table)
  is the same.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from scl_deepfake_audio_detection_torch.utils.stats import OnlineStats

# NII std floor rule: dimensions with ~zero variance are left unscaled
# (core_scripts/data_io/conf.py:31 ``std_floor`` + math_tools/stats.py
# ``f_var2std``: std < floor -> 1.0).
STD_FLOOR = 1e-8

# ---------------------------------------------------------------------------
# raw float matrix + HTK file IO (io_tools.py equivalents)
# ---------------------------------------------------------------------------


def _dtype(fmt: str, end: str) -> np.dtype:
    prefix = {"l": "<", "b": ">", "n": "="}[end]
    return np.dtype(prefix + fmt)


def read_raw_mat(path: str, col: int, fmt: str = "f4", end: str = "l") -> np.ndarray:
    """Read a headerless binary matrix as [N, col] (col=1 -> 1-D).

    Byte-compatible with ``io_tools.f_read_raw_mat:20-51`` (trailing partial
    rows are dropped by the reshape, as numpy's fromfile does there).
    """
    data = np.fromfile(path, dtype=_dtype(fmt, end))
    n = data.size // col
    data = data[: n * col].reshape(n, col)
    return data[:, 0] if col == 1 else data


def raw_mat_num_elements(path: str, fmt: str = "f4") -> int:
    """Element count of a raw matrix file (``f_read_raw_mat_length:53-74``)."""
    return os.path.getsize(path) // np.dtype(fmt).itemsize


def write_raw_mat(data: np.ndarray, path: str, fmt: str = "f4", end: str = "l") -> None:
    np.ascontiguousarray(data).astype(_dtype(fmt, end)).tofile(path)


def append_raw_mat(data: np.ndarray, path: str, fmt: str = "f4", end: str = "l") -> None:
    """Append rows to an existing raw matrix file (``f_append_raw_mat:207``)."""
    with open(path, "ab") as f:
        np.ascontiguousarray(data).astype(_dtype(fmt, end)).tofile(f)


def write_htk(
    data: np.ndarray,
    path: str,
    samp_period: int = 50000,
    parm_kind: int = 9,
    end: str = "l",
) -> None:
    """Write an HTK feature file (``f_write_htk:243-303`` layout: int32
    nSamples, int32 sampPeriod, int16 sampSize-in-bytes, int16 parmKind,
    then float32 frames)."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:  # 1-D is N single-dim frames (f_write_htk:281-283)
        data = data[:, None]
    n, dim = data.shape
    i4, i2 = _dtype("i4", end), _dtype("i2", end)
    with open(path, "wb") as f:
        np.array([n, samp_period], dtype=i4).tofile(f)
        np.array([dim * 4, parm_kind], dtype=i2).tofile(f)
        data.astype(_dtype("f4", end)).tofile(f)


def read_htk_header(path: str, end: str = "l") -> Dict[str, int]:
    head = np.dtype(
        [
            ("n_samples", _dtype("i4", end)),
            ("samp_period", _dtype("i4", end)),
            ("samp_size", _dtype("i2", end)),
            ("parm_kind", _dtype("i2", end)),
        ]
    )
    info = np.fromfile(path, dtype=head, count=1)[0]
    return {k: int(info[k]) for k in head.names}


def read_htk(path: str, end: str = "l") -> np.ndarray:
    """Read an HTK float32 feature file as [N, dim]
    (``f_read_htk:76-128``)."""
    hdr = read_htk_header(path, end)
    dim = hdr["samp_size"] // 4
    with open(path, "rb") as f:
        f.seek(12)
        data = np.fromfile(f, dtype=_dtype("f4", end))
    n = data.size // dim
    return data[: n * dim].reshape(n, dim)


def htk_num_frames(path: str, end: str = "l") -> int:
    return read_htk_header(path, end)["n_samples"]


# ---------------------------------------------------------------------------
# feature descriptors + per-file load dispatch (default_data_io.py:37-91)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """One feature stream: files at ``dir/<utt><ext>``.

    ``reso`` is the temporal resolution in finest-rate ticks per frame
    (``input_reso`` in ``default_data_io.py``): waveform = 1, a 5 ms frame
    feature at 16 kHz = 80. ``reso < 0`` marks unaligned streams (excluded
    from length accounting, ``default_data_io.py:938-939``). ``normalize``
    mirrors ``input_norm``: False pins mean=0/std=1 for the stream.
    """

    dir: str
    ext: str
    dim: int
    reso: int = 1
    normalize: bool = True

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name + self.ext)

    def load(self, name: str) -> np.ndarray:
        path = self.path(name)
        if self.ext in (".wav", ".flac", ".mp3", ".ogg"):
            from scl_deepfake_audio_detection_torch.utils.audio_io import load_audio

            data = load_audio(path)
        elif self.ext == ".htk":
            data = read_htk(path)
        else:
            data = read_raw_mat(path, self.dim)
        return np.atleast_2d(np.asarray(data, np.float32).T).T  # -> [N, dim]

    def num_frames(self, name: str) -> int:
        path = self.path(name)
        if self.ext in (".wav", ".flac", ".mp3", ".ogg"):
            return int(self.load(name).shape[0])
        if self.ext == ".htk":
            return htk_num_frames(path)
        return raw_mat_num_elements(path) // self.dim


@dataclasses.dataclass
class SeqInfo:
    """Per-segment metadata (``core_scripts/data_io/seq_info.py:19-124``)."""

    length: int
    name: str
    seg_idx: int = 0
    start_pos: int = 0
    idx: int = 0

    def to_str(self) -> str:
        # the NII wire format: idx,name,seg_idx,length,start_pos
        return "{:d},{:s},{:d},{:d},{:d}".format(
            self.idx, self.name, self.seg_idx, self.length, self.start_pos
        )

    @classmethod
    def from_str(cls, s: str) -> "SeqInfo":
        idx, name, seg, length, start = s.split(",")
        return cls(int(length), name, int(seg), int(start), int(idx))


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------


class GenericDataset:
    """Indexable dir/ext/dim dataset with truncation + normalization.

    Equivalent of ``NIIDataSet`` (``default_data_io.py:93-562``): each item
    is the dim-axis concat of its input streams sliced to one segment, plus
    the same for output streams (or None). Lengths are reconciled across
    aligned streams at the finest temporal rate, floored to a multiple of
    the coarsest resolution (``f_adjust_len:986-992``), truncated into
    ``truncate_seq``-tick segments (``f_log_seq_info:1011-1051``) and
    filtered by ``min_seq_len``.
    """

    def __init__(
        self,
        name: str,
        file_list: Sequence[str],
        inputs: Sequence[FeatureSpec],
        outputs: Sequence[FeatureSpec] = (),
        truncate_seq: Optional[int] = None,
        min_seq_len: Optional[int] = None,
        stats_dir: Optional[str] = None,
        compute_norm_stats: bool = True,
    ):
        if not inputs:
            raise ValueError("at least one input FeatureSpec required")
        self.name = name
        self.file_list = list(file_list)
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.truncate_seq = truncate_seq
        self.min_seq_len = min_seq_len
        self.in_dim = sum(s.dim for s in self.inputs)
        self.out_dim = sum(s.dim for s in self.outputs)
        # coarsest aligned resolution: segment boundaries snap to it so every
        # stream slices on frame boundaries (default_data_io.py:294)
        resos = [s.reso for s in self.inputs + self.outputs if s.reso > 0]
        self.single_reso = max(resos) if resos else 1
        # snap truncate/min lengths to the coarsest resolution so segment
        # boundaries land on frame boundaries in EVERY stream — otherwise
        # coarse streams slice tick-shifted and tail ticks zero-fill
        # (reference f_adjust_len, default_data_io.py:299-306,986-992)
        if self.truncate_seq is not None:
            adj = self.truncate_seq // self.single_reso * self.single_reso
            if adj <= 0:
                raise ValueError(
                    f"truncate_seq={self.truncate_seq} is shorter than the "
                    f"coarsest stream resolution ({self.single_reso})"
                )
            self.truncate_seq = adj
        if self.min_seq_len is not None:
            self.min_seq_len = (
                self.min_seq_len // self.single_reso * self.single_reso
            )
        self._stats_path = (
            os.path.join(stats_dir, f"{name}_stats.npz") if stats_dir else None
        )
        self._lengths = self._scan_lengths()
        self.seq_info = self._build_seq_info()
        self.in_mean = np.zeros(self.in_dim, np.float32)
        self.in_std = np.ones(self.in_dim, np.float32)
        self.out_mean = np.zeros(self.out_dim, np.float32)
        self.out_std = np.ones(self.out_dim, np.float32)
        if compute_norm_stats and not self._load_stats():
            self.compute_stats()

    # -- length table -------------------------------------------------------

    def _scan_lengths(self) -> Dict[str, int]:
        """Finest-rate length per file = min over aligned streams of
        frames*reso, floored to a multiple of ``single_reso``
        (``f_log_data_len:926-984``)."""
        cached = self._load_cached_lengths()
        if cached is not None:
            return cached
        lengths: Dict[str, int] = {}
        for fname in self.file_list:
            per_stream = []
            for s in self.inputs + self.outputs:
                if s.reso <= 0:
                    continue
                n = s.num_frames(fname)
                if n > 1:  # utt-level vectors don't constrain length
                    per_stream.append(n * s.reso)
            if not per_stream:
                lengths[fname] = 0
                continue
            ticks = min(per_stream)
            lengths[fname] = ticks // self.single_reso * self.single_reso
        return lengths

    def _load_cached_lengths(self) -> Optional[Dict[str, int]]:
        if not (self._stats_path and os.path.exists(self._stats_path)):
            return None
        z = np.load(self._stats_path, allow_pickle=False)
        if "length_names" not in z:
            return None
        table = dict(zip([str(n) for n in z["length_names"]], z["length_vals"]))
        if set(table) != set(self.file_list):
            return None  # stale cache: list changed — rescan
        return {k: int(v) for k, v in table.items()}

    def _build_seq_info(self) -> List[SeqInfo]:
        infos: List[SeqInfo] = []
        for fname in self.file_list:
            remain, start, seg = self._lengths[fname], 0, 0
            if self.truncate_seq is None:
                if self.min_seq_len is None or remain >= self.min_seq_len:
                    infos.append(SeqInfo(remain, fname, 0, 0, len(infos)))
                continue
            while remain > 0:
                seg_len = min(self.truncate_seq, remain)
                if self.min_seq_len is None or seg_len >= self.min_seq_len:
                    infos.append(SeqInfo(seg_len, fname, seg, start, len(infos)))
                    seg += 1
                start += seg_len
                remain -= seg_len
        return infos

    # -- normalization stats ------------------------------------------------

    def compute_stats(self) -> None:
        """Streaming per-stream mean/std over the whole dataset
        (``f_calculate_stats:1270-1392``); persists alongside the length
        table when ``stats_dir`` is set."""
        for specs, mean, std in (
            (self.inputs, self.in_mean, self.in_std),
            (self.outputs, self.out_mean, self.out_std),
        ):
            s_dim = 0
            for spec in specs:
                acc = OnlineStats(spec.dim)
                if spec.normalize:
                    for fname in self.file_list:
                        acc.update(spec.load(fname))
                    m = acc.mean.astype(np.float32)
                    s = acc.std.astype(np.float32)
                    s = np.where(s < STD_FLOOR, 1.0, s)  # NII floor rule
                else:
                    m = np.zeros(spec.dim, np.float32)
                    s = np.ones(spec.dim, np.float32)
                mean[s_dim : s_dim + spec.dim] = m
                std[s_dim : s_dim + spec.dim] = s
                s_dim += spec.dim
        self._save_stats()

    def _save_stats(self) -> None:
        if not self._stats_path:
            return
        os.makedirs(os.path.dirname(self._stats_path), exist_ok=True)
        names = list(self._lengths)
        np.savez(
            self._stats_path,
            in_mean=self.in_mean,
            in_std=self.in_std,
            out_mean=self.out_mean,
            out_std=self.out_std,
            length_names=np.array(names),
            length_vals=np.array([self._lengths[n] for n in names], np.int64),
        )

    def _load_stats(self) -> bool:
        if not (self._stats_path and os.path.exists(self._stats_path)):
            return False
        z = np.load(self._stats_path, allow_pickle=False)
        if z["in_mean"].shape[0] != self.in_dim or z["out_mean"].shape[0] != self.out_dim:
            return False
        # same freshness rule as the length cache: stats computed over a
        # different file list must not normalize this corpus
        if "length_names" not in z or \
                {str(n) for n in z["length_names"]} != set(self.file_list):
            return False
        self.in_mean = z["in_mean"].astype(np.float32)
        self.in_std = z["in_std"].astype(np.float32)
        self.out_mean = z["out_mean"].astype(np.float32)
        self.out_std = z["out_std"].astype(np.float32)
        return True

    # -- item access --------------------------------------------------------

    def __len__(self) -> int:
        return len(self.seq_info)

    def _assemble(
        self, specs: Sequence[FeatureSpec], info: SeqInfo, total_dim: int
    ) -> np.ndarray:
        seg_frames = max(info.length, 0)  # finest-rate ticks
        out = np.zeros((seg_frames, total_dim), np.float32)
        s_dim = 0
        for spec in specs:
            data = spec.load(info.name)
            if spec.reso < 0:
                # unaligned stream: returned whole, must be the only stream
                # (default_data_io.py:445-455)
                if len(specs) > 1:
                    raise ValueError("unaligned stream must be the only stream")
                return data.astype(np.float32)
            if data.shape[0] == 1:
                # utterance-level vector: broadcast over the segment
                out[:, s_dim : s_dim + spec.dim] = data[0]
            else:
                s = info.start_pos // spec.reso
                n = info.length // spec.reso
                seg = data[s : s + n]
                # repeat coarse frames up to the finest rate so streams align
                rep = np.repeat(seg, spec.reso, axis=0)[:seg_frames]
                out[: rep.shape[0], s_dim : s_dim + spec.dim] = rep
            s_dim += spec.dim
        return out

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, Optional[np.ndarray], SeqInfo]:
        info = self.seq_info[idx]
        x = self._assemble(self.inputs, info, self.in_dim)
        x = (x - self.in_mean) / self.in_std
        y = None
        if self.outputs:
            y = self._assemble(self.outputs, info, self.out_dim)
            y = (y - self.out_mean) / self.out_std
        return x, y, info

    def lengths(self) -> List[int]:
        """Segment lengths for bucketed samplers (``f_get_seq_len_list:742``)."""
        return [s.length for s in self.seq_info]

    def seq_names(self) -> List[str]:
        return [s.name for s in self.seq_info]

    def index_of(self, name: str) -> List[int]:
        """All segment indices of an utterance
        (``f_get_seq_idx_from_name:1550``)."""
        return [i for i, s in enumerate(self.seq_info) if s.name == name]

    # -- output writing (f_putitem:1394-1475) -------------------------------

    def put_item(
        self, data: np.ndarray, save_dir: str, name: str, sr: int = 16000
    ) -> str:
        """De-normalize model output and write it under ``save_dir`` with the
        first output stream's extension (wav -> PCM16, htk -> HTK, else raw
        float32 matrix)."""
        if not self.outputs:
            raise ValueError("dataset has no output streams")
        spec = self.outputs[0]
        data = np.asarray(data, np.float32) * self.out_std + self.out_mean
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, name + spec.ext)
        if spec.ext in (".wav", ".flac"):
            from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

            path = os.path.join(save_dir, name + ".wav")
            save_wav(path, data.reshape(-1), sr)
            return path
        if spec.ext == ".htk":
            write_htk(data, path)
        else:
            write_raw_mat(data, path)
        return path


class ConcatDataset:
    """Concatenation of datasets with global indexing
    (``customize_dataset.py:94-220``'s capability: one index space over
    several corpora, per-corpus stats preserved)."""

    def __init__(self, datasets: Sequence[GenericDataset]):
        if not datasets:
            raise ValueError("need at least one dataset")
        dims = {d.in_dim for d in datasets}
        if len(dims) != 1:
            raise ValueError(f"input dims differ across datasets: {sorted(dims)}")
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _locate(self, idx: int) -> Tuple[GenericDataset, int]:
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        k = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[k], idx - int(self._offsets[k])

    def __getitem__(self, idx: int):
        ds, local = self._locate(idx)
        x, y, info = ds[local]
        # utt-index adjustment (merge_loader.adjust_utt_idx:60-71): the
        # global segment index replaces the per-dataset one
        return x, y, dataclasses.replace(info, idx=idx)

    def lengths(self) -> List[int]:
        return [n for d in self.datasets for n in d.lengths()]

    def seq_names(self) -> List[str]:
        return [n for d in self.datasets for n in d.seq_names()]


# ---------------------------------------------------------------------------
# variable-length collation (customize_collate_fn.py:48-160), bucketed
# ---------------------------------------------------------------------------


def pad_to_bucket(length: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= length (>= multiple)."""
    return max(((length + multiple - 1) // multiple), 1) * multiple


def collate_varlen(
    items: Sequence[np.ndarray],
    pad_value: float = 0.0,
    bucket_multiple: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack [L_i, ...] arrays into ([B, L_pad, ...], lengths [B]).

    ``bucket_multiple > 1`` rounds the padded length up so a stream of
    batches produces only O(max_len / multiple) distinct shapes instead of
    one per distinct max length (the reference pads to the exact batch max,
    ``pad_sequence:48-92``).
    """
    if not items:
        raise ValueError("empty batch")
    trailing = items[0].shape[1:]
    for it in items:
        if it.shape[1:] != trailing:
            raise ValueError(
                f"trailing dims differ in batch: {it.shape[1:]} vs {trailing}"
            )
    lengths = np.array([it.shape[0] for it in items], np.int32)
    pad_len = pad_to_bucket(int(lengths.max()), bucket_multiple)
    out = np.full((len(items), pad_len) + trailing, pad_value, items[0].dtype)
    for i, it in enumerate(items):
        out[i, : it.shape[0]] = it
    return out, lengths


def length_mask(lengths: np.ndarray, pad_len: int) -> np.ndarray:
    """[B, pad_len] float32 validity mask from per-item lengths."""
    return (np.arange(pad_len)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32
    )
