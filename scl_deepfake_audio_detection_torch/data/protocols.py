"""Protocols and file lists of the database layouts.

Counterpart of ``scl_deepfake_audio_detection_tpu/data/protocols.py``:

1. SCL layout (reference ``asvspoof_2019_augall_3.genList``): the train,
   dev and eval lists are ``scp/train_bonafide.lst``, ``scp/dev_bonafide.lst``
   and ``scp/test.lst`` beside ``protocol.txt``; eval audio lies under
   ``eval/``.
2. Generic eval layout (reference ``eval_only.genList``): ``protocol.txt``
   lines are ``<relative audio path> <subset> <label>``.
3. ASVspoof'19-style five-column metadata for score analysis
   (reference ``Result.ipynb``): ``speaker utt - attack label``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

BONAFIDE, SPOOF = 1, 0

_LABEL_MAP = {"bonafide": BONAFIDE, "bona-fide": BONAFIDE, "spoof": SPOOF, "fake": SPOOF}


@dataclass(frozen=True)
class Trial:
    utt: str  # utterance id / relative audio path
    label: Optional[int]  # 1 bonafide, 0 spoof, None unknown
    speaker: Optional[str] = None
    attack: Optional[str] = None
    subset: Optional[str] = None


def _read_lines(path: str) -> List[str]:
    with open(path, "r") as f:
        return [ln.strip() for ln in f if ln.strip()]


def read_scp(path: str) -> List[str]:
    """One utterance filename per line (``scp/*.lst``)."""
    return [ln.split()[0] for ln in _read_lines(path)]


def parse_asvspoof_protocol(path: str) -> List[Trial]:
    """``speaker utt phy attack label`` lines (layout 1 and 3)."""
    trials = []
    for ln in _read_lines(path):
        parts = ln.split()
        if len(parts) < 5:
            raise ValueError(f"bad asvspoof protocol line in {path}: {ln!r}")
        spk, utt, _phy, attack, label = parts[:5]
        trials.append(
            Trial(utt=utt, label=_LABEL_MAP.get(label.lower()), speaker=spk, attack=attack))
    return trials


def parse_subset_protocol(path: str) -> List[Trial]:
    """``<path> <subset> <label>`` lines (layout 2)."""
    trials = []
    for ln in _read_lines(path):
        parts = ln.split()
        if len(parts) < 3:
            raise ValueError(f"bad subset protocol line in {path}: {ln!r}")
        utt, subset, label = parts[:3]
        trials.append(Trial(utt=utt, label=_LABEL_MAP.get(label.lower()), subset=subset))
    return trials


def sniff_protocol(path: str) -> str:
    """The protocol flavour from the first line: 'asvspoof' or 'subset'."""
    first = _read_lines(path)[0].split()
    return "asvspoof" if len(first) >= 5 else "subset"


def parse_protocol(path: str) -> List[Trial]:
    return (parse_asvspoof_protocol(path) if sniff_protocol(path) == "asvspoof"
            else parse_subset_protocol(path))


def label_map(trials: List[Trial], strip_ext: bool = False) -> Dict[str, int]:
    """utt -> {0, 1}; with ``strip_ext`` keyed on the extension-less
    basename, as ``Result.ipynb`` joins score files with protocols."""
    out = {}
    for t in trials:
        if t.label is None:
            continue
        key = os.path.basename(t.utt).split(".")[0] if strip_ext else t.utt
        out[key] = t.label
    return out


_SCL_LISTS = {"train": "scp/train_bonafide.lst", "dev": "scp/dev_bonafide.lst",
              "eval": "scp/test.lst"}


def gen_list_scl(database_path: str, split: str) -> Tuple[Dict[str, int], List[str]]:
    """SCL-layout file list of ``split``: the train and dev lists hold
    bonafide anchors only (labels implied), eval the test list."""
    if split not in _SCL_LISTS:
        raise ValueError(f"split must be train/dev/eval, got {split!r}")
    return {}, read_scp(os.path.join(database_path, _SCL_LISTS[split]))


def gen_list_spoof_dirs(database_path: str, split: str) -> Tuple[Dict[str, int], List[str]]:
    """The SCL lists plus, for train and dev, the real spoofs of
    ``scp/{split}_spoof.lst`` labelled 0 (reference ``SCL_normal.genList``);
    without that list, the bonafide-only lists."""
    labels, files = gen_list_scl(database_path, split)
    if split in ("train", "dev"):
        spoof_lst = os.path.join(database_path, f"scp/{split}_spoof.lst")
        if os.path.exists(spoof_lst):
            for utt in read_scp(spoof_lst):
                labels[utt] = SPOOF
    return labels, files


def gen_list_eval_only(database_path: str) -> Tuple[Dict[str, int], List[str]]:
    """Eval file list of the generic layout: first column of protocol.txt."""
    trials = parse_subset_protocol(os.path.join(database_path, "protocol.txt"))
    return {}, [t.utt for t in trials]
