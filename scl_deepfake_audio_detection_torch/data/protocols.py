"""File lists for the two database layouts.

1. SCL layout (reference ``asvspoof_2019_augall_3.genList``): the train,
   dev and eval lists are ``scp/train_bonafide.lst``, ``scp/dev_bonafide.lst``
   and ``scp/test.lst`` beside ``protocol.txt``; eval audio lies under
   ``eval/``.
2. Generic eval layout (reference ``eval_only.genList``): ``protocol.txt``
   lines are ``<relative audio path> <subset> <label>``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

BONAFIDE, SPOOF = 1, 0


def _read_lines(path: str) -> List[str]:
    with open(path, "r") as f:
        return [ln.strip() for ln in f if ln.strip()]


def read_scp(path: str) -> List[str]:
    """One utterance filename per line (``scp/*.lst``)."""
    return [ln.split()[0] for ln in _read_lines(path)]


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
    utts = []
    path = os.path.join(database_path, "protocol.txt")
    for ln in _read_lines(path):
        parts = ln.split()
        if len(parts) < 3:
            raise ValueError(f"bad subset protocol line in {path}: {ln!r}")
        utts.append(parts[0])
    return {}, utts
