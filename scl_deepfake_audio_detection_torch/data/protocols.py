"""Eval file lists for the two database layouts.

1. SCL layout (reference ``asvspoof_2019_augall_3.genList``): the eval
   list is ``scp/test.lst`` beside ``protocol.txt``, audio under ``eval/``.
2. Generic eval layout (reference ``eval_only.genList``): ``protocol.txt``
   lines are ``<relative audio path> <subset> <label>``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple


def _read_lines(path: str) -> List[str]:
    with open(path, "r") as f:
        return [ln.strip() for ln in f if ln.strip()]


def read_scp(path: str) -> List[str]:
    """One utterance filename per line (``scp/*.lst``)."""
    return [ln.split()[0] for ln in _read_lines(path)]


def gen_list_scl(database_path: str, split: str) -> Tuple[Dict[str, int], List[str]]:
    """SCL-layout file list.  Only the eval split is ported."""
    if split != "eval":
        raise NotImplementedError(f"split {split!r} not ported yet (eval only)")
    return {}, read_scp(os.path.join(database_path, "scp/test.lst"))


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
