"""Training-log parsing: recover loss/time curves from logs.

Counterpart of ``scl_deepfake_audio_detection_tpu/train/logs.py`` (the
same code); ``Engine.fit`` writes ``metrics.jsonl`` in the JAX package's
form, so :func:`read_metrics_jsonl` reads either package's file.

Capability match for the reference's vendored log parsers
(``core_scripts/other_tools/log_parser.py``): the NII trainer's only
machine-readable training record is its stdout, so the reference ships
regex parsers for two formats — per-utterance ``log_err`` lines
("... Time: 0.19s, Loss: 85.99, Loss: ...", ``log_parser.py:20-44``) and
the per-epoch ``log_train`` table ("epoch | duration | train losses |
val losses | ...", ``log_parser.py:99-151``) — plus an epoch-merge mode
that infers the train/val set sizes from the "i/N" counters
(``log_parser.py:154-216``).

This framework's source of truth is structured (``metrics.jsonl``, one
JSON record per epoch — ``train/engine.py::fit``), so the first-class
reader here is :func:`read_metrics_jsonl`. The reference-format parsers
are kept so users migrating from the reference can analyze their existing
run logs without the old toolchain.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

_TIME_RE = re.compile(r"Time:\s*([0-9.eE+-]+)\s*s")
_LOSS_RE = re.compile(r"Loss:\s*([0-9.eE+-]+)")
_COUNTER_RE = re.compile(r"(\d+)\s*/\s*(\d+)\s*,")


def read_metrics_jsonl(path: str) -> Dict[str, np.ndarray]:
    """Read a ``metrics.jsonl`` written by ``Engine.fit`` into column
    arrays keyed by metric name; epochs missing a key get NaN. The union
    of keys across records is covered, in first-seen order."""
    records = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    keys: List[str] = []
    for r in records:
        for k in r:
            if k not in keys:
                keys.append(k)
    return {
        k: np.array([float(r.get(k, np.nan)) for r in records]) for k in keys
    }


def read_log_err(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a reference ``log_err`` (per-utterance lines like
    ``10753,LJ045-0082,..., 22/12100, Time: 0.19s, Loss: 85.99, Loss: ...``)
    into (loss matrix [N, n_losses], time vector [N])
    (``log_parser.py:20-44`` capability). Lines without a Loss field are
    skipped; ragged loss counts are right-padded with NaN."""
    times: List[float] = []
    losses: List[List[float]] = []
    with open(path, "r") as f:
        for line in f:
            vals = [float(m) for m in _LOSS_RE.findall(line)]
            if not vals:
                continue
            t = _TIME_RE.search(line)
            times.append(float(t.group(1)) if t else np.nan)
            losses.append(vals)
    if not losses:
        return np.zeros((0, 0)), np.zeros((0,))
    width = max(len(v) for v in losses)
    mat = np.full((len(losses), width), np.nan)
    for i, v in enumerate(losses):
        mat[i, : len(v)] = v
    return mat, np.array(times)


def _sum_number_group(field: str) -> float:
    """A log_train cell may hold several space-separated numbers that the
    reference sums into one curve point (``log_parser.py:96-97``)."""
    return float(np.sum([float(x) for x in field.split()])) if field.split() else np.nan


def read_log_train(
    path: str, sep: str = "/"
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], np.ndarray]:
    """Parse a reference ``log_train`` per-epoch table into
    (train matrix [E, k], val matrix [E, k], seconds-per-epoch [E])
    (``log_parser.py:99-151`` capability). Data rows start after the
    header line containing ``Duration`` and carry >2 ``|`` separators:
    ``epoch | seconds | train losses | val losses | ...``; loss cells are
    ``sep``-separated, each piece possibly a space-joined number group."""
    rows: List[str] = []
    started = False
    with open(path, "r") as f:
        for line in f:
            if started and line.count("|") > 2:
                rows.append(line)
            if "Duration" in line:
                started = True
    split = (lambda s: s.split()) if sep == " " else (lambda s: s.split(sep))
    # two passes: collect only fully-parsed rows first, THEN size the
    # matrices to the widest row.  Sizing from the first row crashes when a
    # later epoch logs more loss terms, and keeping half-parsed rows leaves
    # silent all-zero curve points (decorative separators, footers).
    parsed: List[Tuple[float, List[float], List[float]]] = []
    for line in rows:
        cells = line.split("|")
        if len(cells) < 4:
            continue
        try:
            t = float(cells[1])
            trn = [_sum_number_group(x) for x in split(cells[2])]
            val = [_sum_number_group(x) for x in split(cells[3])]
        except ValueError:
            continue
        parsed.append((t, trn, val))
    time_per_epoch = np.array([t for t, _, _ in parsed])
    if not parsed:
        return None, None, time_per_epoch
    train_mat = np.full((len(parsed), max(len(p[1]) for p in parsed)), np.nan)
    val_mat = np.full((len(parsed), max(len(p[2]) for p in parsed)), np.nan)
    for i, (_, trn, val) in enumerate(parsed):
        train_mat[i, : len(trn)] = trn
        val_mat[i, : len(val)] = val
    return train_mat, val_mat, time_per_epoch


def read_log_err_epochs(
    path: str, merge_epoch: bool = False
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Split a per-utterance ``log_err`` into train vs validation streams
    by the ``i/N`` counter's set size N, optionally averaging each stream
    per epoch (``log_parser.py:154-216`` capability).

    The first N seen is the train-set size; the first different N is the
    val-set size. Returns (train rows, val rows) or per-epoch means when
    ``merge_epoch``; None when nothing parses."""
    sizes: List[int] = []
    data: List[Tuple[int, List[float]]] = []
    with open(path, "r") as f:
        for line in f:
            vals = [float(m) for m in _LOSS_RE.findall(line)]
            c = _COUNTER_RE.search(line)
            if not vals or not c or "Time:" not in line:
                continue
            n = int(c.group(2))
            if n not in sizes:
                sizes.append(n)
            data.append((n, vals))
    if not data:
        return None
    trn_n = sizes[0]
    val_n = sizes[1] if len(sizes) > 1 else None
    trn = np.array([v for n, v in data if n == trn_n])
    val = (
        np.array([v for n, v in data if n == val_n])
        if val_n is not None
        else np.zeros((0, trn.shape[1]))
    )
    if not merge_epoch:
        return trn, val
    n_ep = len(trn) // trn_n
    if val_n is not None:
        n_ep = min(n_ep, len(val) // val_n)
    trn_m = np.stack(
        [trn[e * trn_n : (e + 1) * trn_n].mean(0) for e in range(n_ep)]
    ) if n_ep else np.zeros((0, trn.shape[1]))
    if val_n is None or n_ep == 0:
        return trn_m, np.zeros((0, trn.shape[1]))
    val_m = np.stack([val[e * val_n : (e + 1) * val_n].mean(0) for e in range(n_ep)])
    return trn_m, val_m
