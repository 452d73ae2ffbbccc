"""Tag-indexed score warehouse for result analysis.

Counterpart of ``scl_deepfake_audio_detection_tpu/utils/warehouse.py``
(numpy only, the same code).

Capability match for the reference's vendored
``core_scripts/other_tools/data_warehouse.py``: load a text file of
result lines, tag each parsed entry (e.g. system / attack / metric),
then pull single views (all values matching some tags,
``data_warehouse.py:116-133``) or the full cross-product of tag values
as a tensor (``data_warehouse.py:156-183``) — the workhorse behind
per-system x per-attack score grids in listening-test / EER analyses.

Redesign notes: one flat entry list with tuple tags (no per-entry dict),
views computed by comprehension; empty cross cells and ragged view
lengths are filled with NaN (the original used +inf padding and left a
stray 1.0 in empty statistics cells — NaN composes with np.nanmean and
cannot be mistaken for data)."""

from __future__ import annotations

import itertools
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np


class DataWarehouse:
    """Parse a text file into tagged entries and serve cross views.

    Each non-empty line runs through every (value_parser, tag_parsers)
    pair; a pair yielding a None value or any None tag skips the line
    (``data_warehouse.py:79-104`` semantics).
    """

    def __init__(
        self,
        path: str,
        value_parsers: Sequence[Callable[[str], Any]],
        tag_parsers: Sequence[Sequence[Callable[[str], Any]]],
    ):
        self.entries: List[Tuple[Any, Tuple[Any, ...]]] = []
        self._tag_values: dict = {}
        with open(path, "r") as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        for line in lines:
            for parse_v, parse_ts in zip(value_parsers, tag_parsers):
                value = parse_v(line)
                tags = tuple(p(line) for p in parse_ts)
                if value is None or any(t is None for t in tags):
                    continue
                self.entries.append((value, tags))
                for i, t in enumerate(tags):
                    self._tag_values.setdefault(i, [])
                    if t not in self._tag_values[i]:
                        self._tag_values[i].append(t)

    def tags(self, tag_idx: int) -> Optional[list]:
        """All values seen for one tag slot, in first-seen order."""
        return self._tag_values.get(tag_idx)

    def view(
        self,
        tag_idxs: Sequence[int],
        tag_values: Sequence[Any],
        score_parse: Optional[Callable[[Any], Any]] = None,
    ) -> list:
        """All entry values whose tags match (``data_warehouse.py:116-133``)."""
        if len(tag_idxs) != len(tag_values):
            # zip would silently match on the shorter prefix — a dropped
            # constraint returns the wrong population with no signal
            raise ValueError(
                f"{len(tag_idxs)} tag_idxs but {len(tag_values)} tag_values"
            )
        out = [
            v
            for v, tags in self.entries
            if all(tags[i] == tv for i, tv in zip(tag_idxs, tag_values))
        ]
        return [score_parse(v) for v in out] if score_parse else out

    def cross_view(
        self,
        tag_idxs: Sequence[int],
        tag_values: Sequence[Sequence[Any]],
        score_parse: Optional[Callable[[Any], Any]] = None,
        to_numpy: bool = False,
        statistics: Optional[Callable[[Sequence[float]], float]] = None,
    ):
        """One view per combination in ``tag_values[0] x tag_values[1] x ...``
        (``data_warehouse.py:156-183``). As a list of views, or with
        ``to_numpy`` a ``[len(tag_values[0]), ..., max_view_len]`` NaN-padded
        array — reduced to ``[len(tag_values[0]), ...]`` when ``statistics``
        (e.g. np.mean) is given; empty cells stay NaN."""
        views = [
            self.view(tag_idxs, combo, score_parse)
            for combo in itertools.product(*tag_values)
        ]
        if not to_numpy:
            return views
        dims = [len(tv) for tv in tag_values]
        if statistics is not None:
            flat = np.full(int(np.prod(dims)), np.nan)
            for i, v in enumerate(views):
                if v:
                    flat[i] = statistics(v)
            return flat.reshape(dims)
        width = max((len(v) for v in views), default=0)
        flat = np.full((int(np.prod(dims)), width), np.nan)
        for i, v in enumerate(views):
            flat[i, : len(v)] = v
        return flat.reshape(dims + [width])
