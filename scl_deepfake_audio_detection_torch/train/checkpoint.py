"""Read the JAX package's ``.ckpt`` checkpoints with numpy alone.

A checkpoint is one ``.npz``: arrays under ``//``-joined tree paths plus a
0-d unicode array ``__scl_meta__`` holding ``{"keys": [...], "extra":
{...}}`` as JSON; older files keep that JSON in a ``.json`` sidecar.
(Format of ``scl_deepfake_audio_detection_tpu/train/checkpoint.py``.)
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

_SEP = "//"
_META_KEY = "__scl_meta__"


def _unflatten_dicts(flat: Dict[str, Any]):
    """Nested dicts from ``//`` paths; integer components become list
    indices when they run contiguously from 0."""
    nested: dict = {}
    for key, v in flat.items():
        d = nested
        *parents, last = key.split(_SEP)
        for k in parents:
            d = d.setdefault(k, {})
        d[last] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx == list(range(len(idx))):
                return [node[str(i)] for i in idx]
        return node

    return listify(nested)


def load(path: str) -> Tuple[Any, Dict[str, Any]]:
    """-> (tree of numpy arrays, extra metadata)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    extra: Dict[str, Any] = {}
    embedded = flat.pop(_META_KEY, None)
    if embedded is not None:
        extra = json.loads(str(embedded)).get("extra", {})
    elif os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            extra = json.load(f).get("extra", {})
    return _unflatten_dicts(flat), extra
