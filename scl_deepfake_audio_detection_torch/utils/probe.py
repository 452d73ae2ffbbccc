"""Intermediate-tensor capture for numerics debugging.

Counterpart of ``scl_deepfake_audio_detection_tpu/utils/probe.py``, and a
capability match for ``core_scripts/other_tools/debug.py`` (``qw:44-66``,
``check_para:68-84``, ``data_probe:87-168``): grab tensors from inside a
model/pipeline, convert them to host numpy, and dump them for offline
comparison — the workflow behind "diff layer k's activations between two
builds".

Conversion handles torch tensors (on the card too: detached and copied to
the host; bf16 is widened to fp32, which numpy cannot hold), numpy and
Python scalars.  Dumps are ``.npz`` (named, compressed) rather than the
reference's pickled list, and ``DataProbe.dump`` writes the same file as
the JAX package's probe for the same captures.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from scl_deepfake_audio_detection_torch.models.params import to_jax
from scl_deepfake_audio_detection_torch.utils.tree import keyed_leaves


def to_host(data) -> np.ndarray:
    """Any tensor -> host numpy (``debug.convert_data_for_debug:23-41``):
    torch tensors (CUDA ones included), numpy and Python scalars."""
    if isinstance(data, torch.Tensor):
        data = data.detach()
        if data.dtype == torch.bfloat16:
            data = data.float()
        return data.cpu().numpy()
    return np.asarray(data)


def quick_write(data, path: str = "debug/temp.bin") -> str:
    """One-liner tensor dump as a raw little-endian float32 matrix
    (``debug.qw:44-66``); readable back with
    ``data.generic_io.read_raw_mat``.  Returns the path written."""
    from scl_deepfake_audio_detection_torch.data.generic_io import write_raw_mat

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_raw_mat(to_host(data).astype(np.float32), path)
    return path


def param_moments(params) -> Dict[str, Dict[str, float]]:
    """Per-leaf mean/std of a model's parameters — the quick sanity scan of
    ``debug.check_para:68-84``.  ``params``: an ``nn.Module`` (its
    parameters as the JAX tree, ``models/params.to_jax``) or a nested
    dict/list tree; keyed by the JAX package's ``keystr`` paths of the same
    tree, in its leaf order."""
    tree = to_jax(params) if isinstance(params, torch.nn.Module) else params
    out: Dict[str, Dict[str, float]] = {}
    for key, leaf in keyed_leaves(tree):
        arr = to_host(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        out[key] = {"mean": float(arr.mean()), "std": float(arr.std(ddof=0))}
    return out


class DataProbe:
    """Accumulate named intermediate tensors, dump once at the end
    (``debug.data_probe:87-168``).

    >>> probe = DataProbe()
    >>> probe.add(feats, name="layer3.attn_out")   # a tensor on the card is copied
    >>> probe.dump("/tmp/run_a")                   # -> /tmp/run_a.npz
    """

    def __init__(self):
        self._data: List[np.ndarray] = []
        self._names: List[str] = []

    def add(self, data, name: Optional[str] = None) -> None:
        self._data.append(to_host(data))
        self._names.append(name if name is not None else f"probe{len(self._data) - 1}")

    def __len__(self) -> int:
        return len(self._data)

    def names(self) -> List[str]:
        return list(self._names)

    def get(self, name: str) -> np.ndarray:
        return self._data[self._names.index(name)]

    def concatenated(self, axis: int = 1) -> np.ndarray:
        """Merge every capture along ``axis`` (the reference assumes
        [batch, length, dim] streams and merges along length —
        ``debug._merge_data:120-127``)."""
        return np.concatenate(self._data, axis=axis)

    def dump(self, path_prefix: str) -> str:
        """Write all captures to ``<path_prefix>.npz`` (arrays keyed by
        name; duplicate names get ``#k`` suffixes).  Returns the path."""
        os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
        keyed: Dict[str, np.ndarray] = {}
        for name, arr in zip(self._names, self._data):
            key, k = name, 1
            while key in keyed:
                key = f"{name}#{k}"
                k += 1
            keyed[key] = arr
        out = path_prefix + ".npz"
        np.savez_compressed(out, **keyed)
        return out

    def clear(self) -> None:
        self._data.clear()
        self._names.clear()
