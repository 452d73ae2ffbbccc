"""Carry a JAX parameter tree across to a port model.

The JAX package stores parameters as a nested dict of numpy arrays
(``train/checkpoint.load``): linear ``w`` as [in, out], conv ``w`` as
[K, Cin/groups, Cout], layer norm ``scale``/``bias``, and the encoder
layers stacked as [L, ...] leaves under ``ssl/encoder/layers``.  The port's
module tree carries the same names, so the map is per leaf: ``w`` ->
``weight`` (transposed to torch layout), ``scale`` -> ``weight``, ``b`` and
``bias`` -> ``bias``, and the stacked leaves split into
``encoder.layers.<i>``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_STACKED = ("ssl", "encoder", "layers")
_LEAF_NAMES = {"w": "weight", "scale": "weight", "b": "bias", "bias": "bias"}


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, np.asarray(tree)


def _torch_leaf(path: tuple, arr: np.ndarray) -> Tuple[str, torch.Tensor]:
    *mod, leaf = path
    if leaf not in _LEAF_NAMES:
        raise KeyError(f"unknown parameter leaf {'/'.join(path)}")
    if leaf == "w":
        # linear [in, out] -> [out, in]; conv [K, Cin/g, Cout] -> [Cout, Cin/g, K]
        arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
    key = ".".join(mod + [_LEAF_NAMES[leaf]])
    return key, torch.from_numpy(np.array(arr, copy=True))


def from_jax(tree, model: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> a state dict for ``model``.

    Raises ``KeyError`` on a missing or left-over key and ``ValueError`` on
    a shape that does not match the model."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree):
        if path[:3] == _STACKED:
            for i in range(arr.shape[0]):
                key, t = _torch_leaf(path[:3] + (str(i),) + path[3:], arr[i])
                out[key] = t
        else:
            key, t = _torch_leaf(path, arr)
            out[key] = t
    want = model.state_dict()
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise KeyError(f"JAX tree does not match the model: missing {missing[:5]}"
                       f"{'...' if len(missing) > 5 else ''}, left over "
                       f"{extra[:5]}{'...' if len(extra) > 5 else ''}")
    for k, t in out.items():
        if tuple(t.shape) != tuple(want[k].shape):
            raise ValueError(f"shape mismatch at {k}: JAX {tuple(t.shape)} vs "
                             f"model {tuple(want[k].shape)}")
    return out


def load_jax_params(model: nn.Module, tree) -> nn.Module:
    """Copy a JAX parameter tree into ``model`` (keeps its device and dtypes)."""
    model.load_state_dict(from_jax(tree, model))
    return model
