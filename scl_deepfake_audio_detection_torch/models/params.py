"""Carry a JAX parameter tree across to a port model, and back.

The JAX package stores parameters as a nested dict of numpy arrays
(``train/checkpoint.load``): linear ``w`` as [in, out], conv ``w`` as
[K, Cin/groups, Cout], layer norm ``scale``/``bias``, and the encoder
layers stacked as [L, ...] leaves under ``ssl/encoder/layers``.  The port's
module tree carries the same names, so the map is per leaf: ``w`` ->
``weight`` (transposed to torch layout), ``scale`` -> ``weight``, ``b`` and
``bias`` -> ``bias``, and the stacked leaves split into
``encoder.layers.<i>``.  ``to_jax`` is the inverse, so the JAX package can
read a checkpoint the port trained.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models.base import Conv1d, LayerNorm, Linear
from scl_deepfake_audio_detection_torch.utils.tree import SEP, keyed_leaves, unflatten

_STACKED = ("encoder", "layers")  # the XLS-R layer stack, under "ssl" in a full model
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


def _stack_end(path: tuple) -> int:
    """Length of the stacked-layers prefix of ``path`` (0 if none)."""
    for i in range(len(path) - 1):
        if path[i:i + 2] == _STACKED and path[:i] in ((), ("ssl",)):
            return i + 2
    return 0


def _torch_leaf(path: tuple, arr: np.ndarray) -> Tuple[str, torch.Tensor]:
    *mod, leaf = path
    if leaf not in _LEAF_NAMES:
        raise KeyError(f"unknown parameter leaf {'/'.join(path)}")
    # linear [in, out] -> [out, in]; conv [K, Cin/g, Cout] -> [Cout, Cin/g, K]
    arr = jax_layout(leaf, arr)
    key = ".".join(mod + [_LEAF_NAMES[leaf]])
    return key, torch.from_numpy(np.array(arr, copy=True))


def from_jax(tree, model: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> a state dict for ``model``.

    Raises ``KeyError`` on a missing or left-over key and ``ValueError`` on
    a shape that does not match the model."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree):
        n = _stack_end(path)
        if n:
            for i in range(arr.shape[0]):
                key, t = _torch_leaf(path[:n] + (str(i),) + path[n:], arr[i])
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


def to_jax(model: nn.Module, host: bool = True):
    """The model's parameters as a JAX parameter tree: linear ``w`` [in,
    out], conv ``w`` [K, Cin/groups, Cout], layer norm ``scale``/``bias``,
    the encoder layers stacked into [L, ...] leaves.  Leaves are fp32 numpy
    arrays, or with ``host=False`` tensors on the model's device (shapes
    only on ``meta``)."""
    flat: Dict[tuple, object] = {}
    stacked: Dict[tuple, Dict[int, object]] = {}
    for prefix, m in model.named_modules():
        if not isinstance(m, (Linear, Conv1d, LayerNorm)):
            continue
        norm = isinstance(m, LayerNorm)
        for attr, leaf in (("weight", "scale" if norm else "w"),
                           ("bias", "bias" if norm else "b")):
            t = getattr(m, attr)
            if t is None:
                continue
            t = t.detach()
            if leaf == "w":
                t = t.t() if t.ndim == 2 else t.permute(2, 1, 0)
            arr = np.ascontiguousarray(t.float().cpu().numpy()) if host else t
            path = tuple(prefix.split(".")) + (leaf,)
            n = _stack_end(path)
            if n:
                stacked.setdefault(path[:n] + path[n + 1:], {})[int(path[n])] = arr
            else:
                flat[path] = arr
    stack = np.stack if host else torch.stack
    for path, per in stacked.items():
        flat[path] = stack([per[i] for i in range(len(per))])
    return unflatten({SEP.join(p): a for p, a in flat.items()})


def jax_leaf_map(model: nn.Module) -> List[Tuple[str, List[str]]]:
    """(``//`` path of the leaf in the JAX tree, the port parameter names it
    holds) for every leaf, in ``jax.tree_util``'s leaf order, the order of
    optax's per-parameter state.  A stacked encoder leaf names its L layers'
    parameters, layer 0 first."""
    leaves: Dict[tuple, Dict[int, str]] = {}
    for prefix, m in model.named_modules():
        if not isinstance(m, (Linear, Conv1d, LayerNorm)):
            continue
        norm = isinstance(m, LayerNorm)
        for attr, leaf in (("weight", "scale" if norm else "w"),
                           ("bias", "bias" if norm else "b")):
            if getattr(m, attr) is None:
                continue
            path = tuple(prefix.split(".")) + (leaf,)
            n = _stack_end(path)
            key, i = (path[:n] + path[n + 1:], int(path[n])) if n else (path, 0)
            leaves.setdefault(key, {})[i] = f"{prefix}.{attr}"
    by_path = {SEP.join(p): [per[i] for i in range(len(per))] for p, per in leaves.items()}
    return [(path, by_path[path])
            for _, path in keyed_leaves(unflatten({p: p for p in by_path}))]


def jax_layout(path: str, t: np.ndarray) -> np.ndarray:
    """One layer's leaf at ``path`` between torch and JAX layout (``w``
    transposed); its own inverse."""
    if path.endswith("w"):
        return t.T if t.ndim == 2 else t.transpose(2, 1, 0)
    return t


def is_stacked(path: str) -> bool:
    """Whether the JAX leaf at ``path`` stacks the encoder layers."""
    return _stack_end(tuple(path.split(SEP))) > 0
