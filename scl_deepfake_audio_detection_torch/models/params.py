"""Carry a JAX parameter tree (and buffers tree) across to a port model,
and back.

The JAX package stores parameters as a nested dict of numpy arrays
(``train/checkpoint.load``): linear ``w`` as [in, out], conv1d ``w`` as
[K, Cin/groups, Cout], conv2d ``w`` as [KH, KW, Cin, Cout], layer norm and
batch norm ``scale``/``bias``, other parameters (graph attention vectors,
master nodes, position embeddings) as they are, and the encoder layers
stacked as [L, ...] leaves under ``ssl/encoder/layers``.  Batch-norm
running statistics live in a separate ``buffers`` tree with ``mean`` and
``var`` leaves at the norm's path.  The port's module tree carries the same
names, so the map is per leaf: ``w`` -> ``weight`` (in torch layout),
``scale`` -> ``weight``, ``b`` and ``bias`` -> ``bias``, any other leaf
under its own name, buffers under their own names, and the stacked leaves
split into ``encoder.layers.<i>``.  ``to_jax`` and ``buffers_to_jax`` are
the inverse, so the JAX package can read a checkpoint the port trained.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models.base import (
    BatchNorm,
    Conv1d,
    Conv2d,
    LayerNorm,
    Linear,
    reset_buffers,
)
from scl_deepfake_audio_detection_torch.utils.tree import SEP, keyed_leaves, unflatten

_STACKED = ("encoder", "layers")  # the XLS-R layer stack, under "ssl" in a full model
_LEAF_NAMES = {"w": "weight", "scale": "weight", "b": "bias", "bias": "bias"}
# the JAX names of (weight, bias) of each parameter-holding module
_MODULE_LEAVES = {Linear: ("w", "b"), Conv1d: ("w", "b"), Conv2d: ("w", "b"),
                  LayerNorm: ("scale", "bias"), BatchNorm: ("scale", "bias")}
# kernel axes: torch -> JAX and JAX -> torch, by rank (linear, conv1d, conv2d)
_TO_JAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}
_TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


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


def _permute(t, axes):
    return t.permute(*axes) if isinstance(t, torch.Tensor) else np.transpose(t, axes)


def _is_kernel(path: str) -> bool:
    return path.rsplit(SEP, 1)[-1] == "w"


def jax_layout(path: str, t):
    """One layer's leaf at ``path`` (a ``//`` path or the leaf name) from
    torch layout to JAX layout: kernels ``w`` transposed, the rest as is.
    Takes numpy arrays and tensors."""
    return _permute(t, _TO_JAX[t.ndim]) if _is_kernel(path) and t.ndim in _TO_JAX else t


def torch_layout(path: str, t):
    """The inverse of ``jax_layout``: one layer's leaf in JAX layout to torch
    layout."""
    return _permute(t, _TO_TORCH[t.ndim]) if _is_kernel(path) and t.ndim in _TO_TORCH else t


def _torch_leaf(path: tuple, arr: np.ndarray) -> Tuple[str, torch.Tensor]:
    *mod, leaf = path
    arr = torch_layout(leaf, arr)
    key = ".".join(mod + [_LEAF_NAMES.get(leaf, leaf)])
    return key, torch.from_numpy(np.array(arr, copy=True))


def _param_leaves(model: nn.Module) -> Iterator[Tuple[str, tuple, torch.Tensor]]:
    """(port parameter name, JAX leaf path, parameter) of every parameter."""
    for prefix, m in model.named_modules():
        names = _MODULE_LEAVES.get(type(m))
        for attr, p in m.named_parameters(recurse=False):
            leaf = attr if names is None else names[0 if attr == "weight" else 1]
            mod = tuple(prefix.split(".")) if prefix else ()
            yield (f"{prefix}.{attr}" if prefix else attr), mod + (leaf,), p


def from_jax(tree, model: nn.Module, buffers=None) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves), and optionally its buffers tree,
    -> a state dict for ``model``; without ``buffers`` it holds the
    parameters only.

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
    want = {k: p for k, p in model.named_parameters()}
    if buffers is not None:
        for path, arr in _leaves(buffers):
            out[".".join(path)] = torch.from_numpy(np.array(arr, np.float32, copy=True))
        want.update(model.named_buffers())
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


def load_jax_params(model: nn.Module, tree, buffers=None) -> nn.Module:
    """Copy a JAX parameter tree, and its buffers tree, into ``model``
    (keeps its device and dtypes).  Without ``buffers`` the batch-norm
    statistics go to their initial values, as the JAX package starts a
    model whose checkpoint holds none."""
    sd = from_jax(tree, model, buffers)
    model.load_state_dict(sd, strict=buffers is not None or not dict(model.named_buffers()))
    if buffers is None:
        reset_buffers(model)
    return model


def _host_or_device(t: torch.Tensor, host: bool):
    t = t.detach()
    return np.ascontiguousarray(t.float().cpu().numpy()) if host else t


def to_jax(model: nn.Module, host: bool = True):
    """The model's parameters as a JAX parameter tree: kernels ``w`` in JAX
    layout, norm ``scale``/``bias``, other parameters as they are, the
    encoder layers stacked into [L, ...] leaves.  Leaves are fp32 numpy
    arrays, or with ``host=False`` tensors on the model's device (shapes
    only on ``meta``)."""
    flat: Dict[tuple, object] = {}
    stacked: Dict[tuple, Dict[int, object]] = {}
    for _, path, p in _param_leaves(model):
        arr = _host_or_device(jax_layout(path[-1], p.detach()), host)
        n = _stack_end(path)
        if n:
            stacked.setdefault(path[:n] + path[n + 1:], {})[int(path[n])] = arr
        else:
            flat[path] = arr
    stack = np.stack if host else torch.stack
    for path, per in stacked.items():
        flat[path] = stack([per[i] for i in range(len(per))])
    return unflatten({SEP.join(p): a for p, a in flat.items()})


def buffers_to_jax(model: nn.Module, host: bool = True):
    """The model's batch-norm statistics as the JAX package's buffers tree
    (``mean``/``var`` at each norm's path); ``{}`` for a model without."""
    flat = {name.replace(".", SEP): _host_or_device(b, host)
            for name, b in model.named_buffers()}
    return unflatten(flat) if flat else {}


def jax_leaf_map(model: nn.Module) -> List[Tuple[str, List[str]]]:
    """(``//`` path of the leaf in the JAX tree, the port parameter names it
    holds) for every leaf, in ``jax.tree_util``'s leaf order, the order of
    optax's per-parameter state.  A stacked encoder leaf names its L layers'
    parameters, layer 0 first."""
    leaves: Dict[tuple, Dict[int, str]] = {}
    for name, path, _ in _param_leaves(model):
        n = _stack_end(path)
        key, i = (path[:n] + path[n + 1:], int(path[n])) if n else (path, 0)
        leaves.setdefault(key, {})[i] = name
    by_path = {SEP.join(p): [per[i] for i in range(len(per))] for p, per in leaves.items()}
    return [(path, by_path[path])
            for _, path in keyed_leaves(unflatten({p: p for p in by_path}))]


def buffer_leaf_map(model: nn.Module) -> List[Tuple[str, str]]:
    """(``//`` path in the JAX buffers tree, the port buffer name) for every
    batch-norm statistic, in ``jax.tree_util``'s leaf order."""
    by_path = {name.replace(".", SEP): name for name, _ in model.named_buffers()}
    if not by_path:
        return []
    return [(path, by_path[path])
            for _, path in keyed_leaves(unflatten({p: p for p in by_path}))]


def is_stacked(path: str) -> bool:
    """Whether the JAX leaf at ``path`` stacks the encoder layers."""
    return _stack_end(tuple(path.split(SEP))) > 0
