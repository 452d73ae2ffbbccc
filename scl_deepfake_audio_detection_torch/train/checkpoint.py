"""Checkpoints in the JAX package's format.

A checkpoint is one ``.npz``: arrays under ``//``-joined tree paths plus a
0-d unicode array ``__scl_meta__`` holding ``{"keys": [...], "extra":
{...}}`` as JSON, written atomically, with a ``.json`` copy of the metadata
beside it; older files keep that JSON only in the sidecar.  (Format of
``scl_deepfake_audio_detection_tpu/train/checkpoint.py``.)

A train state is the JAX package's, so each package resumes the other's:

- ``params``: the JAX tree names and layouts (``models/params.to_jax``);
- ``buffers``: the batch-norm running statistics in the JAX buffers tree
  (``models/params.buffers_to_jax``), for a model that has them;
- ``opt_state_leaves``: optax's state leaves in its own order, ``{"0": ...,
  "1": ...}``, for the chains ``train/optim.make_optimizer`` builds there
  (``inject_hyperparams(adamw)``, under ``clip_by_global_norm`` and/or
  ``MultiSteps``; the layout of optax 0.2).  With accumulation first
  ``mini_step`` and ``gradient_step``; then the step count, the six
  hyperparameters (b1, b2, eps, eps_root, learning_rate, weight_decay), the
  step count again, the first moments and the second moments, each over
  the parameters in ``jax.tree_util`` order; with accumulation last the
  running mean of the gradients.  Clipping adds no leaf;
- ``rng``: the JAX run's PRNG key data.  The port draws from
  ``torch.Generator``s, so a key cannot carry its stream across: the port
  keeps a resumed JAX state's ``rng`` leaf as it is and writes it back, and
  a run of its own writes ``jax.random.key(seed)``'s data;
- ``epoch``, ``best``, ``es_counter``, ``es_metric`` (and ``seed`` from the
  port) in the metadata.

``average_checkpoints`` and ``load_pretrained_partially`` are the JAX
package's, on numpy trees; ``load_reference_head_checkpoint`` reads a
reference ``epoch_N.pth`` (``models/convert`` maps it).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from scl_deepfake_audio_detection_torch.models.params import (
    buffers_to_jax,
    is_stacked,
    jax_layout,
    jax_leaf_map,
    load_jax_params,
    to_jax,
    torch_layout,
)
from scl_deepfake_audio_detection_torch.utils.tree import flatten, keyed_leaves, unflatten

_META_KEY = "__scl_meta__"


def _host(x) -> np.ndarray:
    """A host array of ``x`` that does not share a CPU tensor's memory, so
    that an ``AsyncWriter`` writes the state of the call."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        arr = (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
        return arr.copy() if x.device.type == "cpu" else arr
    return np.asarray(x)


def _atomic_write(path: str, write) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _write_flat(path: str, flat: Dict[str, np.ndarray],
                extra: Optional[Dict[str, Any]]) -> None:
    """The npz with its metadata inside (one atomic replace), then the
    ``.json`` copy."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    meta_json = json.dumps({"keys": sorted(flat), "extra": extra or {}})
    _atomic_write(path, lambda f: np.savez(f, **flat, **{_META_KEY: np.asarray(meta_json)}))
    _atomic_write(path + ".json", lambda f: f.write(meta_json.encode()))


def save(path: str, tree, extra: Optional[Dict[str, Any]] = None) -> None:
    """Atomically save a tree of arrays (tensors or numpy) with JSON-able
    ``extra`` metadata."""
    _write_flat(path, {k: _host(v) for k, v in flatten(tree).items()}, extra)


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
    return unflatten(flat), extra


class AsyncWriter:
    """Writes checkpoints on a background thread after the caller has copied
    them to the host, so the disk write overlaps the next epoch.  At most
    one write is in flight; a failed write raises on the next ``submit`` or
    ``wait``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, path: str, flat: Dict[str, np.ndarray],
               extra: Optional[Dict[str, Any]]) -> None:
        self.wait()

        def run():
            try:
                _write_flat(path, flat, extra)
            except BaseException as e:  # raised on the next submit or wait
                self._error = e

        self._thread = threading.Thread(target=run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def average_checkpoints(paths, out_path: Optional[str] = None):
    """Leaf-wise average of checkpoints (an SWA-style final model), as the
    JAX package's: params-only or full train states; the optimizer leaves
    (``opt_state_leaves*``) and ``rng_key`` are dropped.  Float leaves
    average in float64 and are cast back to the first file's dtype; other
    leaves take the first file's value.  Key sets and shapes must match.
    Returns ``(flat_arrays, extra)``; with ``out_path`` it also writes them."""
    if len(paths) < 2:
        raise ValueError("--average_ckpts needs at least two checkpoints")

    def keep(k: str) -> bool:
        return k != _META_KEY and k != "rng_key" and not k.startswith("opt_state_leaves")

    flats = []
    for p in paths:
        with np.load(p, allow_pickle=False) as z:
            flats.append({k: z[k] for k in z.files if keep(k)})
    base = flats[0]
    for p, f in zip(paths[1:], flats[1:]):
        if set(f) != set(base):
            missing = set(base) ^ set(f)
            raise ValueError(f"{p} has a different key set than {paths[0]} "
                             f"(differs on e.g. {sorted(missing)[:3]})")
        for k in base:
            if f[k].shape != base[k].shape:
                raise ValueError(f"shape mismatch at {k}: {paths[0]} {base[k].shape} "
                                 f"vs {p} {f[k].shape}")
    avg: Dict[str, np.ndarray] = {}
    for k in base:
        if np.issubdtype(base[k].dtype, np.floating):
            acc = np.zeros(base[k].shape, np.float64)
            for f in flats:
                acc += np.asarray(f[k], np.float64)
            avg[k] = (acc / len(flats)).astype(base[k].dtype)
        else:
            avg[k] = base[k]
    extra = {"averaged_from": [os.path.abspath(p) for p in paths]}
    if out_path:
        _write_flat(out_path, avg, extra)
    return avg, extra


# the AdamW constants of optax's adamw and of train/optim.Optimizer
_ADAM_CONSTANTS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


def seed_key_data(seed: int) -> np.ndarray:
    """The data of ``jax.random.key(seed)`` as JAX makes it by default
    (threefry, 32-bit seeds: [0, the seed's low word])."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _full_shape(model: torch.nn.Module, name: str):
    shape = model.get_parameter(name).shape
    tp = getattr(model, "tensor_parallel", None)
    return tuple(shape) if tp is None else tp.full_shape(name, shape)


def pack_opt_leaves(model: torch.nn.Module, optimizer) -> Dict[str, np.ndarray]:
    """The optimizer's state as optax's leaves, ``{str(i): leaf}`` (the
    layout is in the module docstring)."""
    arrays = optimizer.state_arrays()
    step = int(arrays["step"])

    def per_param(prefix):
        out = []
        for path, names in jax_leaf_map(model):
            layers = [jax_layout(path, _host(arrays[f"{prefix}//{n}"])
                                 if f"{prefix}//{n}" in arrays
                                 else np.zeros(_full_shape(model, n), np.float32))
                      for n in names]
            out.append(np.stack(layers) if is_stacked(path) else layers[0])
        return out

    hyper = {**_ADAM_CONSTANTS, "learning_rate": optimizer.lr,
             "weight_decay": optimizer.weight_decay}
    leaves = [np.int32(step), *(np.float32(hyper[k]) for k in sorted(hyper)),
              np.int32(step), *per_param("exp_avg"), *per_param("exp_avg_sq")]
    if optimizer.accum_steps > 1:
        leaves = [np.int32(optimizer.mini_step), np.int32(step), *leaves, *per_param("acc")]
    return {str(i): np.asarray(l) for i, l in enumerate(leaves)}


def unpack_opt_leaves(leaves, model: torch.nn.Module, optimizer) -> None:
    """Load optax's leaves (a list, or ``{str(i): leaf}``) into
    ``optimizer``; the learning rate and weight decay come from the
    checkpoint, as optax resumes its injected hyperparameters.  Raises
    ``ValueError`` when the leaves do not fit this optimizer's chain."""
    if isinstance(leaves, dict):
        leaves = [leaves[str(i)] for i in range(len(leaves))]
    leaf_map = jax_leaf_map(model)
    n_p = len(leaf_map)
    accum = optimizer.accum_steps > 1
    want = 8 + 2 * n_p + (2 + n_p if accum else 0)
    if len(leaves) != want:
        raise ValueError(f"optimizer state has {len(leaves)} leaves; this optimizer "
                         f"(grad_accum_steps={optimizer.accum_steps}) over {n_p} "
                         f"parameter leaves takes {want}")
    arrays: Dict[str, Any] = {}
    if accum:
        arrays["mini_step"] = int(leaves[0])
        leaves = leaves[2:]
    names = sorted(list(_ADAM_CONSTANTS) + ["learning_rate", "weight_decay"])
    hyper = {k: float(v) for k, v in zip(names, leaves[1:7])}
    for k, v in _ADAM_CONSTANTS.items():
        if not np.isclose(hyper[k], v, rtol=1e-6, atol=0.0):
            raise ValueError(f"optimizer state has {k}={hyper[k]}; the port's AdamW "
                             f"uses {v}")
    arrays["step"] = int(leaves[7])

    def per_param(prefix, block):
        for (path, names_), leaf in zip(leaf_map, block):
            leaf = np.asarray(leaf)
            layers = list(leaf) if is_stacked(path) else [leaf]
            for n, a in zip(names_, layers):
                arrays[f"{prefix}//{n}"] = torch_layout(path, a)

    per_param("exp_avg", leaves[8:8 + n_p])
    per_param("exp_avg_sq", leaves[8 + n_p:8 + 2 * n_p])
    if accum:
        per_param("acc", leaves[8 + 2 * n_p:])
    optimizer.load_state_arrays(arrays)
    optimizer.set_hyperparams(hyper["learning_rate"], hyper["weight_decay"])


def save_train_state(path: str, model: torch.nn.Module, optimizer, epoch: int,
                     seed: int, best: float, writer: Optional[AsyncWriter] = None,
                     es_counter: int = 0, es_metric: str = "acc", write: bool = True) -> None:
    """Everything a resume needs, in the JAX package's layout: parameters,
    the batch-norm statistics (``buffers``, where the model has them),
    optax's optimizer leaves, the ``rng`` leaf (the resumed JAX state's, or
    ``seed``'s key), epoch, the run's seed, the early-stop watermark
    ``best``, its patience counter and which metric it tracks.  The host
    copy is made here; with a ``writer`` the npz write runs on its thread.

    Over a mesh the tensor-parallel shards and the ZeRO-1 slices are
    gathered whole first (every rank calls this), and only a rank with
    ``write`` writes: the file is the one-process file, which either
    package resumes at any world size."""
    rng = optimizer.rng_key_data
    state = {"params": to_jax(model), "opt_state_leaves": pack_opt_leaves(model, optimizer),
             "rng": seed_key_data(seed) if rng is None else rng}
    if not write:
        return
    buffers = buffers_to_jax(model)
    if buffers:
        state["buffers"] = buffers
    flat = {k: _host(v) for k, v in flatten(state).items()}
    extra = {"epoch": int(epoch), "best": float(best), "es_counter": int(es_counter),
             "es_metric": str(es_metric), "seed": int(seed)}
    if writer is None:
        _write_flat(path, flat, extra)
    else:
        writer.submit(path, flat, extra)


def load_train_state(path: str, model: torch.nn.Module, optimizer):
    """Load a train state of either package into ``model`` (parameters and
    batch-norm statistics) and ``optimizer``, which keeps its ``rng`` leaf
    for the next save.  Returns (epoch, best, extra)."""
    tree, extra = load(path)
    load_jax_params(model, tree["params"], tree.get("buffers"))
    unpack_opt_leaves(tree["opt_state_leaves"], model, optimizer)
    optimizer.rng_key_data = np.asarray(tree["rng"])
    return int(extra["epoch"]), float(extra["best"]), extra


def load_pretrained_partially(params, pretrained, subtrees=None):
    """Overlay matching subtrees of a pretrained parameter tree onto
    ``params`` (NII ``f_load_pretrained_model_partially``), on nested
    dict/list trees in the JAX layout.  ``subtrees``: the top-level keys to
    take (default: every key in both).  Leaf paths and shapes must match;
    a missing leaf raises ``KeyError``, a shape ``ValueError``, naming the
    path as the JAX package does."""
    out = dict(params)
    keys = subtrees if subtrees is not None else [k for k in pretrained if k in params]
    for k in keys:
        new = dict(keyed_leaves(pretrained[k]))
        for ks, leaf in keyed_leaves(params[k]):
            if ks not in new:
                raise KeyError(f"pretrained tree missing {k}{ks}")
            if tuple(np.shape(new[ks])) != tuple(np.shape(leaf)):
                raise ValueError(f"shape mismatch at {k}{ks}: "
                                 f"{np.shape(new[ks])} vs {np.shape(leaf)}")
        out[k] = pretrained[k]
    return out


def load_reference_head_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference ``epoch_N.pth`` (a torch state dict) as a flat numpy dict
    with the ``module.``/``_orig_mod.`` prefixes stripped, as the
    reference's ``main.py`` strips them before loading.  A state dict holds
    tensors only, so nothing but tensors is unpickled."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in sd.items():
        k = k.replace("module.", "").replace("_orig_mod.", "")
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out
