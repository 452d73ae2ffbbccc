"""Checkpoints in the JAX package's format.

A checkpoint is one ``.npz``: arrays under ``//``-joined tree paths plus a
0-d unicode array ``__scl_meta__`` holding ``{"keys": [...], "extra":
{...}}`` as JSON, written atomically, with a ``.json`` copy of the metadata
beside it; older files keep that JSON only in the sidecar.  (Format of
``scl_deepfake_audio_detection_tpu/train/checkpoint.py``.)

A train state keeps the parameters under ``params`` in the JAX tree names
and layouts (``models/params.to_jax``), so the JAX package reads a
port-trained model, and the optimizer under the port's own ``opt`` keys
(``train/optim.Optimizer.state_arrays``: torch layout, keyed by parameter
name); ``epoch``, ``best``, ``es_counter``, ``es_metric`` and ``seed`` go
in the metadata.  Reading the optimizer moments of a JAX checkpoint is not
ported yet.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from scl_deepfake_audio_detection_torch.models.params import load_jax_params, to_jax
from scl_deepfake_audio_detection_torch.utils.tree import flatten, unflatten

_META_KEY = "__scl_meta__"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
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


def save_train_state(path: str, model: torch.nn.Module, optimizer, epoch: int,
                     seed: int, best: float, writer: Optional[AsyncWriter] = None,
                     es_counter: int = 0, es_metric: str = "acc") -> None:
    """Everything a resume needs: parameters (JAX tree), optimizer state,
    epoch, the run's seed, the early-stop watermark ``best``, its patience
    counter and which metric it tracks.  The host copy is made here; with a
    ``writer`` the npz write runs on its thread."""
    state = {"params": to_jax(model), "opt": optimizer.state_arrays()}
    flat = {k: _host(v) for k, v in flatten(state).items()}
    extra = {"epoch": int(epoch), "best": float(best), "es_counter": int(es_counter),
             "es_metric": str(es_metric), "seed": int(seed)}
    if writer is None:
        _write_flat(path, flat, extra)
    else:
        writer.submit(path, flat, extra)


def load_train_state(path: str, model: torch.nn.Module, optimizer):
    """Load a train state into ``model`` and ``optimizer``.  Returns
    (epoch, best, extra)."""
    tree, extra = load(path)
    load_jax_params(model, tree["params"])
    optimizer.load_state_arrays(flatten(tree["opt"]))
    return int(extra["epoch"]), float(extra["best"]), extra
