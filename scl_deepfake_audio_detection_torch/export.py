"""Scoring artifacts: a ``torch.export`` program and its weights in a
directory.

Counterpart of ``scl_deepfake_audio_detection_tpu/export.py``.
:func:`export_scorer` records the model's eval scoring function once with
``torch.export`` (a symbolic batch dimension) and writes::

    <dir>/scorer.pt2    the ExportedProgram:
                        fn(param_leaves, buffer_leaves, wav[b, cut] f32)
                        -> scores [b, C] f32
    <dir>/weights.npz   the leaves (p00000.., b00000..) of the JAX params
                        and buffers trees, in their layout and
                        ``jax.tree_util`` order, the keys, dtypes and int8
                        scheme of the JAX artifact's (the batch-norm
                        statistics, b*, never quantized); bfloat16 rides as
                        a uint16 view with its name in meta.json
    <dir>/meta.json     the JAX artifact's keys, ``torch_version`` in place
                        of ``jax_version``

:func:`load_scorer` restores a scorer from such a directory with torch,
numpy and ``ops/custom_ops`` (the registered operators the program calls)
only, no model code.

- The weights are arguments of the program, never constants: 300M
  parameters baked into it would be one 1.2 GB program.
- One program runs on the CPU and on the card.  The products whose
  formulation depends on the device (``ops/layers``, while
  ``torch.compiler.is_exporting()``) and the attention core are
  registered ops, which pick
  their implementation when they run: on the card the attention is the
  Hopper flash forward (``scl_port::flash_attn_fwd``), launched 24 times
  per XLS-R 300M forward; nothing in the program falls back to plain
  attention.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

FORMAT_VERSION = 2  # 2 adds the optional int8 weight-only storage
_EXPORT_FILE = "scorer.pt2"
_WEIGHTS_FILE = "weights.npz"
_META_FILE = "meta.json"
_JAX_EXPORT_FILE = "scorer.jaxexp"

# weight-only quantization: leaves smaller than this stay in their own
# dtype (biases, LN vectors: few bytes, and the sensitive ones)
_QUANT_MIN_SIZE = 4096


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name of the leaf's dtype ('bfloat16' for bfloat16)."""
    return str(t.dtype).removeprefix("torch.")


def _to_npz_array(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host leaf as an npz array and its dtype's name; bfloat16 as its
    uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _dtype_name(t)


def _from_npz_array(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _leaf_key(prefix: str, i: int) -> str:
    return f"{prefix}{i:05d}"


def _quantizable(t: torch.Tensor) -> bool:
    return t.dim() >= 2 and t.numel() >= _QUANT_MIN_SIZE and t.is_floating_point()


def _quantize_int8(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8: the scale reduces axis -2, the
    contraction axis of the [.., in, out] layout, so each output channel
    (of each stacked layer) gets its own step."""
    af = np.asarray(a, np.float32)
    amax = np.max(np.abs(af), axis=-2, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(af / scale), -127, 127).astype(np.int8)
    return q, scale


def _dequantize_int8(q: np.ndarray, scale: np.ndarray, dtype_name: str) -> torch.Tensor:
    return torch.from_numpy(q.astype(np.float32) * scale).to(getattr(torch, dtype_name))


# --------------------------------------------------------------------------
# export side (imports the model machinery; the loader below does not)


class _Scorer(torch.nn.Module):
    """(param leaves, buffer leaves, wav) -> eval score columns, with the
    model's parameters and buffers taken from the leaves.  The model is
    held outside the module tree, so the program has no state of its own."""

    def __init__(self, model, leaf_map, buffer_names):
        super().__init__()
        self._held = (model,)
        self._leaf_map = leaf_map
        self._buffer_names = buffer_names

    def forward(self, p_leaves, b_leaves, wav):
        from scl_deepfake_audio_detection_torch.models.base import eval_scores
        from scl_deepfake_audio_detection_torch.models.params import is_stacked, torch_layout

        model = self._held[0]
        state: Dict[str, torch.Tensor] = dict(zip(self._buffer_names, b_leaves))
        for (path, names), leaf in zip(self._leaf_map, p_leaves):
            if is_stacked(path):
                for i, name in enumerate(names):
                    state[name] = torch_layout(path, leaf[i])
            else:
                state[names[0]] = torch_layout(path, leaf)
        out = torch.func.functional_call(model, state, (wav,), {"train": False}, strict=True)
        return eval_scores(model, out)


def export_scorer(model, out_dir: str, *, cut: int = 64600,
                  platforms: Tuple[str, ...] = ("cpu", "cuda"),
                  compute_dtype: Optional[str] = "bfloat16", padding_type: str = "zero",
                  calibration: Optional[Tuple[float, float]] = None,
                  model_tag: Optional[str] = None,
                  quantize: Optional[str] = None) -> Dict[str, Any]:
    """Export ``model``'s scoring function and weights to ``out_dir``.

    The program is the eval score step (``train/engine.score_step`` without
    the PCM16 dewire): wav [b, cut] fp32 -> the model's eval score columns
    (log-probs for the NLL heads).  It is recorded on the model's device.

    ``compute_dtype``: the matmul and conv weights (the JAX ``w`` leaves)
    are cast to it once (``models/base.cast_matmul_params``), which changes
    no score and halves the weights' bytes; None keeps them as they are.

    ``quantize="int8"``: float parameter leaves with ndim >= 2 and at least
    4096 elements are stored as symmetric per-channel int8 with fp32 scales
    and dequantized to their dtype at load.  The program is the same; the
    scores move by the weights' rounding only (``--verify_export`` bounds
    it).  Returns the metadata written to ``meta.json``."""
    from scl_deepfake_audio_detection_torch import __version__
    from scl_deepfake_audio_detection_torch.models.params import (
        buffer_leaf_map,
        jax_leaf_map,
        to_jax,
    )
    from scl_deepfake_audio_detection_torch.utils.device import torch_dtype
    from scl_deepfake_audio_detection_torch.utils.tree import keyed_leaves

    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize={quantize!r} (int8 or None)")
    model = model.eval()
    device = next(model.parameters()).device
    leaf_map = jax_leaf_map(model)
    cdtype = torch_dtype(compute_dtype) if compute_dtype else None
    p_leaves = []
    for (path, _), (_, leaf) in zip(leaf_map, keyed_leaves(to_jax(model, host=False))):
        leaf = leaf.detach()
        if cdtype is not None and path.rsplit("//", 1)[-1] == "w" and leaf.is_floating_point():
            leaf = leaf.to(cdtype)
        p_leaves.append(leaf.contiguous())
    # the batch-norm statistics in the JAX buffers tree's leaf order
    b_map = buffer_leaf_map(model)
    b_leaves = [model.get_buffer(name).detach() for _, name in b_map]

    scorer = _Scorer(model, leaf_map, [name for _, name in b_map])
    wav = torch.zeros(2, cut, device=device)
    # 65535: on the card the AASIST program's trace guards the batch at a
    # CUDA grid limit of 65535, which every program keeps as its bound
    batch = torch.export.Dim("b", min=1, max=65535)
    with torch.no_grad():
        program = torch.export.export(
            scorer, (tuple(p_leaves), tuple(b_leaves), wav),
            dynamic_shapes=((None,) * len(p_leaves), (None,) * len(b_leaves), {0: batch}))
    if not any(n.target == torch.ops.scl_port.mm_f32.default for n in program.graph.nodes):
        raise RuntimeError("the recorded program holds no scl_port::mm_f32: this torch's "
                           "export did not set torch.compiler.is_exporting(), so the "
                           "program would keep the exporting device's products")
    out = next(n for n in program.graph.nodes if n.op == "output").args[0][0]
    n_cols = int(out.meta["val"].shape[1])  # from the trace: nothing ran on the device

    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    quant_scales: Dict[str, str] = {}
    for prefix, leaves in (("p", p_leaves), ("b", b_leaves)):
        for i, leaf in enumerate(leaves):
            k = _leaf_key(prefix, i)
            if quantize == "int8" and prefix == "p" and _quantizable(leaf):
                q, scale = _quantize_int8(leaf.float().cpu().numpy())
                sk = "qs" + k
                arrays[k], arrays[sk] = q, scale
                dtypes[k] = _dtype_name(leaf)  # the leaf's own dtype, for dequant
                quant_scales[k] = sk
            else:
                arrays[k], dtypes[k] = _to_npz_array(leaf)

    meta = {
        "format_version": 2 if quant_scales else 1,
        "model_tag": model_tag or type(model).__name__,
        "cut": cut,
        "padding_type": padding_type,
        "num_score_columns": n_cols,
        "score_convention": ("col 1 = bonafide score (log-prob for NLL heads, raw logit for "
                             "aasist/resnet — reference score-file convention)"),
        "platforms": list(platforms),
        "compute_dtype": compute_dtype,
        "calibration": list(calibration) if calibration else None,
        "num_param_leaves": len(p_leaves),
        "num_buffer_leaves": len(b_leaves),
        "param_bytes": int(sum(t.numel() * t.element_size() for t in p_leaves)),
        "stored_bytes": int(sum(a.nbytes for a in arrays.values())),
        "quantization": quantize if quant_scales else None,
        "quantized_leaf_scales": quant_scales,
        "leaf_dtypes": dtypes,
        "framework_version": __version__,
        "torch_version": torch.__version__,
    }
    # weights and meta first, the program last: loaders key on it
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, _WEIGHTS_FILE), "wb") as f:
        np.savez(f, **arrays)
    with open(os.path.join(out_dir, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    program.example_inputs = None  # they hold the weights: the program carries none
    torch.export.save(program, os.path.join(out_dir, _EXPORT_FILE))
    return meta


# --------------------------------------------------------------------------
# load side: torch, numpy and the registered operators only


class ExportedScorer:
    """A scoring function restored from an export directory.

    ``score(wav)`` takes fp32 [B, cut] audio (already padded as
    ``padding_type`` says) and returns the [B, C] eval score columns as
    numpy; ``score_tensor`` returns them on the device, unread.  The
    weights move to ``device`` once, at the first score: the card unless
    the caller asks for the CPU (``utils/device.resolve_device``)."""

    def __init__(self, path: str, device=None):
        from scl_deepfake_audio_detection_torch.ops import custom_ops  # noqa: F401
        from scl_deepfake_audio_detection_torch.utils.device import resolve_device

        if (os.path.exists(os.path.join(path, _JAX_EXPORT_FILE))
                and not os.path.exists(os.path.join(path, _EXPORT_FILE))):
            raise ValueError(f"{path} holds a JAX artifact ({_JAX_EXPORT_FILE}); the port "
                             f"loads the {_EXPORT_FILE} artifacts its own --export_model "
                             "writes: export it again with this package")
        with open(os.path.join(path, _META_FILE)) as f:
            self.meta = json.load(f)
        if self.meta["format_version"] > FORMAT_VERSION:
            raise ValueError(f"artifact format v{self.meta['format_version']} is newer than "
                             f"this loader (v{FORMAT_VERSION})")
        self.device = resolve_device(device)
        program = torch.export.load(os.path.join(path, _EXPORT_FILE))
        from torch.export.passes import move_to_device_pass

        self._fn = move_to_device_pass(program, self.device).module()
        dtypes = self.meta["leaf_dtypes"]
        qscales = self.meta.get("quantized_leaf_scales") or {}

        def leaf(z, k):
            if k in qscales:  # int8 weight-only storage (format 2)
                return _dequantize_int8(z[k], z[qscales[k]], dtypes[k])
            return _from_npz_array(z[k], dtypes[k])

        with np.load(os.path.join(path, _WEIGHTS_FILE)) as z:
            self._p = tuple(leaf(z, _leaf_key("p", i))
                            for i in range(self.meta["num_param_leaves"]))
            self._b = tuple(leaf(z, _leaf_key("b", i))
                            for i in range(self.meta["num_buffer_leaves"]))
        self._on_device = False

    @property
    def cut(self) -> int:
        return int(self.meta["cut"])

    @property
    def padding_type(self) -> str:
        return self.meta["padding_type"]

    @property
    def calibration(self) -> Optional[Tuple[float, float]]:
        c = self.meta.get("calibration")
        return (float(c[0]), float(c[1])) if c else None

    def score_tensor(self, wav) -> torch.Tensor:
        wav = torch.as_tensor(wav)
        if wav.dim() != 2 or wav.shape[1] != self.cut:
            raise ValueError(f"expected [B, {self.cut}] float32 audio, got {tuple(wav.shape)}")
        if not self._on_device:
            self._p = tuple(t.to(self.device) for t in self._p)
            self._b = tuple(t.to(self.device) for t in self._b)
            self._on_device = True
        with torch.inference_mode():
            wav = wav.to(self.device, torch.float32, non_blocking=True)
            return self._fn(self._p, self._b, wav)

    def score(self, wav) -> np.ndarray:
        return self.score_tensor(wav).float().cpu().numpy()


def load_scorer(path: str, device=None) -> ExportedScorer:
    """Restore an :class:`ExportedScorer` from an export directory, its
    weights bound for ``device`` (the card unless the caller asks for the
    CPU; with no card and no such request, it raises)."""
    return ExportedScorer(path, device)
