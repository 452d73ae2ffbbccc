"""Layer primitives on tensors, with the JAX package's dtype policy.

Counterpart of ``scl_deepfake_audio_detection_tpu/ops/layers.py``.
Activations are [B, T, C].  Weights are in torch layout: linear
[out, in], conv [Cout, Cin/groups, K] (``models/params.from_jax`` converts
the JAX [in, out] and [K, Cin/groups, Cout] leaves once, at load).

- ``linear`` casts x and w to the compute dtype, accumulates in fp32,
  returns fp32 and adds the bias in fp32;
- ``layer_norm`` computes in fp32 and returns the input dtype;
- ``conv1d`` returns the operand dtype;
- ``gelu`` is exact (erf) unless ``approximate`` selects the tanh form.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def dewire_pcm16(x: torch.Tensor) -> torch.Tensor:
    """Inverse of the int16 PCM wire format (``utils.audio_io.pcm16_encode``):
    int16 rescales to fp32, anything else passes through."""
    return x.float() / 32768.0 if x.dtype == torch.int16 else x


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def dropout(x: torch.Tensor, rate: float, train: bool = False) -> torch.Tensor:
    """Identity at eval.  Training dropout comes with the training slice."""
    if train and rate > 0.0:
        raise NotImplementedError("dropout in training not ported yet")
    return x


def _matmul_fp32(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """x [N, in] @ w_t [in, out] with fp32 accumulation and an fp32 result.
    CUDA reads bf16 operands directly (``out_dtype``); the CPU upcasts,
    which gives the same exact products."""
    if x.is_cuda and x.dtype != torch.float32:
        return torch.mm(x, w_t, out_dtype=torch.float32)
    return torch.mm(x.float(), w_t.float())


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [..., in], w [out, in] -> fp32 [..., out]."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = _matmul_fp32(x.reshape(-1, x.shape[-1]), w.t())
    y = y.reshape(*x.shape[:-1], w.shape[0])
    return y if b is None else y + b.float()


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 layer norm over the last axis; returns x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


Padding = Union[str, Sequence[Tuple[int, int]]]


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: Padding = "VALID", groups: int = 1,
           dilation: int = 1,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [B, T, Cin], w [Cout, Cin/groups, K] -> [B, T', Cout] in the operand
    dtype.  ``padding`` is 'VALID' or [(lo, hi)]; the bias is added in the
    operand dtype."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    xc = x.transpose(1, 2)
    if padding != "VALID":
        (lo, hi), = padding
        xc = F.pad(xc, (lo, hi))
    bias = None if b is None else b.to(x.dtype)
    if not x.is_cuda and x.dtype != torch.float32:
        # The CPU computes the low-precision conv in fp32 (exact products,
        # fp32 sums, one rounding): torch's CPU bf16 grouped conv1d returns
        # wrong values (off by whole units at groups=4 in torch 2.13).
        y = F.conv1d(xc.float(), w.float(), None if bias is None else bias.float(),
                     stride=stride, groups=groups, dilation=dilation).to(x.dtype)
    else:
        y = F.conv1d(xc, w, bias, stride=stride, groups=groups, dilation=dilation)
    return y.transpose(1, 2)
