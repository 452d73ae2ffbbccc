"""Model contract and the parameter-holding layer modules.

Counterpart of ``scl_deepfake_audio_detection_tpu/models/base.py``.  A model
is an ``nn.Module`` whose ``apply(wav, train=False)`` returns a
``ModelOutput``.  ``Linear``, ``LayerNorm`` and ``Conv1d`` hold parameters
under the JAX package's tree names (``models/params.from_jax`` relies on
that) and call the functions of ``ops/layers``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from scl_deepfake_audio_detection_torch.ops.layers import conv1d, layer_norm, linear


class ModelOutput(NamedTuple):
    log_probs: torch.Tensor  # [N, num_classes] log-softmax outputs
    feats: torch.Tensor  # [N, T, D] frame-level features (pre-activation)
    emb: torch.Tensor  # [N, D] utterance embedding
    logits: Optional[torch.Tensor] = None  # [N, num_classes] pre-softmax


class Linear(nn.Module):
    """weight [out, in], bias [out]; torch-style uniform fan-in init."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.data.uniform_(-bound, bound, generator=generator)
        self.bias.data.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None,
                fast_bwd: bool = False) -> torch.Tensor:
        return linear(x, self.weight, self.bias, compute_dtype, fast_bwd)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Conv1d(nn.Module):
    """weight [Cout, Cin/groups, K], optional bias [Cout]; torch-style
    uniform fan-in init."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int,
                 bias: bool = True, groups: int = 1):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim // groups, kernel))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1] * self.weight.shape[2])
        self.weight.data.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.data.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, stride: int = 1, padding="VALID",
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, stride=stride, padding=padding,
                      groups=self.groups, compute_dtype=compute_dtype)


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``model`` from ``generator``, module by module
    in registration order (reproducible for one seed on one device type)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Linear, LayerNorm, Conv1d)):
                m.reset_parameters(generator)
    return model


def cast_matmul_params(model: nn.Module, dtype) -> nn.Module:
    """Cast the matmul and conv weights (the JAX ``w`` leaves) to ``dtype``,
    in place; layer-norm parameters and biases stay fp32.  Every linear and
    conv casts its weight to the compute dtype anyway, so for inference this
    only removes the per-call weight converts.  Training must not use it:
    the optimizer needs fp32 master weights."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Linear, Conv1d)) and m.weight.is_floating_point():
                m.weight.data = m.weight.data.to(dtype)
    return model


def scores_from_log_probs(log_probs: torch.Tensor) -> torch.Tensor:
    """Bonafide detection score = log-prob of class 1."""
    return log_probs[..., 1]


def model_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Non-trainable state (batch-norm running stats); empty for stateless
    models such as ``LinearNLL``."""
    return dict(model.named_buffers())


def eval_scores(model: nn.Module, out: ModelOutput) -> torch.Tensor:
    """The two columns eval score files carry: log-probs for the NLL heads.
    Models with another score convention define ``eval_scores``."""
    fn = getattr(model, "eval_scores", None)
    if fn is not None:
        return fn(out)
    return out.log_probs
