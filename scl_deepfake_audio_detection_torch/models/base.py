"""Model contract and the parameter-holding layer modules.

Counterpart of ``scl_deepfake_audio_detection_tpu/models/base.py``.  A model
is an ``nn.Module`` whose ``apply(wav, train=False)`` returns a
``ModelOutput``.  ``Linear``, ``LayerNorm``, ``Conv1d``, ``Conv2d`` and
``BatchNorm`` hold parameters under the JAX package's tree names
(``models/params.from_jax`` relies on that) and call the functions of
``ops/layers``.  ``BatchNorm`` also holds its running statistics, the
buffers ``mean`` and ``var`` of the JAX package's separate ``buffers``
tree; it is not ``nn.BatchNorm2d``, whose ``num_batches_tracked`` the JAX
tree has no leaf for.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from scl_deepfake_audio_detection_torch.ops.layers import (
    batch_norm,
    conv1d,
    conv2d,
    layer_norm,
    linear,
)


class ModelOutput(NamedTuple):
    log_probs: torch.Tensor  # [N, num_classes] log-softmax outputs
    feats: torch.Tensor  # [N, T, D] frame-level features (pre-activation)
    emb: torch.Tensor  # [N, D] utterance embedding
    logits: Optional[torch.Tensor] = None  # [N, num_classes] pre-softmax


class Initialised(nn.Module):
    """A module that fills its own parameters from a ``torch.Generator``
    (``reset_parameters``); ``init_parameters`` visits every one."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError


class Linear(Initialised):
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


class LayerNorm(Initialised):
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


class Conv1d(Initialised):
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


class Conv2d(Initialised):
    """weight [Cout, Cin, KH, KW] (the JAX kernel is [KH, KW, Cin, Cout]),
    optional bias [Cout]; torch-style uniform fan-in init."""

    def __init__(self, in_dim: int, out_dim: int, kernel, bias: bool = True):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.data.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.data.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, stride=(1, 1), padding="VALID",
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, stride=stride, padding=padding,
                      compute_dtype=compute_dtype)


class BatchNorm(Initialised):
    """Affine batch norm over the channel axis 1: parameters ``weight`` and
    ``bias`` (the JAX ``scale`` and ``bias``), fp32 running statistics in
    the buffers ``mean`` (zeros) and ``var`` (ones), which a training
    forward moves in place (``ops/layers.batch_norm``)."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.register_buffer("mean", torch.zeros(dim, dtype=torch.float32))
        self.register_buffer("var", torch.ones(dim, dtype=torch.float32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def reset_buffers(self) -> None:
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return batch_norm(x, self.weight, self.bias, self.mean, self.var, train,
                          self.eps, self.momentum)


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``model`` from ``generator``, module by module
    in registration order (reproducible for one seed on one device type),
    and set the batch-norm statistics to their initial values."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Initialised):
                m.reset_parameters(generator)
        reset_buffers(model)
    return model


def reset_buffers(model: nn.Module) -> nn.Module:
    """Every batch-norm running statistic of ``model`` to its initial value
    (mean 0, var 1), as the JAX package's ``init_buffers`` makes them."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.reset_buffers()
    return model


def cast_matmul_params(model: nn.Module, dtype) -> nn.Module:
    """Cast the matmul and conv weights (the JAX ``w`` leaves) to ``dtype``,
    in place; layer-norm and batch-norm parameters, the batch-norm
    statistics, biases and the other parameters (graph attention vectors,
    master nodes) stay fp32.  Every linear and
    conv casts its weight to the compute dtype anyway, so for inference this
    only removes the per-call weight converts.  Training must not use it:
    the optimizer needs fp32 master weights."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Linear, Conv1d, Conv2d)) and m.weight.is_floating_point():
                m.weight.data = m.weight.data.to(dtype)
    return model


def scores_from_log_probs(log_probs: torch.Tensor) -> torch.Tensor:
    """Bonafide detection score = log-prob of class 1."""
    return log_probs[..., 1]


def model_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Non-trainable state (batch-norm running stats) by parameter name;
    empty for stateless models such as ``LinearNLL``."""
    return dict(model.named_buffers())


def eval_scores(model: nn.Module, out: ModelOutput) -> torch.Tensor:
    """The two columns eval score files carry: log-probs for the NLL heads;
    the AASIST and ResNet heads define ``eval_scores`` (raw logits)."""
    fn = getattr(model, "eval_scores", None)
    if fn is not None:
        return fn(out)
    return out.log_probs
