"""Per-card memory estimate for XLS-R training layouts.

Counterpart of ``scl_deepfake_audio_detection_tpu/parallel/memory.py``, with
the same analytic sums (``tests/test_torch_parallel.py`` holds them to the
JAX package's): what one train step of XLS-R and a small head keeps live on
one card under AdamW.

- master parameters, fp32; the attention and FFN matmuls split 1/tp;
- gradients, fp32, split alike;
- AdamW's two moments, divided by the data ranks under ZeRO-1;
- the activations the backward keeps across the encoder: the layer inputs,
  plus the kept tensors of the remat policy ('attn': ``attn_out``;
  'attn_ffn': and ``ffn_act``; none: every matmul operand and output and
  the [N, H, T, T] scores);
- one layer's working set while it is recomputed (counted with the [N, H,
  T, T] fp32 scores of a plain attention, which the flash kernels never
  hold: the sum stays an upper bound there);
- the conv feature encoder's activations, counted twice.

The analytic sum is not what the allocator holds: cuBLAS and cuDNN
workspaces, the caching allocator's blocks and the temporaries of each op
come on top.  ``overhead`` is the ratio of the card's measured peak to the
sum on one configuration: the conf-3 step of ``chip_smoke.py``'s
``phase_remat`` ('attn', XLS-R 300M + LinearNLL, [2, 11, 64000] bf16,
the second step's ``torch.cuda.max_memory_allocated``), which
``chip_smoke.py`` prints as ``[memory]`` after ``phase_remat``.  The
capacity is the card's own (``torch.cuda.get_device_properties``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# measured peak / analytic sum of the conf-3 'attn' step: 7.268 GiB over
# 6.285 GiB on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's [memory]
# line, after phase_remat)
H100_OVERHEAD = 1.1564


@dataclasses.dataclass
class MemoryEstimate:
    params_gb: float
    grads_gb: float
    opt_gb: float
    saved_acts_gb: float
    transient_gb: float
    conv_acts_gb: float
    overhead: float = H100_OVERHEAD

    @property
    def analytic_gb(self) -> float:
        return (self.params_gb + self.grads_gb + self.opt_gb
                + self.saved_acts_gb + self.transient_gb + self.conv_acts_gb)

    @property
    def total_gb(self) -> float:
        return self.analytic_gb * self.overhead

    def __str__(self) -> str:
        return (f"~{self.total_gb:.2f} GB/card (analytic {self.analytic_gb:.2f} x "
                f"{self.overhead} measured overhead; params {self.params_gb:.2f} + grads "
                f"{self.grads_gb:.2f} + opt {self.opt_gb:.2f} + saved acts "
                f"{self.saved_acts_gb:.2f} + transient {self.transient_gb:.2f} + conv "
                f"{self.conv_acts_gb:.2f})")


def param_count(cfg) -> int:
    """Exact parameter count of the XLS-R frontend of ``cfg``, from its
    modules on the ``meta`` device (nothing allocated)."""
    import torch

    from scl_deepfake_audio_detection_torch.models.xlsr import XLSR

    with torch.device("meta"):
        model = XLSR(cfg)
    return sum(p.numel() for p in model.parameters())


def estimate_train_memory(cfg, batch: int, num_samples: int, dp: int = 1, tp: int = 1,
                          zero1: bool = False, head_params: int = 0,
                          overhead: float = H100_OVERHEAD) -> MemoryEstimate:
    """Per-card memory of one train step of XLS-R + a small head.

    ``batch``: views on this card (G*V after the data split); ``dp``/``tp``:
    the mesh; ZeRO-1 divides the moments by ``dp``.  The tp split applies to
    the attention and FFN matmul weights (``parallel/mesh`` rules); norms
    and convs stay whole."""
    gb = 1 / (1 << 30)
    L, d, f, h = cfg.encoder_layers, cfg.encoder_dim, cfg.ffn_dim, cfg.num_heads
    t = cfg.num_frames(num_samples)
    n = batch
    act = 2 if cfg.compute_dtype == "bfloat16" else 4

    total_p = param_count(cfg) + head_params
    sharded_p = L * (4 * d * d + 2 * d * f)
    local_p = total_p - sharded_p + sharded_p // tp

    params_b = 4 * local_p
    grads_b = 4 * local_p
    opt_b = 2 * 4 * local_p // (dp if zero1 else 1)

    layer_in = L * n * t * d * act
    if not cfg.remat:
        saved = L * n * t * (4 * d + 2 * f + 2 * d) * act + L * n * h * t * t * 4
    elif cfg.remat_policy == "attn_ffn":
        saved = layer_in + L * n * t * (d + f) * act
    elif cfg.remat_policy == "attn":
        saved = layer_in + L * n * t * d * act
    else:  # 'full' and 'dots' keep at least the layer inputs
        saved = layer_in

    transient = n * h * t * t * 4 + n * t * f * act + 4 * n * t * d * act

    conv_b = 0
    length = num_samples
    for ch, k, s in cfg.conv_layers:
        length = (length - k) // s + 1
        conv_b += n * length * ch * act
    conv_b *= 2

    return MemoryEstimate(params_gb=params_b * gb, grads_gb=grads_b * gb, opt_gb=opt_b * gb,
                          saved_acts_gb=saved * gb, transient_gb=transient * gb,
                          conv_acts_gb=conv_b * gb, overhead=overhead)


def card_capacity_gb(device=None) -> float:
    """The card's memory in GiB (``torch.cuda.get_device_properties``)."""
    import torch

    return torch.cuda.get_device_properties(device or 0).total_memory / (1 << 30)


def fits(estimate: MemoryEstimate, capacity_gb: Optional[float] = None) -> bool:
    """Whether the estimate fits the card (``capacity_gb``, default the
    current card's)."""
    cap = card_capacity_gb() if capacity_gb is None else capacity_gb
    return bool(np.isfinite(estimate.total_gb) and estimate.total_gb <= cap)
