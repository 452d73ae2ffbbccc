"""The port's operators registered with ``torch.library``.

``torch.export`` records each as one node whose implementation the
dispatcher picks by the device of its inputs when the program runs, so that
one exported program (``export.py``) scores on the CPU and on the card.
Importing this module registers them; it builds nothing.  Each has a CPU
and a CUDA kernel (plain ``Library.impl`` registrations, whose dispatch
costs a third of a ``custom_op``'s) and a fake one for symbolic batch
sizes; none has an autograd kernel, so they take tensors that need no
gradient.

- ``scl_port::flash_attn_fwd(q, k, v, kv_len) -> (O, LSE)``: on CUDA
  tensors the Hopper flash forward (``csrc/flash_attn_fwd.cu`` through
  ``_kernels.flash_attn_fwd``, which counts the launch and raises if it
  fails), on CPU tensors its plain version.  ``ops/attention``'s forward
  goes through it.
- ``scl_port::mm_f32(x, w_t) -> fp32``, ``scl_port::conv1d`` and
  ``scl_port::conv2d``: the
  device-dependent products of ``ops/layers`` (fp32 accumulation of
  compute-dtype operands), which the model calls through these ops only
  while ``torch.export`` records a program (``ops/layers``).
"""

from __future__ import annotations

import torch

from . import _kernels

_LIB = torch.library.Library("scl_port", "DEF")
_LIB.define("flash_attn_fwd(Tensor q, Tensor k, Tensor v, int? kv_len) -> (Tensor, Tensor)")
_LIB.define("mm_f32(Tensor x, Tensor w_t) -> Tensor")
_LIB.define("conv1d(Tensor x, Tensor w, Tensor? b, int stride, int pad_lo, int pad_hi, "
            "int groups, int dilation) -> Tensor")
_LIB.define("conv2d(Tensor x, Tensor w, Tensor? b, int stride_h, int stride_w, int pad_t, "
            "int pad_b, int pad_l, int pad_r) -> Tensor")


def _flash_cpu(q, k, v, kv_len):
    from .attention import flash_attention_forward_reference

    _kernels.check_flash_inputs(q, k, v, kv_len)
    return flash_attention_forward_reference(q, k, v, kv_len)


def _mm_f32(x, w_t):
    from .layers import _mm_f32

    return _mm_f32(x, w_t)


def _conv1d(x, w, b, stride, pad_lo, pad_hi, groups, dilation):
    from .layers import _conv1d

    padding = "VALID" if pad_lo == pad_hi == 0 else [(pad_lo, pad_hi)]
    return _conv1d(x, w, b, stride, padding, groups, dilation).contiguous()


def _conv2d(x, w, b, stride_h, stride_w, pad_t, pad_b, pad_l, pad_r):
    from .layers import _conv2d

    return _conv2d(x, w, b, (stride_h, stride_w), (pad_t, pad_b, pad_l, pad_r)).contiguous()


_LIB.impl("flash_attn_fwd", _kernels.flash_attn_fwd, "CUDA")
_LIB.impl("flash_attn_fwd", _flash_cpu, "CPU")
for _key in ("CPU", "CUDA"):
    _LIB.impl("mm_f32", _mm_f32, _key)
    _LIB.impl("conv1d", _conv1d, _key)
    _LIB.impl("conv2d", _conv2d, _key)


@torch.library.register_fake("scl_port::flash_attn_fwd")
def _(q, k, v, kv_len):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.register_fake("scl_port::mm_f32")
def _(x, w_t):
    return x.new_empty((x.shape[0], w_t.shape[1]), dtype=torch.float32)


@torch.library.register_fake("scl_port::conv1d")
def _(x, w, b, stride, pad_lo, pad_hi, groups, dilation):
    t_out = (x.shape[1] + pad_lo + pad_hi - dilation * (w.shape[2] - 1) - 1) // stride + 1
    return x.new_empty((x.shape[0], t_out, w.shape[0]))


@torch.library.register_fake("scl_port::conv2d")
def _(x, w, b, stride_h, stride_w, pad_t, pad_b, pad_l, pad_r):
    h_out = (x.shape[2] + pad_t + pad_b - w.shape[2]) // stride_h + 1
    w_out = (x.shape[3] + pad_l + pad_r - w.shape[3]) // stride_w + 1
    return x.new_empty((x.shape[0], w.shape[0], h_out, w_out))
