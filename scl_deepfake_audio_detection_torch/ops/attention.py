"""Multi-head self-attention cores.

Counterpart of ``scl_deepfake_audio_detection_tpu/ops/attention.py``, with
the JAX layout: q, k, v are [B, H, T, D] and q is already scaled by
1/sqrt(D).

- ``attention_reference``: fp32 scores, keys at or beyond ``kv_len``
  masked to -inf, fp32 softmax, P cast to the V dtype before PV.
- ``flash_attention_forward``: (O, LSE) from the hand-written Hopper kernel
  (``csrc/flash_attn_fwd.cu``) for CUDA tensors, and from its plain version
  ``flash_attention_forward_reference`` for CPU tensors.  Nothing falls
  back from the card to the plain version.
- ``self_attention``: the dispatch the encoder calls.

Only the forward is ported; the backward kernels come with training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels

IMPLS = ("auto", "flash", "reference")


def _key_mask(s: torch.Tensor, kv_len: Optional[int]) -> torch.Tensor:
    if kv_len is not None and kv_len < s.shape[-1]:
        keys = torch.arange(s.shape[-1], device=s.device)
        s = s.masked_fill(keys >= kv_len, float("-inf"))
    return s


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain attention; fp32 scores and softmax, P in the V dtype."""
    s = _key_mask(torch.matmul(q.float(), k.float().transpose(-1, -2)), kv_len)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_attention_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash forward: what the kernel computes, in one
    pass over all keys.  The unnormalised P = exp(S - max) is rounded to the
    V dtype before PV, the row sum stays fp32, and O = (P V) / sum.
    Returns (O in q's dtype, LSE fp32 [B, H, T])."""
    s = _key_mask(torch.matmul(q.float(), k.float().transpose(-1, -2)), kv_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE): the Hopper kernel for CUDA tensors, the plain version for
    CPU tensors (counterpart of ``_flash_forward``)."""
    if not q.is_cuda:
        _kernels.check_flash_inputs(q, k, v, kv_len)
        return flash_attention_forward_reference(q, k, v, kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention backward not ported yet: call under "
            "torch.no_grad() or torch.inference_mode()")
    return _kernels.flash_attn_fwd(q, k, v, kv_len)


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: Optional[int] = None,
                   impl: str = "auto") -> torch.Tensor:
    """'auto' and 'flash': the flash forward (the kernel on CUDA tensors,
    its plain version on CPU tensors); 'reference': ``attention_reference``."""
    if impl in ("auto", "flash"):
        return flash_attention_forward(q, k, v, kv_len)[0]
    if impl == "reference":
        return attention_reference(q, k, v, kv_len)
    raise ValueError(f"attention impl must be one of {IMPLS}, got {impl!r}")
