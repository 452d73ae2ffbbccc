"""Multi-head self-attention cores.

Counterpart of ``scl_deepfake_audio_detection_tpu/ops/attention.py``, with
the JAX layout: q, k, v are [B, H, T, D] and q is already scaled by
1/sqrt(D).

- ``attention_reference``: fp32 scores, keys at or beyond ``kv_len``
  masked to -inf, fp32 softmax, P cast to the V dtype before PV.
- ``flash_attention_forward``: (O, LSE) from the hand-written Hopper kernel
  (``csrc/flash_attn_fwd.cu``) for CUDA tensors, and from its plain version
  ``flash_attention_forward_reference`` for CPU tensors, through the
  registered op ``scl_port::flash_attn_fwd`` (``ops/custom_ops``).
- ``flash_attention_backward``: (dq, dk, dv) from the two hand-written
  Hopper kernels (``csrc/flash_attn_bwd.cu``; the dq kernel also computes
  D = rowsum(dO * O), which dk/dv reads) for CUDA tensors, and from their
  plain versions for CPU tensors.
- ``flash_attention``: the differentiable flash core (``FlashAttention``),
  counterpart of the JAX ``custom_vjp``.
- ``self_attention``: the dispatch the encoder calls.

Nothing falls back from the card to a plain version: a kernel that does not
build or launch raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels, custom_ops  # noqa: F401  (custom_ops registers the op)

IMPLS = ("auto", "flash", "reference")


def _key_mask(s: torch.Tensor, kv_len: Optional[int]) -> torch.Tensor:
    if kv_len is not None and kv_len < s.shape[-1]:
        keys = torch.arange(s.shape[-1], device=s.device)
        s = s.masked_fill(keys >= kv_len, float("-inf"))
    return s


def _scores(q: torch.Tensor, k: torch.Tensor, kv_len: Optional[int]) -> torch.Tensor:
    return _key_mask(torch.matmul(q.float(), k.float().transpose(-1, -2)), kv_len)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain attention; fp32 scores and softmax, P in the V dtype."""
    p = torch.softmax(_scores(q, k, kv_len), dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_attention_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash forward: what the kernel computes, in one
    pass over all keys.  The unnormalised P = exp(S - max) is rounded to the
    V dtype before PV, the row sum stays fp32, and O = (P V) / sum.
    Returns (O in q's dtype, LSE fp32 [B, H, T])."""
    s = _scores(q, k, kv_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs(q, k, lse, kv_len) -> torch.Tensor:
    """P = exp(S - L) in fp32 from the forward's LSE; masked keys give 0."""
    return torch.exp(_scores(q, k, kv_len) - lse.unsqueeze(-1))


def flash_bwd_dq_reference(q, k, v, do, lse, delta, kv_len=None) -> torch.Tensor:
    """Plain version of the dq kernel (``_flash_bwd_dq_kernel``):
    dS = P * (dO V^T - D) rounded to K's dtype, dq = dS K in fp32, returned
    in q's dtype."""
    p = _probs(q, k, lse, kv_len)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta.unsqueeze(-1))).to(k.dtype)
    return torch.matmul(ds.float(), k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, kv_len=None):
    """Plain version of the dk/dv kernel (``_flash_bwd_dkv_kernel``):
    dV = P^T dO with P^T in dO's dtype, dK = dS^T Q with dS^T in q's dtype,
    both accumulated in fp32.  Returns (dk in k's dtype, dv in v's dtype)."""
    p = _probs(q, k, lse, kv_len)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta.unsqueeze(-1))
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32 [B, H, T]."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_bwd_dq_delta_reference(q, k, v, o, do, lse, kv_len=None):
    """Plain version of the dq kernel's contract (``flash_attn_bwd_dq``):
    D = rowsum(dO * O) from the O the forward returned, then
    ``flash_bwd_dq_reference``.  Returns (dq in q's dtype, D fp32 [B, H, T])."""
    delta = _delta(o, do)
    return flash_bwd_dq_reference(q, k, v, do, lse, delta, kv_len), delta


def flash_attention_backward_reference(q, k, v, o, lse, do, kv_len=None):
    """Plain version of ``_flash_backward``: dq and D, then dk and dv from
    that D, each through its kernel's plain version."""
    dq, delta = flash_bwd_dq_delta_reference(q, k, v, o, do, lse, kv_len)
    return (dq, *flash_bwd_dkv_reference(q, k, v, do, lse, delta, kv_len))


def _flash_forward(q, k, v, kv_len):
    """(O, LSE) for the autograd Function: the kernel or the plain version,
    called directly (no registered op), as the train step has always run
    it."""
    if not q.is_cuda:
        _kernels.check_flash_inputs(q, k, v, kv_len)
        return flash_attention_forward_reference(q, k, v, kv_len)
    return _kernels.flash_attn_fwd(q, k, v, kv_len)


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE), not differentiable, through the registered op
    ``scl_port::flash_attn_fwd`` (``ops/custom_ops``): the Hopper kernel
    for CUDA tensors, the plain version for CPU tensors (counterpart of
    ``_flash_forward``).  ``torch.export`` records the op, so an exported
    scorer launches the kernel too.  ``flash_attention`` gives gradients."""
    kv = None if kv_len is None else int(kv_len)
    return torch.ops.scl_port.flash_attn_fwd(q.detach(), k.detach(), v.detach(), kv)


def flash_attention_backward(q, k, v, o, lse, do, kv_len=None):
    """(dq, dk, dv): for CUDA tensors the two Hopper kernels, dq first, which
    also computes D = rowsum(dO * O), then dk/dv, which reads that D, on the
    same stream; the plain versions for CPU tensors (counterpart of
    ``_flash_backward``).  O is the forward's output as saved, contiguous:
    the kernel raises on anything else."""
    do = do.contiguous()
    if not q.is_cuda:
        return flash_attention_backward_reference(q, k, v, o, lse, do, kv_len)
    dq, delta = _kernels.flash_attn_bwd_dq(q, k, v, o, do, lse, kv_len)
    return (dq, *_kernels.flash_attn_bwd_dkv(q, k, v, do, lse, delta, kv_len))


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward: the forward keeps q, k, v, O
    and LSE; the backward recomputes P blockwise, so no [T, T] tensor is
    kept or made on the card."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len):
        o, lse = _flash_forward(q, k, v, kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kv_len = kv_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, o, lse, do, ctx.kv_len), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Differentiable flash attention: the kernels on CUDA tensors, their
    plain versions on CPU tensors.  Without a gradient to record it is the
    forward alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, kv_len)
    return flash_attention_forward(q, k, v, kv_len)[0]


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: Optional[int] = None,
                   impl: str = "auto") -> torch.Tensor:
    """'auto' and 'flash': ``flash_attention`` (the kernels on CUDA tensors,
    their plain versions on CPU tensors); 'reference': ``attention_reference``."""
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, kv_len)
    if impl == "reference":
        return attention_reference(q, k, v, kv_len)
    raise ValueError(f"attention impl must be one of {IMPLS}, got {impl!r}")
