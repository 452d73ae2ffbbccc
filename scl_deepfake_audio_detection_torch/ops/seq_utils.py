"""Sequence utilities: the VITS ``commons.py`` helpers.

Counterpart of ``scl_deepfake_audio_detection_tpu/ops/seq_utils.py`` (the
reference's ``model/wav2vec2_btse/commons.py``: timing signals, segment
slicing, monotonic-alignment path expansion, Gaussian KL, value gradient
clipping), on tensors in the [B, T, C] layout of the JAX package and of
``ops/layers``; each runs on its inputs' device.

- ``rand_gumbel`` and ``rand_slice_segments`` draw from a
  ``torch.Generator`` where the JAX functions take a key: their draws are
  torch's.  Each takes its uniforms through a seam (``u=``) as well, so a
  test can feed both packages the same ones;
- ``slice_segments`` is one gather over the batch, with no Python loop over
  rows (the reference's ``commons.py:48-54`` loops);
- ``generate_path`` is the cumsum-threshold difference
  (``commons.py:128-143``);
- ``clip_grad_value`` keeps the JAX semantics, not
  ``torch.nn.utils.clip_grad_value_``'s: a pure function over a dict or
  list of gradient tensors that returns the clipped gradients and the
  pre-clip total norm, the per-leaf norms accumulated in fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from scl_deepfake_audio_detection_torch.utils.tree import keyed_leaves

_Gen = Optional[torch.Generator]


def gaussian_kl(m_p: torch.Tensor, logs_p: torch.Tensor, m_q: torch.Tensor,
                logs_q: torch.Tensor) -> torch.Tensor:
    """Elementwise KL(P||Q) between diagonal Gaussians given means and
    log-stddevs (``commons.py:30-34``)."""
    kl = (logs_q - logs_p) - 0.5
    kl = kl + 0.5 * (torch.exp(2.0 * logs_p) + (m_p - m_q) ** 2) * torch.exp(-2.0 * logs_q)
    return kl


def rand_gumbel(shape: Sequence[int], generator: _Gen = None,
                device: Union[str, torch.device, None] = None,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel samples with the reference's overflow guard: uniforms squeezed
    into [1e-5, 0.99999] before the double log (``commons.py:37-40``).
    ``u`` replaces the U(0, 1) draw."""
    if u is None:
        u = torch.rand(tuple(shape), generator=generator, device=device)
    u = u * 0.99998 + 0.00001
    return -torch.log(-torch.log(u))


def sequence_mask(length: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B, max_length] bool mask of valid positions (``commons.py:121-125``)."""
    x = torch.arange(max_length, dtype=length.dtype, device=length.device)
    return x[None, :] < length[:, None]


def subsequent_mask(length: int, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """[1, 1, T, T] causal (lower-triangular) fp32 mask
    (``commons.py:95-97``)."""
    return torch.tril(torch.ones((length, length), device=device))[None, None]


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor,
                   segment_size: int = 4) -> torch.Tensor:
    """Per-row fixed-size time slices, ``out[b] = x[b, ids_str[b]:+S]``
    (``commons.py:48-54``); x is [B, T, C].  A start past T - S is clamped
    to T - S, as ``lax.dynamic_slice`` clamps it."""
    t = x.shape[1]
    start = ids_str.long().clamp(0, max(t - segment_size, 0))
    idx = start[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def rand_slice_segments(x: torch.Tensor, x_lengths: Optional[torch.Tensor] = None,
                        segment_size: int = 4, generator: _Gen = None,
                        u: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random per-row slices, start = floor(U(0, 1) * (len - S + 1))
    (``commons.py:57-64``).  Returns (segments, int32 start indices).
    ``u`` [B] replaces the U(0, 1) draw."""
    b, t, _ = x.shape
    if x_lengths is None:
        x_lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
    ids_str_max = x_lengths - segment_size + 1
    if u is None:
        u = torch.rand((b,), generator=generator, device=x.device)
    ids_str = (u * ids_str_max).to(torch.int32)
    return slice_segments(x, ids_str, segment_size), ids_str


def get_timing_signal_1d(length: int, channels: int, min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4,
                         device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """[1, T, C] transformer sinusoid table (``commons.py:67-80``): the
    first C//2 channels sin, the next C//2 cos, an odd C zero-padded."""
    position = torch.arange(length, dtype=torch.float32, device=device)
    num_timescales = channels // 2
    log_inc = math.log(float(max_timescale) / float(min_timescale)) / (num_timescales - 1)
    inv_timescales = min_timescale * torch.exp(
        torch.arange(num_timescales, dtype=torch.float32, device=device) * -log_inc)
    scaled = position[:, None] * inv_timescales[None, :]  # [T, C//2]
    signal = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
    if channels % 2:
        signal = F.pad(signal, (0, 1))
    return signal[None]


def add_timing_signal_1d(x: torch.Tensor, min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4) -> torch.Tensor:
    """x + the sinusoid table, broadcast over the batch
    (``commons.py:83-86``)."""
    _, t, c = x.shape
    sig = get_timing_signal_1d(t, c, min_timescale, max_timescale, x.device)
    return x + sig.to(x.dtype)


def cat_timing_signal_1d(x: torch.Tensor, min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4, axis: int = -1) -> torch.Tensor:
    """The sinusoid table concatenated onto x (``commons.py:89-92``)."""
    b, t, c = x.shape
    sig = get_timing_signal_1d(t, c, min_timescale, max_timescale, x.device).to(x.dtype)
    return torch.cat([x, sig.expand(b, t, c)], dim=axis)


def shift_1d(x: torch.Tensor) -> torch.Tensor:
    """Shift right by one step along time, zero-filled (``commons.py:116-118``);
    x is [B, T, C]."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Monotonic-alignment path from integer durations (``commons.py:128-143``).

    duration: [B, T_x] per-input-token durations;
    mask:     [B, T_y, T_x] attention-domain mask;
    returns:  [B, T_y, T_x] one-hot path, path[b, y, j] = 1 iff output frame
    y is attributed to input token j."""
    t_y = mask.shape[1]
    cum = torch.cumsum(duration, dim=-1)  # [B, T_x]
    frames = torch.arange(t_y, dtype=cum.dtype, device=cum.device)
    reached = (frames[None, :, None] < cum[:, None, :]).to(mask.dtype)
    prev = F.pad(reached, (1, 0))[..., :-1]
    return (reached - prev) * mask


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def clip_grad_value(grads, clip_value: Optional[float], norm_type: float = 2.0):
    """Value-clip a dict or list tree of gradient tensors, returning
    (clipped, total_norm), where total_norm is ``(sum_leaf
    ||g_leaf||_p^p)^(1/p)`` of the *unclipped* gradients in fp32
    (``commons.py:146-161``).  ``clip_value=None`` computes the norm only.
    The gradients are not modified in place."""
    p = float(norm_type)
    total = sum(torch.sum(torch.abs(g.float()) ** p)
                for _, g in keyed_leaves(grads)) ** (1.0 / p)
    if clip_value is None:
        return grads, total
    c = float(clip_value)
    return _map(lambda g: torch.clamp(g, -c, c), grads), total


def intersperse(lst: list, item) -> list:
    """[a, b] -> [item, a, item, b, item] (``commons.py:24-27``; a host
    token-list helper)."""
    result = [item] * (len(lst) * 2 + 1)
    result[1::2] = lst
    return result
