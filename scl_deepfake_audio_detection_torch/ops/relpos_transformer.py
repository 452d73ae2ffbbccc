"""Post-norm transformer encoder with windowed relative-position attention.

Counterpart of ``scl_deepfake_audio_detection_tpu/ops/relpos_transformer.py``,
the BTSE bio encoder's transformer: per layer, q/k/v/o linears, relative
key and value tables of 2 * window + 1 rows shared by the heads, a ReLU FFN,
post-norm residuals.  The modules carry the JAX leaf names (``layers.<i>``
with ``q``, ``k``, ``v``, ``o``, ``rel_k``, ``rel_v``, ``ln1``, ``fc1``,
``fc2``, ``ln2``).

As the JAX encoder: the attention is plain products in fp32 (``linear``
and ``torch.einsum``), not the flash kernel and not sdpa, since it adds
relative-key logits and relative-value outputs and fills masked logits
with -1e4 (not -inf: a row with no valid key stays finite); layer norm is
fp32; the inputs and outputs are multiplied by the mask.  The encoder's
dropout rate is 0 in BTSE, so it has none.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from scl_deepfake_audio_detection_torch.models.base import Initialised, LayerNorm, Linear


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2L-1] relative logits -> [B, H, L, L] absolute."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, L] absolute weights -> [B, H, L, 2L-1] relative."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
    return x[:, :, :, 1:]


def _window_embeddings(rel: torch.Tensor, length: int, window: int) -> torch.Tensor:
    """[1, 2w+1, d] window table -> [1, 2L-1, d]: zero rows outside the
    window, clipped to the middle 2L-1 rows when L <= w."""
    pad = max(length - (window + 1), 0)
    start = max(window + 1 - length, 0)
    return F.pad(rel, (0, 0, pad, pad))[:, start:start + 2 * length - 1]


class RelPosLayer(Initialised):
    def __init__(self, dim: int, ffn_dim: int, num_heads: int, window: int):
        super().__init__()
        head_dim = dim // num_heads
        self.q, self.k = Linear(dim, dim), Linear(dim, dim)
        self.v, self.o = Linear(dim, dim), Linear(dim, dim)
        self.rel_k = nn.Parameter(torch.empty(1, 2 * window + 1, head_dim))
        self.rel_v = nn.Parameter(torch.empty(1, 2 * window + 1, head_dim))
        self.ln1 = LayerNorm(dim)
        self.fc1, self.fc2 = Linear(dim, ffn_dim), Linear(ffn_dim, dim)
        self.ln2 = LayerNorm(dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.rel_k.shape[-1] ** -0.5
        for p in (self.rel_k, self.rel_v):
            p.data.normal_(0.0, std, generator=generator)


class RelPosEncoder(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, num_heads: int, num_layers: int,
                 window: int = 4):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.layers = nn.ModuleList(RelPosLayer(dim, ffn_dim, num_heads, window)
                                    for _ in range(num_layers))

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return relpos_encoder(self, x, x_mask)


def _rel_attention(lp: RelPosLayer, x: torch.Tensor, attn_mask: Optional[torch.Tensor],
                   num_heads: int, window: int) -> torch.Tensor:
    b, t, d = x.shape
    hd = d // num_heads

    def heads(y):
        return y.reshape(b, t, num_heads, hd).transpose(1, 2)

    q, k, v = heads(lp.q(x)), heads(lp.k(x)), heads(lp.v(x))
    q = q * (1.0 / math.sqrt(hd))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k)
    rel_k = _window_embeddings(lp.rel_k, t, window).to(q.dtype)  # [1, 2T-1, hd]
    scores = scores + _rel_to_abs(torch.einsum("bhqd,rmd->bhqm", q, rel_k))
    if attn_mask is not None:
        scores = torch.where(attn_mask == 0, -1e4, scores)
    p = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    rel_v = _window_embeddings(lp.rel_v, t, window).to(v.dtype)
    out = out + torch.einsum("bhqm,rmd->bhqd", _abs_to_rel(p), rel_v)
    return lp.o(out.transpose(1, 2).reshape(b, t, d))


def relpos_encoder(enc: RelPosEncoder, x: torch.Tensor,
                   x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, D], x_mask [B, T] (1 = valid) -> [B, T, D]: per layer
    x = LN(x + attn(x)), x = LN(x + ffn(x)), masked where a mask is given."""
    mask = None if x_mask is None else x_mask.to(x.dtype)[..., None]
    attn_mask = None if x_mask is None else x_mask[:, None, :, None] * x_mask[:, None, None, :]
    if mask is not None:
        x = x * mask
    for lp in enc.layers:
        x = lp.ln1(x + _rel_attention(lp, x, attn_mask, enc.num_heads, enc.window))
        y = x if mask is None else x * mask
        y = lp.fc2(torch.relu(lp.fc1(y)))
        if mask is not None:
            y = y * mask
        x = lp.ln2(x + y)
    return x if mask is None else x * mask
