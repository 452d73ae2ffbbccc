"""Conformer encoder blocks.

Counterpart of ``scl_deepfake_audio_detection_tpu/models/conformer.py`` (the
reference's ``model/conformer.py``, lucidrains-style ConformerBlock
:180-214 and Conformer :217-253, present in the reference but imported
nowhere; a standalone encoder).  The package's ``models/__init__`` loads it
with the heads; it registers no model name.

A block, on [B, T, dim]: a half-scale macaron FF, pre-norm MHSA with a
clamped relative-position bias (a learned table over the clipped key-query
offsets, :87-112), the conv module (pointwise GLU, depthwise conv k = 31
'same', batch norm, swish, pointwise, :148-177), a half-scale FF, and a
final layer norm.

As the JAX blocks: the bias is added before the scale, ``(q k^T + q
rel^T) * dim_head^-0.5``, and the softmax is fp32; the [T, T] clipped
offset index is built once per T (and device); the batch norm's running
statistics are the ``BatchNorm`` buffers ``mean`` and ``var`` (the JAX
package's separate buffers tree), which a training forward moves in place.
The attention is plain products, not the flash kernel: it adds a bias the
kernel has no input for, as the JAX package leaves it to XLA.  Each dropout
site draws from the generator in turn.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models.base import (
    BatchNorm,
    Conv1d,
    Embedding,
    LayerNorm,
    Linear,
)
from scl_deepfake_audio_detection_torch.ops.layers import dropout

_Gen = Optional[torch.Generator]


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


@dataclass(frozen=True)
class ConformerConfig:
    dim: int = 64
    depth: int = 2
    dim_head: int = 64
    heads: int = 8
    ff_mult: int = 4
    conv_expansion: int = 2
    conv_kernel: int = 31
    max_pos_emb: int = 512
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    conv_dropout: float = 0.0


@lru_cache(maxsize=32)
def _clipped_offsets(t: int, max_pos_emb: int, device: torch.device) -> torch.Tensor:
    """[T, T] rows of the relative-position table: i - j clipped to
    +-max_pos_emb, shifted to start at 0 (reference :104-112)."""
    idx = np.clip(np.arange(t)[:, None] - np.arange(t)[None, :],
                  -max_pos_emb, max_pos_emb) + max_pos_emb
    return torch.from_numpy(idx).to(device)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int, rate: float):
        super().__init__()
        self.rate = rate
        self.ln = LayerNorm(dim)
        self.fc1, self.fc2 = Linear(dim, dim * mult), Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor, train: bool = False, generator: _Gen = None):
        y = dropout(swish(self.fc1(self.ln(x))), self.rate, train, generator)
        return dropout(self.fc2(y), self.rate, train, generator)


class ConformerAttention(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        inner = cfg.dim_head * cfg.heads
        self.cfg = cfg
        self.ln = LayerNorm(cfg.dim)
        self.q, self.kv = Linear(cfg.dim, inner), Linear(cfg.dim, inner * 2)
        self.o = Linear(inner, cfg.dim)
        self.rel_pos = Embedding(2 * cfg.max_pos_emb + 1, cfg.dim_head)

    def rel_pos_bias(self, q: torch.Tensor) -> torch.Tensor:
        """q [B, H, T, hd] -> the clamped-distance bias [B, H, T, T]."""
        idx = _clipped_offsets(q.shape[2], self.cfg.max_pos_emb, q.device)
        table = self.rel_pos.weight[idx]  # [T, T, hd]
        return torch.einsum("bhnd,nrd->bhnr", q, table.to(q.dtype))

    def forward(self, x: torch.Tensor, train: bool = False, generator: _Gen = None):
        cfg = self.cfg
        b, t, _ = x.shape
        h, hd = cfg.heads, cfg.dim_head
        y = self.ln(x)
        q = self.q(y).reshape(b, t, h, hd).transpose(1, 2)
        k, v = self.kv(y).chunk(2, dim=-1)
        k = k.reshape(b, t, h, hd).transpose(1, 2)
        v = v.reshape(b, t, h, hd).transpose(1, 2)
        dots = torch.matmul(q.float(), k.float().transpose(-1, -2))
        dots = (dots + self.rel_pos_bias(q)) * hd**-0.5
        attn = torch.softmax(dots.float(), dim=-1)
        attn = dropout(attn, cfg.attn_dropout, train, generator)
        out = torch.matmul(attn.to(v.dtype), v)
        out = self.o(out.transpose(1, 2).reshape(b, t, h * hd))
        return dropout(out, cfg.attn_dropout, train, generator)


class ConvModule(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        inner = cfg.dim * cfg.conv_expansion
        self.cfg = cfg
        self.ln = LayerNorm(cfg.dim)
        self.pw1 = Conv1d(cfg.dim, inner * 2, 1)
        self.dw = Conv1d(inner, inner, cfg.conv_kernel, groups=inner)
        self.bn = BatchNorm(inner)
        self.pw2 = Conv1d(inner, cfg.dim, 1)

    def forward(self, x: torch.Tensor, train: bool = False, generator: _Gen = None):
        k = self.cfg.conv_kernel
        a, g = self.pw1(self.ln(x)).chunk(2, dim=-1)
        y = a * torch.sigmoid(g)  # GLU
        pad = (k - 1) // 2
        y = self.dw(y, padding=[(pad, k - 1 - pad)])
        y = self.bn(y.transpose(1, 2), train).transpose(1, 2)
        y = self.pw2(swish(y))
        return dropout(y, self.cfg.conv_dropout, train, generator)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.ff1 = FeedForward(cfg.dim, cfg.ff_mult, cfg.ff_dropout)
        self.attn = ConformerAttention(cfg)
        self.conv = ConvModule(cfg)
        self.ff2 = FeedForward(cfg.dim, cfg.ff_mult, cfg.ff_dropout)
        self.post_ln = LayerNorm(cfg.dim)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: _Gen = None) -> torch.Tensor:
        x = x + 0.5 * self.ff1(x, train, generator)
        x = x + self.attn(x, train, generator)
        x = x + self.conv(x, train, generator)
        x = x + 0.5 * self.ff2(x, train, generator)
        return self.post_ln(x)


class Conformer(nn.Module):
    """[B, T, dim] -> [B, T, dim] through ``cfg.depth`` blocks (the JAX
    ``conformer``; ``init_parameters`` fills it from a generator,
    ``models/params.load_jax_params`` from a JAX ``init_conformer`` pair)."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(ConformerBlock(cfg) for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: _Gen = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, train, generator)
        return x
