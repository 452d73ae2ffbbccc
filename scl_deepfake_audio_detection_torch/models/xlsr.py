"""XLS-R (wav2vec 2.0 large) SSL frontend.

Counterpart of ``scl_deepfake_audio_detection_tpu/models/xlsr.py``: a
strided conv feature encoder (total stride 320) followed by a pre-norm
transformer with a grouped-conv positional embedding.  For 64600-sample
input it yields [B, 201, 1024] frame features at the 300M preset.

The module tree carries the JAX parameter tree's names, with the stacked
[L, ...] encoder leaves split into ``encoder.layers.<i>``.  The 24 encoder
layers run as a Python loop; each attention core is the hand-written
Hopper flash forward on the card (``ops/attention.self_attention``).
Matmuls run in ``compute_dtype`` with fp32 accumulation; layer norm and
softmax stay fp32; the residual stream stays in the compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models.base import Conv1d, LayerNorm, Linear
from scl_deepfake_audio_detection_torch.ops.attention import IMPLS, self_attention
from scl_deepfake_audio_detection_torch.ops.layers import gelu
from scl_deepfake_audio_detection_torch.utils.device import torch_dtype


@dataclass(frozen=True)
class XLSRConfig:
    """Architecture of XLS-R 300M (wav2vec2 large, ``extractor_mode=
    layer_norm``, ``layer_norm_first=True``) and its runtime policy.

    The training fields (dropouts, remat, fast backward, grad stacks,
    scan unroll) are carried so configs interchange with the JAX package,
    and are inert here: only eval is ported."""

    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )  # (dim, kernel, stride)
    conv_bias: bool = True
    encoder_dim: int = 1024
    encoder_layers: int = 24
    ffn_dim: int = 4096
    num_heads: int = 16
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5
    dropout: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    compute_dtype: str = "float32"
    attention_impl: str = "auto"  # 'auto' | 'flash' | 'reference'
    conv_impl: str = "conv"  # only 'conv' is ported
    scan_unroll: int = 1
    gelu_impl: str = "auto"  # 'auto' (tanh under bf16, erf otherwise) | 'exact' | 'tanh'
    fuse_qkv: bool = False  # not ported
    remat: bool = False
    remat_policy: str = "attn"
    remat_tail_full: int = 0
    fast_bwd_matmuls: Optional[bool] = None
    grad_stack_dtype: Optional[str] = None

    @property
    def approx_gelu(self) -> bool:
        if self.gelu_impl == "auto":
            return torch_dtype(self.compute_dtype) == torch.bfloat16
        return self.gelu_impl == "tanh"

    @property
    def head_dim(self) -> int:
        return self.encoder_dim // self.num_heads

    @property
    def out_dim(self) -> int:
        return self.encoder_dim

    def with_(self, **kw) -> "XLSRConfig":
        return replace(self, **kw)

    @classmethod
    def xlsr_300m(cls, **kw) -> "XLSRConfig":
        return cls(**kw)

    @classmethod
    def xlsr_1b(cls, **kw) -> "XLSRConfig":
        """48 layers, 1280-d, 5120 FFN (facebook/wav2vec2-xls-r-1b)."""
        return cls(**{**dict(encoder_dim=1280, encoder_layers=48, ffn_dim=5120,
                             num_heads=16), **kw})

    @classmethod
    def xlsr_2b(cls, **kw) -> "XLSRConfig":
        """48 layers, 1920-d, 7680 FFN (facebook/wav2vec2-xls-r-2b)."""
        return cls(**{**dict(encoder_dim=1920, encoder_layers=48, ffn_dim=7680,
                             num_heads=16), **kw})

    @classmethod
    def student_base(cls, **kw) -> "XLSRConfig":
        """12 x 768 distillation student with the 300M model's frame grid."""
        return cls(**{**dict(encoder_dim=768, encoder_layers=12, ffn_dim=3072,
                             num_heads=8), **kw})

    @classmethod
    def tiny(cls, **kw) -> "XLSRConfig":
        """Small config for CPU tests."""
        return cls(**{**dict(
            conv_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)),
            encoder_dim=32,
            encoder_layers=2,
            ffn_dim=64,
            num_heads=4,
            pos_conv_kernel=16,
            pos_conv_groups=4,
        ), **kw})

    @classmethod
    def preset_names(cls) -> tuple:
        return ("xlsr_300m", "xlsr_1b", "xlsr_2b", "student_base", "tiny")

    def num_frames(self, num_samples: int) -> int:
        t = num_samples
        for _, k, s in self.conv_layers:
            t = (t - k) // s + 1
        return t


class ConvBlock(nn.Module):
    def __init__(self, in_dim: int, dim: int, kernel: int, cfg: XLSRConfig):
        super().__init__()
        self.conv = Conv1d(in_dim, dim, kernel, bias=cfg.conv_bias)
        self.ln = LayerNorm(dim, cfg.layer_norm_eps)


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        dims = [1] + [dim for dim, _, _ in cfg.conv_layers]
        self.convs = nn.ModuleList(
            ConvBlock(dims[i], dim, kernel, cfg)
            for i, (dim, kernel, _) in enumerate(cfg.conv_layers))


class SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q = Linear(d, d)
        self.k = Linear(d, d)
        self.v = Linear(d, d)
        self.o = Linear(d, d)


class EncoderLayer(nn.Module):
    """Pre-norm transformer layer (fairseq ``layer_norm_first=True``)."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        d, f = cfg.encoder_dim, cfg.ffn_dim
        self.cfg = cfg
        self.ln_attn = LayerNorm(d, cfg.layer_norm_eps)
        self.attn = SelfAttention(d)
        self.ln_ffn = LayerNorm(d, cfg.layer_norm_eps)
        self.fc1 = Linear(d, f)
        self.fc2 = Linear(f, d)

    def forward(self, x: torch.Tensor, kv_len: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        cdtype = torch_dtype(cfg.compute_dtype)
        b, t, d = x.shape
        h, hd = cfg.num_heads, cfg.head_dim

        y = self.ln_attn(x)
        # q is scaled after the fp32 linear, then everything goes to the
        # compute dtype in [B, H, T, D], contiguous for the kernel
        q = self.attn.q(y, cdtype) * (hd ** -0.5)
        k = self.attn.k(y, cdtype)
        v = self.attn.v(y, cdtype)
        q, k, v = (z.view(b, t, h, hd).transpose(1, 2)
                   .to(cdtype, memory_format=torch.contiguous_format).contiguous()
                   for z in (q, k, v))
        a = self_attention(q, k, v, kv_len=kv_len, impl=cfg.attention_impl)
        a = a.transpose(1, 2).reshape(b, t, d)
        x = x + self.attn.o(a, cdtype).to(x.dtype)

        y = self.ln_ffn(x)
        y = gelu(self.fc1(y, cdtype), cfg.approx_gelu)
        return x + self.fc2(y, cdtype).to(x.dtype)


class Encoder(nn.Module):
    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.encoder_layers))
        self.final_ln = LayerNorm(cfg.encoder_dim, cfg.layer_norm_eps)


class XLSR(nn.Module):
    """wav [B, T_samples] -> frame features [B, T_frames, encoder_dim]."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        if cfg.conv_impl != "conv":
            raise NotImplementedError(f"conv_impl={cfg.conv_impl!r} not ported yet")
        if cfg.fuse_qkv:
            raise NotImplementedError("fuse_qkv=True not ported yet")
        if cfg.attention_impl not in IMPLS:
            raise ValueError(f"attention_impl must be one of {IMPLS}, "
                             f"got {cfg.attention_impl!r}")
        self.cfg = cfg
        last = cfg.conv_layers[-1][0]
        self.feature_extractor = FeatureExtractor(cfg)
        self.post_extract_ln = LayerNorm(last, cfg.layer_norm_eps)
        self.proj = Linear(last, cfg.encoder_dim)
        self.pos_conv = Conv1d(cfg.encoder_dim, cfg.encoder_dim, cfg.pos_conv_kernel,
                               bias=True, groups=cfg.pos_conv_groups)
        self.encoder = Encoder(cfg)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.compute_dtype)

    def feature_encoder(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T_samples] -> [B, T_frames, C]: conv -> fp32 LN -> GELU per
        block, all in the compute dtype."""
        cdtype = self.compute_dtype
        x = wav[..., None].to(cdtype)
        for block, (_, _, stride) in zip(self.feature_extractor.convs,
                                         self.cfg.conv_layers):
            x = block.conv(x, stride=stride, compute_dtype=cdtype)
            x = gelu(block.ln(x).to(cdtype), self.cfg.approx_gelu)
        return x

    def pos_conv_embed(self, x: torch.Tensor) -> torch.Tensor:
        """Grouped conv positional embedding; fairseq's SamePad (pad k//2 on
        both sides, drop the last output for even k) as one asymmetric
        (k//2, k//2 - 1) padding."""
        k = self.cfg.pos_conv_kernel
        pad = [(k // 2, k // 2 - 1 if k % 2 == 0 else k // 2)]
        y = self.pos_conv(x, padding=pad, compute_dtype=self.compute_dtype)
        return gelu(y, self.cfg.approx_gelu)

    def transformer_encoder(self, x: torch.Tensor,
                            kv_len: Optional[int] = None) -> torch.Tensor:
        x = x + self.pos_conv_embed(x).to(x.dtype)
        for layer in self.encoder.layers:
            x = layer(x, kv_len)
        return self.encoder.final_ln(x)

    def extract_features(self, wav: torch.Tensor) -> torch.Tensor:
        """Raw waveform in (no input normalisation), conv features -> fp32 LN
        -> projection -> transformer."""
        if wav.dim() == 3:  # accept [B, T, 1]
            wav = wav[:, :, 0]
        cdtype = self.compute_dtype
        x = self.post_extract_ln(self.feature_encoder(wav))
        x = self.proj(x, cdtype).to(cdtype)
        return self.transformer_encoder(x)

    forward = extract_features
