"""XLS-R (wav2vec 2.0 large) SSL frontend.

Counterpart of ``scl_deepfake_audio_detection_tpu/models/xlsr.py``: a
strided conv feature encoder (total stride 320) followed by a pre-norm
transformer with a grouped-conv positional embedding.  For 64600-sample
input it yields [B, 201, 1024] frame features at the 300M preset.

The module tree carries the JAX parameter tree's names, with the stacked
[L, ...] encoder leaves split into ``encoder.layers.<i>``.  The 24 encoder
layers run as a Python loop; each attention core is the hand-written
Hopper flash forward on the card, with the hand-written flash backward
(``ops/attention.self_attention``).  Matmuls run in ``compute_dtype`` with
fp32 accumulation; layer norm and softmax stay fp32; the residual stream
stays in the compute dtype.

Training: the dropouts sit where the JAX package applies them (their rates
are 0.0 in every preset); ``remat`` recomputes each encoder layer in the
backward through ``torch.utils.checkpoint``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from scl_deepfake_audio_detection_torch.models.base import Conv1d, LayerNorm, Linear
from scl_deepfake_audio_detection_torch.ops.attention import IMPLS, self_attention
from scl_deepfake_audio_detection_torch.ops.layers import dropout, gelu
from scl_deepfake_audio_detection_torch.utils.device import torch_dtype


@dataclass(frozen=True)
class XLSRConfig:
    """Architecture of XLS-R 300M (wav2vec2 large, ``extractor_mode=
    layer_norm``, ``layer_norm_first=True``) and its runtime policy.

    Training fields: the three dropout rates; ``remat`` with
    ``remat_policy`` 'full' (recompute the whole layer) or 'attn' (keep the
    layer input and the o-projection output, recompute the rest, the flash
    forward included) and ``remat_tail_full`` (the last K layers not
    recomputed); ``fast_bwd_matmuls`` (None = on under bf16 compute: the
    encoder linears cast their incoming gradient to bf16 before the
    transpose GEMMs); ``grad_stack_dtype`` (None, or the compute dtype: the
    per-call weight cast already gives the JAX package's bf16 weight-grad
    stacks under bf16 compute).  ``scan_unroll`` has no meaning for a Python
    loop and is carried for config parity."""

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
    def use_fast_bwd(self) -> bool:
        if self.fast_bwd_matmuls is None:
            return torch_dtype(self.compute_dtype) == torch.bfloat16
        return self.fast_bwd_matmuls

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


REMAT_POLICIES = ("full", "attn")


def _layer_generator(seed: Optional[int], block: int,
                     device: torch.device) -> Optional[torch.Generator]:
    """A fresh generator per (layer seed, block), so a recomputed block draws
    the masks its first run drew."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed * 2 + block)


class EncoderLayer(nn.Module):
    """Pre-norm transformer layer (fairseq ``layer_norm_first=True``), as two
    blocks: attention up to the o-projection (``attn_out``), then the
    residual and the feed-forward block."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        d, f = cfg.encoder_dim, cfg.ffn_dim
        self.cfg = cfg
        self.ln_attn = LayerNorm(d, cfg.layer_norm_eps)
        self.attn = SelfAttention(d)
        self.ln_ffn = LayerNorm(d, cfg.layer_norm_eps)
        self.fc1 = Linear(d, f)
        self.fc2 = Linear(f, d)

    def attn_block(self, x: torch.Tensor, kv_len: Optional[int] = None,
                   train: bool = False, seed: Optional[int] = None) -> torch.Tensor:
        """x -> attn_out, the fp32 o-projection output."""
        cfg = self.cfg
        cdtype, fb = torch_dtype(cfg.compute_dtype), cfg.use_fast_bwd
        b, t, d = x.shape
        h, hd = cfg.num_heads, cfg.head_dim
        y = self.ln_attn(x)
        # q is scaled after the fp32 linear, then everything goes to the
        # compute dtype in [B, H, T, D], contiguous for the kernel
        q = self.attn.q(y, cdtype, fb) * (hd ** -0.5)
        k = self.attn.k(y, cdtype, fb)
        v = self.attn.v(y, cdtype, fb)
        q, k, v = (z.view(b, t, h, hd).transpose(1, 2)
                   .to(cdtype, memory_format=torch.contiguous_format).contiguous()
                   for z in (q, k, v))
        a = self_attention(q, k, v, kv_len=kv_len, impl=cfg.attention_impl)
        a = dropout(a, cfg.attention_dropout, train, _layer_generator(seed, 0, x.device))
        a = a.transpose(1, 2).reshape(b, t, d)
        return self.attn.o(a, cdtype, fb)

    def ffn_block(self, x: torch.Tensor, attn_out: torch.Tensor,
                  train: bool = False, seed: Optional[int] = None) -> torch.Tensor:
        """(layer input, attn_out) -> layer output."""
        cfg = self.cfg
        cdtype, fb = torch_dtype(cfg.compute_dtype), cfg.use_fast_bwd
        gen = _layer_generator(seed, 1, x.device)
        x = x + dropout(attn_out, cfg.dropout, train, gen).to(x.dtype)
        y = self.ln_ffn(x)
        y = gelu(self.fc1(y, cdtype, fb), cfg.approx_gelu)
        y = dropout(y, cfg.activation_dropout, train, gen)
        y = self.fc2(y, cdtype, fb)
        return x + dropout(y, cfg.dropout, train, gen).to(x.dtype)

    def _layer(self, x, kv_len, train, seed):
        return self.ffn_block(x, self.attn_block(x, kv_len, train, seed), train, seed)

    def forward(self, x: torch.Tensor, kv_len: Optional[int] = None,
                train: bool = False, seed: Optional[int] = None,
                remat: Optional[str] = None) -> torch.Tensor:
        """``remat``: None, 'full' (one checkpoint over the layer) or 'attn'
        (one over each block, so the backward keeps exactly the layer input
        and attn_out).  ``seed`` seeds the layer's dropout draws."""
        if remat is None:
            return self._layer(x, kv_len, train, seed)
        if remat == "full":
            return checkpoint(self._layer, x, kv_len, train, seed, use_reentrant=False)
        a = checkpoint(self.attn_block, x, kv_len, train, seed, use_reentrant=False)
        return checkpoint(self.ffn_block, x, a, train, seed, use_reentrant=False)


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
        if cfg.remat_policy in ("attn_ffn", "dots"):
            raise NotImplementedError(f"remat_policy={cfg.remat_policy!r} not ported yet")
        if cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {cfg.remat_policy!r}")
        if (cfg.grad_stack_dtype is not None
                and torch_dtype(cfg.grad_stack_dtype) != torch_dtype(cfg.compute_dtype)):
            raise NotImplementedError(
                f"grad_stack_dtype={cfg.grad_stack_dtype!r} under compute_dtype="
                f"{cfg.compute_dtype!r} not ported yet")
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

    def transformer_encoder(self, x: torch.Tensor, kv_len: Optional[int] = None,
                            train: bool = False,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        x = x + self.pos_conv_embed(x).to(x.dtype)
        x = dropout(x, cfg.dropout, train and generator is not None, generator)
        layers = self.encoder.layers
        tail = min(cfg.remat_tail_full, len(layers)) if cfg.remat else 0
        draws = train and generator is not None and max(
            cfg.dropout, cfg.attention_dropout, cfg.activation_dropout) > 0.0
        for i, layer in enumerate(layers):
            # one seed per layer from the step's generator; a recomputed
            # block reseeds from it (the draw syncs, and happens only when a
            # rate is set)
            seed = (int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                      device=generator.device).item())
                    if draws else None)
            remat = cfg.remat_policy if cfg.remat and i < len(layers) - tail else None
            x = layer(x, kv_len, draws, seed, remat)
        return self.encoder.final_ln(x)

    def extract_features(self, wav: torch.Tensor, train: bool = False,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Raw waveform in (no input normalisation), conv features -> fp32 LN
        -> projection -> transformer.  Dropout draws only in training with a
        ``generator`` (the JAX package draws only when given a key)."""
        if wav.dim() == 3:  # accept [B, T, 1]
            wav = wav[:, :, 0]
        cdtype = self.compute_dtype
        x = self.post_extract_ln(self.feature_encoder(wav))
        x = self.proj(x, cdtype, self.cfg.use_fast_bwd).to(cdtype)
        x = dropout(x, self.cfg.dropout, train and generator is not None, generator)
        return self.transformer_encoder(x, train=train, generator=generator)

    forward = extract_features
