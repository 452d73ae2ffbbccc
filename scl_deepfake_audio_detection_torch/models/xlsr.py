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
stays in the compute dtype.  The feature encoder's convs run through cuDNN
(``conv_impl='conv'``, the default) or as products, through cuBLAS
('gemm': patches and one product; 'phase': k accumulated products);
``fuse_qkv`` makes q, k and v one [D, 3D] product over the same parameters.

Training: the dropouts sit where the JAX package applies them (their rates
are 0.0 in every preset); ``remat`` recomputes each encoder layer in the
backward through ``torch.utils.checkpoint``, with the JAX package's four
policies (``XLSRConfig``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from scl_deepfake_audio_detection_torch.models.base import Conv1d, LayerNorm, Linear
from scl_deepfake_audio_detection_torch.ops.attention import IMPLS, self_attention
from scl_deepfake_audio_detection_torch.ops.layers import dropout, gelu, linear
from scl_deepfake_audio_detection_torch.parallel.mesh import copy_to_model, reduce_from_model
from scl_deepfake_audio_detection_torch.utils.device import torch_dtype


@dataclass(frozen=True)
class XLSRConfig:
    """Architecture of XLS-R 300M (wav2vec2 large, ``extractor_mode=
    layer_norm``, ``layer_norm_first=True``) and its runtime policy.

    Training fields: the three dropout rates; ``remat`` with
    ``remat_policy``

    - 'full': recompute the whole layer;
    - 'attn': keep the layer input and the o-projection output
      (``attn_out``), recompute the rest, the flash forward included;
    - 'attn_ffn': keep the GELU output (``ffn_act``) as well;
    - 'dots': keep the outputs of the matmuls with no batch dims (the six
      linears; JAX's ``dots_with_no_batch_dims_saveable``) and recompute
      everything else, the attention core included;

    and ``remat_tail_full`` (the last K layers not recomputed);
    ``fast_bwd_matmuls`` (None = on under bf16 compute: the encoder linears
    cast their incoming gradient to bf16 before the transpose GEMMs);
    ``grad_stack_dtype`` (None, or a dtype the six encoder matmul weights
    are rounded to before the layers run: the forward then runs on the
    rounded weights and their gradients come back rounded to it, upcast to
    the fp32 masters.  Under bf16 compute the per-call weight cast already
    does this, so None and 'bfloat16' are the same there; under fp32 compute
    'bfloat16' changes the numerics, as in the JAX package).
    ``scan_unroll`` has no meaning for a Python loop and is carried for
    config parity."""

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
    conv_impl: str = "conv"  # 'conv' | 'gemm' | 'phase' (``CONV_IMPLS``)
    scan_unroll: int = 1
    gelu_impl: str = "auto"  # 'auto' (tanh under bf16, erf otherwise) | 'exact' | 'tanh'
    fuse_qkv: bool = False  # one [D, 3D] product for q, k and v
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


def _strided_conv_gemm(conv: Conv1d, x: torch.Tensor, kernel: int, stride: int,
                       cdtype: torch.dtype) -> torch.Tensor:
    """VALID strided conv1d as patches and one product: [B, T, Cin] ->
    patches [B, T_out, K*Cin] -> @ W [K*Cin, Cout], fp32 out, bias in fp32.

    The patches come from ceil(k/s) shifted non-overlapping views, each a
    reshape (no gather); for stride == kernel the whole of it is one
    reshape.  Rows read only up to index T - 1; the tail is zero-padded so
    that every shifted view reshapes."""
    b, t, cin = x.shape
    t_out = (t - kernel) // stride + 1
    x = x.to(cdtype)
    if stride == kernel:
        patches = x[:, : t_out * stride].reshape(b, t_out, kernel * cin)
    else:
        offs = list(range(0, kernel, stride))
        need = offs[-1] + t_out * stride
        if need > t:
            x = F.pad(x, (0, 0, 0, need - t))
        chunks = []
        for off in offs:
            width = min(stride, kernel - off)
            seg = x[:, off: off + t_out * stride].reshape(b, t_out, stride, cin)[:, :, :width]
            chunks.append(seg.reshape(b, t_out, width * cin))
        patches = torch.cat(chunks, dim=-1)
    # [Cout, Cin, K] -> [Cout, K*Cin], tap-major as the patch rows
    w = conv.weight.permute(0, 2, 1).reshape(conv.weight.shape[0], kernel * cin)
    return linear(patches, w, conv.bias, cdtype)


def _strided_conv_phase(conv: Conv1d, x: torch.Tensor, kernel: int, stride: int,
                        cdtype: torch.dtype) -> torch.Tensor:
    """VALID strided conv1d as k accumulated products: y[t] = sum_j x[t*s + j]
    @ W[j].  Tap j is a contiguous window of the phase view x[j % s :: s],
    so each is a [B*T_out, Cin] x [Cin, Cout] product; the taps sum in fp32
    in order, then the bias.  A one-channel input (the first layer) goes to
    the 'gemm' impl instead, as in the JAX package."""
    b, t, cin = x.shape
    t_out = (t - kernel) // stride + 1
    if cin == 1:
        return _strided_conv_gemm(conv, x, kernel, stride, cdtype)
    x = x.to(cdtype)
    phases = [x[:, r::stride] for r in range(stride)]
    y = None
    for j in range(kernel):
        seg = phases[j % stride][:, j // stride: j // stride + t_out]
        term = linear(seg, conv.weight[:, :, j], None, cdtype)
        y = term if y is None else y + term
    return y if conv.bias is None else y + conv.bias.float()


# the feature encoder's conv: None is the conv itself (``Conv1d``)
CONV_IMPLS = {"conv": None, "gemm": _strided_conv_gemm, "phase": _strided_conv_phase}


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


REMAT_POLICIES = ("full", "attn", "attn_ffn", "dots")
# the ops whose outputs remat 'dots' keeps: 2-D matmuls, which have no batch
# dims (the attention products of the plain version are batched: bmm)
_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_dots)


def _layer_generator(seed: Optional[int], site: int,
                     device: torch.device) -> Optional[torch.Generator]:
    """A fresh generator per (layer seed, dropout site), so a recomputed
    part draws the masks its first run drew, whichever parts remat cuts."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed * 4 + site)


class EncoderLayer(nn.Module):
    """Pre-norm transformer layer (fairseq ``layer_norm_first=True``), as two
    blocks: attention up to the o-projection (``attn_out``), then the
    residual and the feed-forward block.

    Tensor parallel (``tp`` = (model group, M, index), set by
    ``parallel/mesh.shard_params``, which leaves this rank's shards in the
    linears): the layer runs num_heads / M heads and ffn_dim / M hidden
    units; q, k, v and fc1 are column-parallel (their input's gradient is
    summed over the group), o and fc2 row-parallel, each product summed by
    one all-reduce over the group before its bias is added, once."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        d, f = cfg.encoder_dim, cfg.ffn_dim
        self.cfg = cfg
        self.tp = None
        self.ln_attn = LayerNorm(d, cfg.layer_norm_eps)
        self.attn = SelfAttention(d)
        self.ln_ffn = LayerNorm(d, cfg.layer_norm_eps)
        self.fc1 = Linear(d, f)
        self.fc2 = Linear(f, d)

    def _weight(self, lin: Linear) -> torch.Tensor:
        gsd = self.cfg.grad_stack_dtype
        return lin.weight if gsd is None else lin.weight.to(torch_dtype(gsd))

    def _linear(self, lin: Linear, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return linear(x, self._weight(lin), lin.bias, torch_dtype(cfg.compute_dtype),
                      cfg.use_fast_bwd)

    def _row_parallel(self, lin: Linear, x: torch.Tensor) -> torch.Tensor:
        """o and fc2: under tensor parallelism this rank's partial product,
        summed over the model group, then the bias."""
        if self.tp is None:
            return self._linear(lin, x)
        cfg = self.cfg
        y = linear(x, self._weight(lin), None, torch_dtype(cfg.compute_dtype), cfg.use_fast_bwd)
        return reduce_from_model(y, self.tp[0]) + lin.bias.float()

    def _column_input(self, y: torch.Tensor) -> torch.Tensor:
        """The replicated input of q, k, v and fc1: its gradient sums the
        model ranks' parts."""
        return y if self.tp is None else copy_to_model(y, self.tp[0])

    def _part(self, dim: int):
        """``ops/layers.dropout``'s ``part`` of a tensor split on ``dim``."""
        return None if self.tp is None else (dim, self.tp[2], self.tp[1])

    def _qkv(self, y: torch.Tensor):
        """q (scaled by hd**-0.5 after the fp32 product), k, v, each fp32
        [B, T, D]; ``fuse_qkv`` makes them one [D, 3D] product, split."""
        cfg, a = self.cfg, self.attn
        scale = cfg.head_dim ** -0.5
        if not cfg.fuse_qkv:
            return self._linear(a.q, y) * scale, self._linear(a.k, y), self._linear(a.v, y)
        w = torch.cat([self._weight(a.q), self._weight(a.k), self._weight(a.v)])
        b = torch.cat([a.q.bias, a.k.bias, a.v.bias])
        q, k, v = linear(y, w, b, torch_dtype(cfg.compute_dtype), cfg.use_fast_bwd).chunk(3, -1)
        return q * scale, k, v

    def attn_block(self, x: torch.Tensor, kv_len: Optional[int] = None,
                   train: bool = False, seed: Optional[int] = None) -> torch.Tensor:
        """x -> attn_out, the fp32 o-projection output."""
        cfg = self.cfg
        cdtype = torch_dtype(cfg.compute_dtype)
        b, t, _ = x.shape
        hd = cfg.head_dim
        h = cfg.num_heads // (1 if self.tp is None else self.tp[1])
        # q, k, v go to the compute dtype in [B, H, T, D], contiguous for
        # the kernel
        q, k, v = self._qkv(self._column_input(self.ln_attn(x)))
        q, k, v = (z.reshape(b, t, h, hd).transpose(1, 2)
                   .to(cdtype, memory_format=torch.contiguous_format).contiguous()
                   for z in (q, k, v))
        a = self_attention(q, k, v, kv_len=kv_len, impl=cfg.attention_impl)
        a = dropout(a, cfg.attention_dropout, train, _layer_generator(seed, 0, x.device),
                    part=self._part(1))
        a = a.transpose(1, 2).reshape(b, t, h * hd)
        return self._row_parallel(self.attn.o, a)

    def _residual(self, x, attn_out, train, seed):
        gen = _layer_generator(seed, 1, x.device)
        return x + dropout(attn_out, self.cfg.dropout, train, gen).to(x.dtype)

    def _ffn_act(self, x1):
        h = self._column_input(self.ln_ffn(x1))
        return gelu(self._linear(self.fc1, h), self.cfg.approx_gelu)

    def _ffn_out(self, x1, act, train, seed):
        cfg = self.cfg
        act = dropout(act, cfg.activation_dropout, train, _layer_generator(seed, 2, x1.device),
                      part=self._part(act.dim() - 1))
        y = self._row_parallel(self.fc2, act)
        return x1 + dropout(y, cfg.dropout, train,
                            _layer_generator(seed, 3, x1.device)).to(x1.dtype)

    def ffn_block(self, x: torch.Tensor, attn_out: torch.Tensor,
                  train: bool = False, seed: Optional[int] = None) -> torch.Tensor:
        """(layer input, attn_out) -> layer output."""
        x1 = self._residual(x, attn_out, train, seed)
        return self._ffn_out(x1, self._ffn_act(x1), train, seed)

    def ffn_act_block(self, x, attn_out, train=False, seed=None):
        """(layer input, attn_out) -> (x1 = x + attn_out, ffn_act the GELU
        output)."""
        x1 = self._residual(x, attn_out, train, seed)
        return x1, self._ffn_act(x1)

    def ffn_out_block(self, x1, act, train=False, seed=None):
        """(x1, ffn_act) -> layer output."""
        return self._ffn_out(x1, act, train, seed)

    def _layer(self, x, kv_len, train, seed):
        return self.ffn_block(x, self.attn_block(x, kv_len, train, seed), train, seed)

    def forward(self, x: torch.Tensor, kv_len: Optional[int] = None,
                train: bool = False, seed: Optional[int] = None,
                remat: Optional[str] = None) -> torch.Tensor:
        """``remat``: None or a policy of ``XLSRConfig``.  'full' and 'dots'
        put one checkpoint over the layer ('dots' keeps the matmul outputs
        in it); 'attn' and 'attn_ffn' put one over each part between the
        kept tensors.  ``seed`` seeds the layer's dropout draws."""
        ck = dict(use_reentrant=False)
        if remat is None:
            return self._layer(x, kv_len, train, seed)
        if remat == "full":
            return checkpoint(self._layer, x, kv_len, train, seed, **ck)
        if remat == "dots":
            return checkpoint(self._layer, x, kv_len, train, seed,
                              context_fn=_dots_contexts, **ck)
        a = checkpoint(self.attn_block, x, kv_len, train, seed, **ck)
        if remat == "attn":
            return checkpoint(self.ffn_block, x, a, train, seed, **ck)
        # x1 = x + attn_out leaves the middle part, so that its gradient
        # sums as without remat (one [B, T, D] tensor kept beside ffn_act)
        x1, act = checkpoint(self.ffn_act_block, x, a, train, seed, **ck)
        return checkpoint(self.ffn_out_block, x1, act, train, seed, **ck)


class Encoder(nn.Module):
    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.encoder_layers))
        self.final_ln = LayerNorm(cfg.encoder_dim, cfg.layer_norm_eps)


class XLSR(nn.Module):
    """wav [B, T_samples] -> frame features [B, T_frames, encoder_dim]."""

    def __init__(self, cfg: XLSRConfig):
        super().__init__()
        if cfg.conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, "
                             f"got {cfg.conv_impl!r}")
        if cfg.attention_impl not in IMPLS:
            raise ValueError(f"attention_impl must be one of {IMPLS}, "
                             f"got {cfg.attention_impl!r}")
        if cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {cfg.remat_policy!r}")
        if cfg.grad_stack_dtype is not None:
            torch_dtype(cfg.grad_stack_dtype)  # ValueError on an unknown name
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
        block, all in the compute dtype.  ``conv_impl`` 'gemm' and 'phase'
        compute the conv as products (fp32 out, the bias added in fp32)."""
        cdtype = self.compute_dtype
        impl = CONV_IMPLS[self.cfg.conv_impl]
        x = wav[..., None].to(cdtype)
        for block, (_, kernel, stride) in zip(self.feature_extractor.convs,
                                              self.cfg.conv_layers):
            if impl is None:
                x = block.conv(x, stride=stride, compute_dtype=cdtype)
            else:
                x = impl(block.conv, x, kernel, stride, cdtype)
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
