"""AASIST: spectro-temporal graph attention back-end over SSL features.

Counterpart of ``XLSRAasist`` in
``scl_deepfake_audio_detection_tpu/models/aasist.py``: SSL frames ->
Linear to 128 -> (3, 3) max pool over (feature, time) -> batch norm, SELU
-> six residual conv blocks -> spectral and temporal attention pooling ->
two heterogeneous graph-attention branches with learnable master nodes ->
element-wise max of the branches -> [T_max, T_avg, S_max, S_avg, master]
readout -> linear classifier.

The image is NCHW, [N, 1, feature, time], where the JAX package's is NHWC
[N, feature, time, 1]: the two hold the same values, the pooling and
softmax axes follow.  The encoder runs in the compute dtype (cuDNN convs
on the card), batch norm in fp32 with its running statistics in the
``BatchNorm`` buffers, and the graph part in fp32 (``ops/graph``).

As the JAX model: the residual block feeds its raw input to conv1 (the
reference's pre-activation there is dead code); the output carries the
raw logits (``eval_scores``) and ``log_probs`` = log_softmax(logits);
``feats`` is the one-frame sequence ``last_hidden[:, None]`` and ``emb``
is ``last_hidden``, which both SupCon terms read.

Dropout: the SSL frontend draws from ``generator`` (its rates are 0 in
every preset); the head's 19 sites (the four graph layers' inputs, the six
pools, the six branch outputs and ``last_hidden``) draw from ``generator``
too, or take one boolean keep-mask each from ``dropout_masks``, in the
order of the JAX model's key splits (``dropout_sites``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models import xlsr as X
from scl_deepfake_audio_detection_torch.models.base import (
    BatchNorm,
    Conv2d,
    Initialised,
    Linear,
    ModelOutput,
    init_parameters,
)
from scl_deepfake_audio_detection_torch.ops.graph import GAT, GraphPool, HtrgGAT, pooled_nodes
from scl_deepfake_audio_detection_torch.ops.layers import dropout, max_pool2d, selu
from scl_deepfake_audio_detection_torch.ops.losses import cross_entropy
from scl_deepfake_audio_detection_torch.ops.supcon import seq_similarity, supcon_loss
from scl_deepfake_audio_detection_torch.utils.device import resolve_device
from scl_deepfake_audio_detection_torch.utils.registry import MODELS

DEFAULT_FILTS: Tuple = (128, (1, 32), (32, 32), (32, 64), (64, 64))
DEFAULT_GAT_DIMS = (64, 32)
DEFAULT_POOL_RATIOS = (0.5, 0.7, 0.5, 0.5)
DEFAULT_TEMPERATURES = (2.0, 2.0, 100.0, 100.0)


class ResBlock(nn.Module):
    """conv1 (2, 3) pad (1, 1) -> batch norm, SELU -> conv2 (2, 3) pad
    (0, 1), plus the input, through a (1, 3) conv where the channels
    change.  H and W are kept."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv1 = Conv2d(in_c, out_c, (2, 3))
        self.bn2 = BatchNorm(out_c)
        self.conv2 = Conv2d(out_c, out_c, (2, 3))
        self.downsample = Conv2d(in_c, out_c, (1, 3)) if in_c != out_c else None

    def forward(self, x: torch.Tensor, train: bool, cdtype: torch.dtype) -> torch.Tensor:
        out = self.conv1(x, padding=[(1, 1), (1, 1)], compute_dtype=cdtype)
        out = self.bn2(out, train)
        out = self.conv2(selu(out), padding=[(0, 0), (1, 1)], compute_dtype=cdtype)
        identity = x if self.downsample is None else self.downsample(
            x, padding=[(0, 0), (1, 1)], compute_dtype=cdtype)
        return out + identity.to(out.dtype)


def encoder_blocks(filts) -> List[Tuple[int, int]]:
    """(in, out) channels of the six encoder blocks: filts[1], [2], [3],
    [4], [4], [4], the repeated blocks at out -> out."""
    seq = [tuple(filts[1]), tuple(filts[2]), tuple(filts[3])] + [tuple(filts[4])] * 3
    return [(seq[3][1] if i >= 4 else ci, co) for i, (ci, co) in enumerate(seq)]


@MODELS.register("xlsr_aasist", aliases=("wav2vec2_aasist",))
class XLSRAasist(Initialised):
    """Parameters are made on ``device`` (the card unless the caller passes
    ``device="cpu"``) and filled from a ``torch.Generator`` seeded with
    ``seed``; on ``device="meta"`` they have shapes only."""

    def __init__(self, ssl: Optional[X.XLSRConfig] = None, filts: Tuple = DEFAULT_FILTS,
                 gat_dims: Tuple[int, int] = DEFAULT_GAT_DIMS,
                 pool_ratios: Tuple[float, ...] = DEFAULT_POOL_RATIOS,
                 temperatures: Tuple[float, ...] = DEFAULT_TEMPERATURES,
                 num_classes: int = 2, feat_dim: int = 128, flag_fix_ssl: bool = False,
                 contra_mode: str = "all", loss_type: int = 1, temperature: float = 0.07,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        super().__init__()
        ssl = ssl or X.XLSRConfig.xlsr_300m()
        self.filts = tuple(tuple(f) if isinstance(f, (list, tuple)) else f for f in filts)
        self.gat_dims, self.pool_ratios = tuple(gat_dims), tuple(pool_ratios)
        self.temperatures = tuple(temperatures)
        self.num_classes, self.feat_dim = num_classes, feat_dim
        self.flag_fix_ssl, self.contra_mode = flag_fix_ssl, contra_mode
        self.loss_type, self.temperature = loss_type, temperature
        blocks = encoder_blocks(self.filts)
        enc_out = blocks[-1][1]
        g0, g1 = self.gat_dims
        with torch.device(resolve_device(device)):
            self.ssl = X.XLSR(ssl)
            self.ll = Linear(ssl.out_dim, feat_dim)
            self.first_bn = BatchNorm(1)
            self.encoder = nn.ModuleList(ResBlock(ci, co) for ci, co in blocks)
            self.first_bn1 = BatchNorm(enc_out)
            self.att_conv1 = Conv2d(enc_out, 128, 1)
            self.att_bn = BatchNorm(128)
            self.att_conv2 = Conv2d(128, enc_out, 1)
            self.pos_S = nn.Parameter(torch.empty(1, feat_dim // 3, enc_out))
            self.master1 = nn.Parameter(torch.empty(1, 1, g0))
            self.master2 = nn.Parameter(torch.empty(1, 1, g0))
            self.gat_S = GAT(enc_out, g0)
            self.gat_T = GAT(enc_out, g0)
            self.pool_S, self.pool_T = GraphPool(g0), GraphPool(g0)
            for name in ("hS1", "hT1", "hS2", "hT2"):
                setattr(self, f"pool_{name}", GraphPool(g1))
            self.htrg_st11, self.htrg_st12 = HtrgGAT(g0, g1), HtrgGAT(g1, g1)
            self.htrg_st21, self.htrg_st22 = HtrgGAT(g0, g1), HtrgGAT(g1, g1)
            self.out_layer = Linear(5 * g1, num_classes)
        self.init(seed)

    @classmethod
    def from_config(cls, model_cfg, ssl: Optional[X.XLSRConfig] = None,
                    **kw) -> "XLSRAasist":
        """Build from a ``utils.config.ModelConfig``; the ``aasist:`` block of
        its ``extra`` sets the head (the published SSL-AASIST values where it
        is absent)."""
        aa = dict(getattr(model_cfg, "extra", {}) or {}).get("aasist", {})
        return cls(ssl=ssl or X.XLSRConfig.xlsr_300m(),
                   filts=aa.get("filts", DEFAULT_FILTS),
                   gat_dims=tuple(aa.get("gat_dims", DEFAULT_GAT_DIMS)),
                   pool_ratios=tuple(aa.get("pool_ratios", DEFAULT_POOL_RATIOS)),
                   temperatures=tuple(aa.get("temperatures", DEFAULT_TEMPERATURES)),
                   num_classes=int(aa.get("nclasses", 2)),
                   flag_fix_ssl=bool(model_cfg.flag_fix_ssl),
                   contra_mode=model_cfg.contra_mode,
                   loss_type=int(model_cfg.loss_type), **kw)

    def init(self, seed: int) -> "XLSRAasist":
        """Fill every parameter from a ``torch.Generator`` on the model's
        device seeded with ``seed``; the running statistics start at mean 0,
        var 1."""
        device = self.ll.weight.device
        if device.type == "meta":
            return self
        return init_parameters(self, torch.Generator(device=device).manual_seed(seed))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for p in (self.pos_S, self.master1, self.master2):
            p.data.normal_(0.0, 1.0, generator=generator)

    def dropout_sites(self, n: int, num_samples: int) -> List[Tuple[float, Tuple[int, ...]]]:
        """(rate, shape) of the head's dropout sites for ``n`` clips of
        ``num_samples`` samples, in the order of ``dropout_masks``."""
        g0, g1 = self.gat_dims
        enc_out = self.att_conv2.weight.shape[0]
        ns, nt = self.feat_dim // 3, self.ssl.cfg.num_frames(num_samples) // 3
        s, t = pooled_nodes(ns, self.pool_ratios[0]), pooled_nodes(nt, self.pool_ratios[1])
        s2, t2 = pooled_nodes(s, self.pool_ratios[2]), pooled_nodes(t, self.pool_ratios[2])
        sites = [(0.2, (n, ns, enc_out)), (0.3, (n, ns, g0)),
                 (0.2, (n, nt, enc_out)), (0.3, (n, nt, g0))]
        for _ in range(2):  # htrg input, pool S, pool T, htrg input
            sites += [(0.2, (n, t + s, g0)), (0.3, (n, s, g1)), (0.3, (n, t, g1)),
                      (0.2, (n, t2 + s2, g1))]
        sites += [(0.2, (n, t2, g1))] * 2 + [(0.2, (n, s2, g1))] * 2 + [(0.2, (n, 1, g1))] * 2
        return sites + [(0.5, (n, 5 * g1))]

    def apply(self, wav: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None,
              dropout_masks: Optional[Sequence[torch.Tensor]] = None) -> ModelOutput:
        """wav [N, T_samples] -> ModelOutput.  Training normalises with the
        batch's statistics and moves the running ones once."""
        cdtype = self.ssl.compute_dtype
        if self.flag_fix_ssl:
            with torch.no_grad():
                feats_ssl = self.ssl.extract_features(wav)
        else:
            feats_ssl = self.ssl.extract_features(wav, train=train, generator=generator)
        feats = self.ll(feats_ssl, cdtype)  # [N, T, feat] fp32

        draws = train and (generator is not None or dropout_masks is not None)
        masks = iter(dropout_masks) if dropout_masks is not None else None
        kw = lambda: dict(draws=draws, generator=generator,  # noqa: E731
                          mask=None if masks is None else next(masks))

        # the image [N, 1, feature, time], then the (3, 3) max pool
        x = max_pool2d(feats.transpose(1, 2)[:, None], (3, 3))
        x = selu(self.first_bn(x, train))
        for blk in self.encoder:
            x = blk(x, train, cdtype)
        x = selu(self.first_bn1(x, train))  # [N, C, S, T']

        w = selu(self.att_conv1(x, compute_dtype=cdtype))
        w = self.att_bn(w, train)
        w = self.att_conv2(w, compute_dtype=cdtype).float()
        x32 = x.float()
        e_s = (x32 * torch.softmax(w, dim=3)).sum(dim=3).transpose(1, 2) + self.pos_S
        e_t = (x32 * torch.softmax(w, dim=2)).sum(dim=2).transpose(1, 2)  # [N, T', C]

        t_s, t_t, t_h = self.temperatures[0], self.temperatures[1], self.temperatures[2]
        r0, r1, r2 = self.pool_ratios[0], self.pool_ratios[1], self.pool_ratios[2]
        out_s = self.pool_S(self.gat_S(e_s, train, t_s, **kw()), r0, **kw())
        out_t = self.pool_T(self.gat_T(e_t, train, t_t, **kw()), r1, **kw())

        def branch(g1, g2, master, pool_s, pool_t):
            t1, s1, m1 = g1(out_t, out_s, master, train, t_h, **kw())
            s1 = pool_s(s1, r2, **kw())
            t1 = pool_t(t1, r2, **kw())
            t_aug, s_aug, m_aug = g2(t1, s1, m1, train, t_h, **kw())
            return t1 + t_aug, s1 + s_aug, m1 + m_aug

        t1, s1, m1 = branch(self.htrg_st11, self.htrg_st12, self.master1,
                            self.pool_hS1, self.pool_hT1)
        t2, s2, m2 = branch(self.htrg_st21, self.htrg_st22, self.master2,
                            self.pool_hS2, self.pool_hT2)
        def drop(v, rate):
            k = kw()
            return dropout(v, rate, k["draws"], k["generator"], k["mask"])

        t1, t2, s1, s2, m1, m2 = (drop(v, 0.2) for v in (t1, t2, s1, s2, m1, m2))
        out_t, out_s = torch.maximum(t1, t2), torch.maximum(s1, s2)
        master = torch.maximum(m1, m2)
        last_hidden = torch.cat([torch.amax(out_t.abs(), dim=1), out_t.mean(dim=1),
                                 torch.amax(out_s.abs(), dim=1), out_s.mean(dim=1),
                                 master[:, 0]], dim=1)
        last_hidden = drop(last_hidden, 0.5)
        logits = self.out_layer(last_hidden, torch.float32)
        return ModelOutput(log_probs=torch.log_softmax(logits, dim=-1),
                           feats=last_hidden[:, None, :], emb=last_hidden, logits=logits)

    forward = apply

    def eval_scores(self, out: ModelOutput) -> torch.Tensor:
        """Raw logits: the reference writes the out_layer output."""
        return out.logits

    def loss(self, out: ModelOutput, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Terms by ``loss_type`` (as ``LinearNLL.loss``), each divided by N:
        CE on the raw logits, SupCon on ``last_hidden`` as both the sequence
        and the embedding term."""
        return zoo_loss(self, out, labels, n=out.logits.shape[0])


def zoo_loss(model, out: ModelOutput, labels: torch.Tensor,
             n: int = 1) -> Dict[str, torch.Tensor]:
    """CE on the raw logits (``loss_type`` 1-4), SupCon over ``feats``
    (1, 2, 5) and over ``emb`` (1, 3, 5), each divided by ``n``."""
    labels = labels.reshape(-1).long()
    sup = dict(labels=labels, sim_metric=seq_similarity,
               temperature=model.temperature, contra_mode=model.contra_mode)
    terms: Dict[str, torch.Tensor] = {}
    if model.loss_type in (1, 2, 3, 4):
        terms["L_CE"] = cross_entropy(out.logits, labels) / n
    if model.loss_type in (1, 2, 5):
        terms["L_CF1"] = supcon_loss(out.feats[:, None].float(), **sup) / n
    if model.loss_type in (1, 3, 5):
        terms["L_CF2"] = supcon_loss(out.emb[:, None, :, None].float(), **sup) / n
    if not terms:
        raise ValueError(f"unknown loss_type: {model.loss_type}")
    return terms
