"""Pre-activation ResNet back-end over SSL features.

Counterpart of ``scl_deepfake_audio_detection_tpu/models/resnet.py``: SSL
frames ``[N, T, 1024]`` -> Linear to 128 -> a one-channel image -> batch
norm, SELU -> stem conv (9x3, stride (3, 1)) -> four pre-activation stages
(widths 64 / 128 / 256 / 512, strides 1 / 2 / 2 / 2; basic blocks, or
bottlenecks for depths 50 and 101, ``RESNET_CONFIGS``) -> conv5
((num_nodes)x3) -> batch norm, ReLU -> global average pool -> the
``enc_dim`` embedding -> logits.

The image is NCHW, [N, 1, time, feature], where the JAX package's is NHWC
[N, time, feature, 1].  Convs run in the compute dtype (cuDNN on the
card), batch norm in fp32 with its running statistics in the
``BatchNorm`` buffers.  The output carries the raw logits
(``eval_scores``) and ``log_probs`` = log_softmax(logits); the loss terms
are not divided by N, as the reference's ResNet wrappers leave them.
``self_attention_pool`` is the reference's attentive statistics pooling,
which the wrappers do not call.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models import xlsr as X
from scl_deepfake_audio_detection_torch.models.aasist import zoo_loss
from scl_deepfake_audio_detection_torch.models.base import (
    BatchNorm,
    Conv2d,
    Linear,
    ModelOutput,
    init_parameters,
)
from scl_deepfake_audio_detection_torch.ops.layers import selu
from scl_deepfake_audio_detection_torch.utils.device import resolve_device
from scl_deepfake_audio_detection_torch.utils.registry import MODELS

# depth -> (blocks per stage, bottleneck?); '28' is the reference's alias
# for the [3, 4, 6, 3] basic-block layout
RESNET_CONFIGS: Dict[str, Tuple[Tuple[int, int, int, int], bool]] = {
    "18": ((2, 2, 2, 2), False),
    "28": ((3, 4, 6, 3), False),
    "34": ((3, 4, 6, 3), False),
    "50": ((3, 4, 6, 3), True),
    "101": ((3, 4, 23, 3), True),
}

STAGE_WIDTHS = (64, 128, 256, 512)

_PAD1 = [(1, 1), (1, 1)]


class PreActBlock(nn.Module):
    """Basic: BN-ReLU-conv3x3 twice; bottleneck: BN-ReLU-conv1x1 / 3x3 /
    1x1 with 4x expansion.  A 1x1 projection shortcut where the channels
    change, else the input (strided where the block strides)."""

    def __init__(self, in_c: int, planes: int, bottleneck: bool):
        super().__init__()
        out_c = planes * (4 if bottleneck else 1)
        self.bottleneck = bottleneck
        self.bn1 = BatchNorm(in_c)
        if bottleneck:
            self.conv1 = Conv2d(in_c, planes, 1, bias=False)
            self.bn2 = BatchNorm(planes)
            self.conv2 = Conv2d(planes, planes, 3, bias=False)
            self.bn3 = BatchNorm(planes)
            self.conv3 = Conv2d(planes, out_c, 1, bias=False)
        else:
            self.conv1 = Conv2d(in_c, planes, 3, bias=False)
            self.bn2 = BatchNorm(planes)
            self.conv2 = Conv2d(planes, planes, 3, bias=False)
        self.shortcut = Conv2d(in_c, out_c, 1, bias=False) if in_c != out_c else None

    def forward(self, x: torch.Tensor, stride: int, train: bool,
                cdtype: torch.dtype) -> torch.Tensor:
        s = (stride, stride)
        out = torch.relu(self.bn1(x, train))
        if self.shortcut is not None:
            shortcut = self.shortcut(out, stride=s, compute_dtype=cdtype)
        else:
            shortcut = x if stride == 1 else x[:, :, ::stride, ::stride]
        if self.bottleneck:
            out = self.conv1(out, compute_dtype=cdtype)
            out = self.conv2(torch.relu(self.bn2(out, train)), stride=s, padding=_PAD1,
                             compute_dtype=cdtype)
            out = self.conv3(torch.relu(self.bn3(out, train)), compute_dtype=cdtype)
        else:
            out = self.conv1(out, stride=s, padding=_PAD1, compute_dtype=cdtype)
            out = self.conv2(torch.relu(self.bn2(out, train)), padding=_PAD1,
                             compute_dtype=cdtype)
        return out + shortcut.to(out.dtype)


class ResNet(nn.Module):
    """The backbone: x [B, 1, H, W] -> (fp32 logits [B, C], emb [B, enc_dim])."""

    def __init__(self, resnet_type: str = "18", num_nodes: int = 3, enc_dim: int = 256,
                 nclasses: int = 2):
        super().__init__()
        stages, bottleneck = RESNET_CONFIGS[resnet_type]
        self.conv1 = Conv2d(1, 16, (9, 3), bias=False)
        self.bn1 = BatchNorm(16)
        in_c = 16
        for si, (planes, blocks) in enumerate(zip(STAGE_WIDTHS, stages)):
            layer = nn.ModuleList()
            for _ in range(blocks):
                layer.append(PreActBlock(in_c, planes, bottleneck))
                in_c = planes * (4 if bottleneck else 1)
            setattr(self, f"layer{si + 1}", layer)
        self.conv5 = Conv2d(in_c, enc_dim, (num_nodes, 3), bias=False)
        self.bn5 = BatchNorm(enc_dim)
        self.fc = Linear(enc_dim, nclasses)

    def forward(self, x: torch.Tensor, train: bool,
                cdtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.conv1(x, stride=(3, 1), padding=_PAD1, compute_dtype=cdtype)
        x = torch.relu(self.bn1(x, train))
        for si in range(4):
            for bi, blk in enumerate(getattr(self, f"layer{si + 1}")):
                x = blk(x, 1 if (si == 0 or bi > 0) else 2, train, cdtype)
        x = self.conv5(x, padding=[(0, 0), (1, 1)], compute_dtype=cdtype)
        x = torch.relu(self.bn5(x, train))
        emb = x.mean(dim=(2, 3))  # adaptive average pool (1, 1), flattened
        return self.fc(emb, cdtype).float(), emb


def self_attention_pool(w: torch.Tensor, x: torch.Tensor, mean_only: bool = False,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, D], w [D]: softmax(tanh(x @ w)) over time; the weighted sum,
    or [sum, std] (std over the weighted sequence, ddof 1, with ``noise``
    [B, T, D] scaled by 1e-5 added first, as the reference adds it)."""
    att = torch.softmax(torch.tanh(x @ w), dim=1)
    weighted = x * att[..., None]
    avg = weighted.sum(dim=1)
    if mean_only:
        return avg
    noisy = weighted if noise is None else weighted + 1e-5 * noise
    return torch.cat([avg, noisy.std(dim=1, correction=1)], dim=1)


@MODELS.register("xlsr_resnet", aliases=("wav2vec2_resnet", "wav2vec2_resnet_nll",
                                         "xlsr_resnet_nll"))
class XLSRResNet(nn.Module):
    """XLS-R frontend + pre-activation ResNet classifier (both reference
    wrappers: they share the math, ``flag_fix_ssl`` is the _nll variant's
    frozen frontend).  Parameters are made on ``device`` (the card unless
    the caller passes ``device="cpu"``) and filled from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, ssl: Optional[X.XLSRConfig] = None, resnet_type: str = "18",
                 num_nodes: int = 3, enc_dim: int = 256, num_classes: int = 2,
                 feat_dim: int = 128, flag_fix_ssl: bool = False, contra_mode: str = "all",
                 loss_type: int = 1, temperature: float = 0.07,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        super().__init__()
        ssl = ssl or X.XLSRConfig.xlsr_300m()
        self.resnet_type, self.num_nodes, self.enc_dim = str(resnet_type), num_nodes, enc_dim
        self.num_classes, self.feat_dim = num_classes, feat_dim
        self.flag_fix_ssl, self.contra_mode = flag_fix_ssl, contra_mode
        self.loss_type, self.temperature = loss_type, temperature
        with torch.device(resolve_device(device)):
            self.ssl = X.XLSR(ssl)
            self.ll = Linear(ssl.out_dim, feat_dim)
            self.first_bn = BatchNorm(1)
            self.resnet = ResNet(self.resnet_type, num_nodes, enc_dim, num_classes)
        self.init(seed)

    @classmethod
    def from_config(cls, model_cfg, ssl: Optional[X.XLSRConfig] = None,
                    **kw) -> "XLSRResNet":
        """Build from a ``utils.config.ModelConfig``; its ``resnet:`` block
        (``resnet_type``, ``num_nodes``, ``enc_dim``, ``nclasses``) sets the
        backbone, ResNet-18 at the defaults where it is absent."""
        rn = dict(getattr(model_cfg, "extra", {}) or {}).get("resnet", {})
        return cls(ssl=ssl or X.XLSRConfig.xlsr_300m(),
                   resnet_type=str(rn.get("resnet_type", "18")),
                   num_nodes=int(rn.get("num_nodes", 3)),
                   enc_dim=int(rn.get("enc_dim", 256)),
                   num_classes=int(rn.get("nclasses", 2)),
                   flag_fix_ssl=bool(model_cfg.flag_fix_ssl),
                   contra_mode=model_cfg.contra_mode,
                   loss_type=int(model_cfg.loss_type), **kw)

    def init(self, seed: int) -> "XLSRResNet":
        """Fill every parameter from a ``torch.Generator`` on the model's
        device seeded with ``seed``; the running statistics start at mean 0,
        var 1."""
        device = self.ll.weight.device
        if device.type == "meta":
            return self
        return init_parameters(self, torch.Generator(device=device).manual_seed(seed))

    def apply(self, wav: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None,
              dropout_masks: Optional[Sequence[torch.Tensor]] = None) -> ModelOutput:
        """wav [N, T_samples] -> ModelOutput.  The head has no dropout, so
        ``dropout_masks`` must be empty.  Training normalises with the
        batch's statistics and moves the running ones once."""
        if dropout_masks:
            raise ValueError("the ResNet head has no dropout site")
        cdtype = self.ssl.compute_dtype
        if self.flag_fix_ssl:
            with torch.no_grad():
                feats_ssl = self.ssl.extract_features(wav)
        else:
            feats_ssl = self.ssl.extract_features(wav, train=train, generator=generator)
        feats = self.ll(feats_ssl, cdtype)  # [N, T, feat] fp32
        x = selu(self.first_bn(feats[:, None], train))  # the image [N, 1, T, feat]
        logits, emb = self.resnet(x, train, cdtype)
        return ModelOutput(log_probs=torch.log_softmax(logits, dim=-1), feats=feats,
                           emb=emb, logits=logits)

    forward = apply

    def eval_scores(self, out: ModelOutput) -> torch.Tensor:
        """Raw logits: the reference's ResNet wrappers return the fc output."""
        return out.logits

    def loss(self, out: ModelOutput, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Terms by ``loss_type`` (CE on the raw logits, SupCon over the
        frame features and over the embedding), not divided by N."""
        return zoo_loss(self, out, labels)
