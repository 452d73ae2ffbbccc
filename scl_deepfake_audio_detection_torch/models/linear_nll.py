"""XLS-R + linear/MLP back-end: the published-best model, at eval.

Counterpart of ``LinearNLL`` in
``scl_deepfake_audio_detection_tpu/models/linear_nll.py``: SSL frame
features -> Linear 1024->emb -> ReLU -> 3 x (Linear, LeakyReLU) -> mean-pool
-> Linear emb->2 -> log_softmax.  The loss comes with the training slice.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models import xlsr as X
from scl_deepfake_audio_detection_torch.models.base import (
    Linear,
    ModelOutput,
    init_parameters,
)
from scl_deepfake_audio_detection_torch.ops.layers import leaky_relu
from scl_deepfake_audio_detection_torch.utils.device import resolve_device


class Backend(nn.Module):
    def __init__(self, emb_dim: int, num_classes: int, mlp_layers: int):
        super().__init__()
        self.frame = nn.ModuleList(Linear(emb_dim, emb_dim) for _ in range(mlp_layers))
        self.out = Linear(emb_dim, num_classes)


class LinearNLL(nn.Module):
    """Parameters are made on ``device`` (the card unless the caller passes
    ``device="cpu"``) and filled from a ``torch.Generator`` seeded with
    ``seed`` (see ``init``)."""

    def __init__(self, ssl: Optional[X.XLSRConfig] = None, emb_dim: int = 128,
                 num_classes: int = 2, mlp_layers: int = 3, dropout: float = 0.5,
                 leaky_slope: float = 0.01, flag_fix_ssl: bool = False,
                 contra_mode: str = "all", loss_type: int = 1,
                 temperature: float = 0.07,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        super().__init__()
        ssl = ssl or X.XLSRConfig.xlsr_300m()
        self.emb_dim, self.num_classes = emb_dim, num_classes
        self.dropout, self.leaky_slope = dropout, leaky_slope
        # training-only settings, carried for config parity
        self.flag_fix_ssl, self.contra_mode = flag_fix_ssl, contra_mode
        self.loss_type, self.temperature = loss_type, temperature
        with torch.device(resolve_device(device)):
            self.ssl = X.XLSR(ssl)
            self.ll = Linear(ssl.out_dim, emb_dim)
            self.backend = Backend(emb_dim, num_classes, mlp_layers)
        self.init(seed)

    @classmethod
    def from_config(cls, model_cfg, ssl: Optional[X.XLSRConfig] = None,
                    **kw) -> "LinearNLL":
        """Build from a ``utils.config.ModelConfig`` (reference YAML schema)."""
        return cls(ssl=ssl or X.XLSRConfig.xlsr_300m(),
                   flag_fix_ssl=bool(model_cfg.flag_fix_ssl),
                   contra_mode=model_cfg.contra_mode,
                   loss_type=int(model_cfg.loss_type), **kw)

    def init(self, seed: int) -> "LinearNLL":
        """Fill every parameter from a ``torch.Generator`` on the model's
        device seeded with ``seed``."""
        device = self.ll.weight.device
        return init_parameters(self, torch.Generator(device=device).manual_seed(seed))

    def apply(self, wav: torch.Tensor, train: bool = False) -> ModelOutput:
        """wav [N, T_samples] -> ModelOutput (eval only)."""
        if train:
            raise NotImplementedError("LinearNLL training not ported yet")
        cdtype = self.ssl.compute_dtype
        feats_ssl = self.ssl.extract_features(wav)
        x = self.ll(feats_ssl, cdtype)  # [N, T, emb] fp32
        feats = x  # pre-ReLU frame features
        x = torch.relu(x)
        for lin in self.backend.frame:
            x = leaky_relu(lin(x, cdtype), self.leaky_slope)
        emb = x.mean(dim=1)
        logits = self.backend.out(emb, cdtype).float()
        log_probs = torch.log_softmax(logits, dim=-1)
        return ModelOutput(log_probs=log_probs, feats=feats, emb=emb, logits=logits)

    forward = apply
