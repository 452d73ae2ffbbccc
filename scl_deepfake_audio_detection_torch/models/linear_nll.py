"""XLS-R + linear/MLP back-end with SupCon training: the published-best model.

Counterpart of ``LinearNLL`` in
``scl_deepfake_audio_detection_tpu/models/linear_nll.py``: SSL frame
features -> Linear 1024->emb -> ReLU -> 3 x (Linear, LeakyReLU, dropout) ->
mean-pool -> Linear emb->2 -> log_softmax.  Training keeps the pre-ReLU frame
features and the utterance embedding for the loss: a double-softmax CE plus
SupCon over frames and over embeddings, selected by ``loss_type``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models import xlsr as X
from scl_deepfake_audio_detection_torch.models.base import (
    Linear,
    ModelOutput,
    init_parameters,
)
from scl_deepfake_audio_detection_torch.ops.layers import dropout, leaky_relu
from scl_deepfake_audio_detection_torch.ops.losses import nll_on_log_probs
from scl_deepfake_audio_detection_torch.ops.supcon import seq_similarity, supcon_loss
from scl_deepfake_audio_detection_torch.utils.device import resolve_device
from scl_deepfake_audio_detection_torch.utils.registry import MODELS


class Backend(nn.Module):
    def __init__(self, emb_dim: int, num_classes: int, mlp_layers: int):
        super().__init__()
        self.frame = nn.ModuleList(Linear(emb_dim, emb_dim) for _ in range(mlp_layers))
        self.out = Linear(emb_dim, num_classes)


@MODELS.register("xlsr_linear_nll", aliases=("wav2vec2_linear_nll",))
class LinearNLL(nn.Module):
    """Parameters are made on ``device`` (the card unless the caller passes
    ``device="cpu"``) and filled from a ``torch.Generator`` seeded with
    ``seed`` (see ``init``).  On ``device="meta"`` they have shapes only."""

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
        if device.type == "meta":
            return self
        return init_parameters(self, torch.Generator(device=device).manual_seed(seed))

    def apply(self, wav: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None,
              dropout_masks: Optional[Sequence[torch.Tensor]] = None) -> ModelOutput:
        """wav [N, T_samples] -> ModelOutput (log-probs, pre-ReLU frame
        features, embedding and fp32 logits).

        In training the head's dropout draws from ``generator``, or takes
        one boolean keep-mask per frame-MLP layer from ``dropout_masks``;
        with neither it draws nothing (as the JAX package without a key).
        ``flag_fix_ssl`` runs the SSL frontend without dropout and without
        gradient (the reference's ``no_grad`` branch)."""
        cdtype = self.ssl.compute_dtype
        if self.flag_fix_ssl:
            with torch.no_grad():
                feats_ssl = self.ssl.extract_features(wav)
        else:
            feats_ssl = self.ssl.extract_features(wav, train=train, generator=generator)
        x = self.ll(feats_ssl, cdtype)  # [N, T, emb] fp32
        feats = x  # pre-ReLU frame features feed SupCon
        x = torch.relu(x)
        draws = train and (generator is not None or dropout_masks is not None)
        for i, lin in enumerate(self.backend.frame):
            x = leaky_relu(lin(x, cdtype), self.leaky_slope)
            mask = None if dropout_masks is None else dropout_masks[i]
            x = dropout(x, self.dropout, draws, generator, mask)
        emb = x.mean(dim=1)
        logits = self.backend.out(emb, cdtype).float()
        log_probs = torch.log_softmax(logits, dim=-1)
        return ModelOutput(log_probs=log_probs, feats=feats, emb=emb, logits=logits)

    forward = apply

    def loss(self, out: ModelOutput, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Named loss terms selected by ``loss_type`` (1: CE + both SupCons;
        2: CE + frames; 3: CE + embeddings; 4: CE; 5: both SupCons), each
        divided by N, the views in the group.  L_CE is the double-softmax CE
        on the log-probs."""
        n = out.log_probs.shape[0]
        labels = labels.reshape(-1).long()
        terms: Dict[str, torch.Tensor] = {}
        sup = dict(labels=labels, sim_metric=seq_similarity,
                   temperature=self.temperature, contra_mode=self.contra_mode)
        if self.loss_type in (1, 2, 3, 4):
            terms["L_CE"] = nll_on_log_probs(out.log_probs, labels) / n
        if self.loss_type in (1, 2, 5):
            terms["L_CF1"] = supcon_loss(out.feats[:, None].float(), **sup) / n
        if self.loss_type in (1, 3, 5):
            terms["L_CF2"] = supcon_loss(out.emb[:, None, :, None].float(), **sup) / n
        if not terms:
            raise ValueError(f"unknown loss_type: {self.loss_type}")
        return terms
