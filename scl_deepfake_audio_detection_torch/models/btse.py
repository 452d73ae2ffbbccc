"""BTSE: the breathing-talking-silence-conditioned back-end over SSL features.

Counterpart of ``XLSRBtse`` in ``scl_deepfake_audio_detection_tpu/models/btse.py``:
two branches fused before the classifier.

- SSL: frames -> ``ll`` (1024 -> 128; no activation after it, and its
  output is ``feats``) -> 3 x (linear, LeakyReLU, dropout 0.5) -> mean pool.
- Bio: the waveform's bio tokens (``dsp/biosegment.wav2bio``, on the
  input's device) -> ``bio_emb`` -> the encoder of ``bio_encoder_type``
  -> ``bio_scoring`` -> a vector of ``bio_out``:
  'transformer' (the reference's wiring): embedding * sqrt(bio_dim), the
  windowed rel-pos encoder (``ops/relpos_transformer``), a pointwise
  linear, the last valid step; 'gru': embedding, ``ops/rnn.gru``, its
  last hidden, a linear; 'conv': embedding plus a position table
  (``max_bio_len`` rows), GLU blocks with sqrt(0.5) residual scaling, the
  last valid step, a linear; 'light': embedding, two pointwise linears,
  a linear, the last valid step.
- Fusion: concatenated to [N, 128 + bio_out] (or, with ``is_add``,
  ``fc1`` of the SSL vector plus the bio vector), ``fc2``, log-softmax.
  ``emb`` is the fused vector in fp32.  ``mlp.out`` is a parameter of the
  JAX tree that nothing reads.

The loss is the linear-NLL family with no 1/N: CE on the log-probs (a
double softmax, as the reference), SupCon over ``feats`` and over ``emb``.
Dropout: the SSL frontend draws from ``generator``; the three frame-MLP
sites draw from it too or take one boolean keep-mask each from
``dropout_masks`` (``dropout_sites``), keys 1-3 of the JAX model's split
(key 0 is the frontend's; key 4, the bio encoder's, draws nothing at
rate 0).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from scl_deepfake_audio_detection_torch.dsp.biosegment import N_BIOS, wav2bio
from scl_deepfake_audio_detection_torch.models import xlsr as X
from scl_deepfake_audio_detection_torch.models.base import (
    Embedding,
    Linear,
    ModelOutput,
    init_parameters,
)
from scl_deepfake_audio_detection_torch.ops.layers import dropout, leaky_relu
from scl_deepfake_audio_detection_torch.ops.losses import nll_on_log_probs
from scl_deepfake_audio_detection_torch.ops.relpos_transformer import RelPosEncoder
from scl_deepfake_audio_detection_torch.ops.rnn import GRU
from scl_deepfake_audio_detection_torch.ops.supcon import seq_similarity, supcon_loss
from scl_deepfake_audio_detection_torch.utils.device import resolve_device
from scl_deepfake_audio_detection_torch.utils.registry import MODELS

BIO_ENCODERS = ("transformer", "gru", "conv", "light")


def _last_valid_step(x: torch.Tensor, bio_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x [N, T, D] -> [N, D]: the last step, or with ``bio_mask`` the step
    at each sequence's length - 1 (the first when it has none)."""
    if bio_mask is None:
        return x[:, -1]
    idx = (bio_mask.to(torch.int32).sum(dim=-1) - 1).clamp_min(0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


class MLP(nn.Module):
    def __init__(self, dim: int, num_classes: int, layers: int):
        super().__init__()
        self.frame = nn.ModuleList(Linear(dim, dim) for _ in range(layers))
        self.out = Linear(dim, num_classes)


class ConvEncoder(nn.Module):
    """conv-seq2seq with kernel-1 convs (pointwise linears)."""

    def __init__(self, dim: int, hid: int, layers: int, max_len: int):
        super().__init__()
        self.pos_emb = Embedding(max_len, dim)
        self.emb2hid, self.hid2emb = Linear(dim, hid), Linear(hid, dim)
        self.convs = nn.ModuleList(Linear(hid, 2 * hid) for _ in range(layers))


class LightEncoder(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv1, self.conv2 = Linear(dim, 256), Linear(256, 512)


@MODELS.register("xlsr_btse", aliases=("wav2vec2_btse",))
class XLSRBtse(nn.Module):
    """Parameters are made on ``device`` (the card unless the caller passes
    ``device="cpu"``) and filled from a ``torch.Generator`` seeded with
    ``seed``; on ``device="meta"`` they have shapes only."""

    def __init__(self, ssl: Optional[X.XLSRConfig] = None, feat_dim: int = 128,
                 mlp_layers: int = 3, mlp_dropout: float = 0.5, num_classes: int = 2,
                 n_bios: int = N_BIOS, bio_dim: int = 32, bio_out: int = 64,
                 pf_dim: int = 128, n_heads: int = 4, n_layers: int = 3,
                 window_size: int = 4, bio_encoder_type: str = "transformer",
                 bio_rnn: int = 64, bio_hid: int = 256, max_bio_len: int = 300,
                 is_add: bool = False, flag_fix_ssl: bool = False, contra_mode: str = "all",
                 loss_type: int = 1, temperature: float = 0.07,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        super().__init__()
        if bio_encoder_type not in BIO_ENCODERS:
            raise ValueError(f"unknown bio_encoder_type: {bio_encoder_type!r}")
        ssl = ssl or X.XLSRConfig.xlsr_300m()
        self.feat_dim, self.mlp_dropout, self.num_classes = feat_dim, mlp_dropout, num_classes
        self.bio_dim, self.bio_encoder_type, self.is_add = bio_dim, bio_encoder_type, is_add
        self.max_bio_len = max_bio_len
        self.flag_fix_ssl, self.contra_mode = flag_fix_ssl, contra_mode
        self.loss_type, self.temperature = loss_type, temperature
        with torch.device(resolve_device(device)):
            self.ssl = X.XLSR(ssl)
            self.ll = Linear(ssl.out_dim, feat_dim)
            self.mlp = MLP(feat_dim, num_classes, mlp_layers)
            self.bio_emb = Embedding(n_bios, bio_dim, std=bio_dim ** -0.5)
            if bio_encoder_type == "transformer":
                self.bio_encoder = RelPosEncoder(bio_dim, pf_dim, n_heads, n_layers, window_size)
                enc_out = bio_dim
            elif bio_encoder_type == "gru":
                self.bio_encoder, enc_out = GRU(bio_dim, bio_rnn), bio_rnn
            elif bio_encoder_type == "conv":
                self.bio_encoder = ConvEncoder(bio_dim, bio_hid, n_layers, max_bio_len)
                enc_out = bio_dim
            else:
                self.bio_encoder, enc_out = LightEncoder(bio_dim), 512
            self.bio_scoring = Linear(enc_out, bio_out)
            if is_add:
                self.fc1 = Linear(feat_dim, bio_out)
                self.fc2 = Linear(bio_out, num_classes)
            else:
                self.fc2 = Linear(feat_dim + bio_out, num_classes)
        self.init(seed)

    @classmethod
    def from_config(cls, model_cfg, ssl: Optional[X.XLSRConfig] = None, **kw) -> "XLSRBtse":
        """Build from a ``utils.config.ModelConfig``: the bio encoder's keys
        from its ``extra`` (conf-5's values where absent)."""
        ex = dict(getattr(model_cfg, "extra", {}) or {})
        return cls(ssl=ssl or X.XLSRConfig.xlsr_300m(),
                   n_bios=int(ex.get("n_bios", N_BIOS)),
                   bio_dim=int(ex.get("bio_dim", 32)),
                   bio_out=int(ex.get("bio_out", 64)),
                   pf_dim=int(ex.get("pf_dim", 128)),
                   n_heads=int(ex.get("n_heads", 4)),
                   n_layers=int(ex.get("n_layers", 3)),
                   num_classes=int(ex.get("nb_classes", 2)),
                   bio_encoder_type=str(ex.get("bio_encoder_type", "transformer")),
                   bio_rnn=int(ex.get("bio_rnn", 64)),
                   bio_hid=int(ex.get("bio_hid", 256)),
                   is_add=bool(ex.get("is_add", False)),
                   flag_fix_ssl=bool(model_cfg.flag_fix_ssl),
                   contra_mode=model_cfg.contra_mode,
                   loss_type=int(model_cfg.loss_type), **kw)

    def init(self, seed: int) -> "XLSRBtse":
        """Fill every parameter from a ``torch.Generator`` on the model's
        device seeded with ``seed``."""
        device = self.ll.weight.device
        if device.type == "meta":
            return self
        return init_parameters(self, torch.Generator(device=device).manual_seed(seed))

    def dropout_sites(self, n: int, num_samples: int) -> List[Tuple[float, Tuple[int, ...]]]:
        """(rate, shape) of the frame MLP's dropout sites for ``n`` clips of
        ``num_samples`` samples, in the order of ``dropout_masks``."""
        t = self.ssl.cfg.num_frames(num_samples)
        return [(self.mlp_dropout, (n, t, self.feat_dim))] * len(self.mlp.frame)

    def bio_scoring_vector(self, bio: torch.Tensor,
                           bio_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """bio int tokens [N, T_bio] -> the conditioning vector [N, bio_out]
        (``bio_scoring`` of the JAX model)."""
        kind, enc = self.bio_encoder_type, self.bio_encoder
        if kind == "transformer":
            x = self.bio_emb(bio)
            # sqrt(bio_dim) rounded to the table's dtype first (a bf16 table
            # after ``cast_matmul_params``), as the JAX package's weak scalar
            x = enc(x * x.new_full((), self.bio_dim ** 0.5), bio_mask)
            scores = self.bio_scoring(x)  # [N, T_bio, bio_out]
            if bio_mask is not None:
                scores = scores * bio_mask.to(scores.dtype)[..., None]
            return _last_valid_step(scores, bio_mask)
        if kind == "gru":
            lengths = None if bio_mask is None else bio_mask.sum(dim=-1).to(torch.int32)
            _, h_last = enc(self.bio_emb(bio), lengths=lengths)
            return self.bio_scoring(h_last)
        if kind == "conv":
            t = bio.shape[1]
            if t > self.max_bio_len:  # the JAX table's take reads NaN rows there
                raise ValueError(f"the 'conv' bio encoder's position table has "
                                 f"{self.max_bio_len} rows; {t} bio tokens "
                                 f"({t * 320} samples at 16 kHz) need more")
            x = self.bio_emb(bio) + enc.pos_emb(torch.arange(t, device=bio.device))
            h = enc.emb2hid(x)
            scale = 0.5 ** 0.5
            for conv in enc.convs:
                a, g = conv(h).chunk(2, dim=-1)
                h = (a * torch.sigmoid(g) + h) * scale
            x = (enc.hid2emb(h) + x) * scale
            return self.bio_scoring(_last_valid_step(x, bio_mask))
        x = enc.conv2(enc.conv1(self.bio_emb(bio)))
        return _last_valid_step(self.bio_scoring(x), bio_mask)

    def apply(self, wav: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None,
              dropout_masks: Optional[Sequence[torch.Tensor]] = None,
              bio: Optional[torch.Tensor] = None,
              bio_mask: Optional[torch.Tensor] = None) -> ModelOutput:
        """wav [N, T_samples] (or [N, T_samples, 1]) -> ModelOutput.  The bio
        tokens are the waveform's (``wav2bio``) unless ``bio`` is given,
        with ``bio_mask`` [N, T_bio] (1 = valid) for variable lengths."""
        if wav.ndim == 3:
            wav = wav[:, :, 0]
        if bio is None:
            bio = wav2bio(wav)
        cdtype = self.ssl.compute_dtype
        if self.flag_fix_ssl:
            with torch.no_grad():
                feats_ssl = self.ssl.extract_features(wav)
        else:
            feats_ssl = self.ssl.extract_features(wav, train=train, generator=generator)
        feats = self.ll(feats_ssl, cdtype)  # [N, T, feat] fp32
        x = feats
        draws = train and (generator is not None or dropout_masks is not None)
        for i, lin in enumerate(self.mlp.frame):
            x = leaky_relu(lin(x, cdtype))
            mask = None if dropout_masks is None else dropout_masks[i]
            x = dropout(x, self.mlp_dropout, draws, generator, mask)
        emb_ssl = x.mean(dim=1)
        bio_vec = self.bio_scoring_vector(bio, bio_mask)
        if self.is_add:
            fused = self.fc1(emb_ssl, cdtype) + bio_vec
        else:
            fused = torch.cat([emb_ssl, bio_vec.to(emb_ssl.dtype)], dim=1)
        logits = self.fc2(fused, torch.float32)
        return ModelOutput(log_probs=torch.log_softmax(logits, dim=-1), feats=feats,
                           emb=fused.float(), logits=logits)

    forward = apply

    def loss(self, out: ModelOutput, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Terms by ``loss_type`` (1: CE + both SupCons; 2: CE + frames; 3:
        CE + embeddings; 4: CE; 5: both SupCons), not divided by N."""
        labels = labels.reshape(-1).long()
        sup = dict(labels=labels, sim_metric=seq_similarity,
                   temperature=self.temperature, contra_mode=self.contra_mode)
        terms: Dict[str, torch.Tensor] = {}
        if self.loss_type in (1, 2, 3, 4):
            terms["L_CE"] = nll_on_log_probs(out.log_probs, labels)
        if self.loss_type in (1, 2, 5):
            terms["L_CF1"] = supcon_loss(out.feats[:, None].float(), **sup)
        if self.loss_type in (1, 3, 5):
            terms["L_CF2"] = supcon_loss(out.emb[:, None, :, None].float(), **sup)
        if not terms:
            raise ValueError(f"unknown loss_type: {self.loss_type}")
        return terms
