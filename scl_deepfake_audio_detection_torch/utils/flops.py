"""Analytic FLOP counts for the flagship scoring/training shapes.

Counterpart of ``scl_deepfake_audio_detection_tpu/utils/flops.py``: the
counts are the same code over the same ``XLSRConfig`` fields, so both
packages give the same number for a shape.  They turn measured rates
(``utils/measure``) into MFU (model FLOPs utilization).  Counts follow the
standard MFU convention (PaLM appendix B): matmul/conv FLOPs only (2·M·N·K
per GEMM), softmax/LN/GELU excluded, and for training the theoretical
fwd+bwd cost (3x the forward's matmul FLOPs) — remat recompute is NOT
counted (that would be HFU, hardware FLOPs utilization).

The denominator is the PUBLISHED dense bf16 peak of the NVIDIA H100 SXM
(989.4 TFLOP/s, NVIDIA's data sheet), the standard MFU convention, so the
numbers compare across cards and papers.  For calibration,
``MEASURED_ATTAINABLE_H100_BF16_FLOPS`` is the rate of a chained bf16
``torch.matmul`` of [16384, 4096] x [4096, 4096] that ``chip_smoke.py``
(``phase_tools``) measured on an NVIDIA H100 80GB HBM3 at a 700 W power
limit; ``chip_smoke.py`` measures it again in every run and prints both.
"""

from __future__ import annotations

# Published H100 SXM dense bf16 peak — the MFU denominator (standard convention).
PUBLISHED_H100_BF16_PEAK_FLOPS = 989.4e12
# Attainable big-GEMM bf16 rate, measured by chip_smoke.py's phase_tools on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit (re-measure on another card).
MEASURED_ATTAINABLE_H100_BF16_FLOPS = 690.41e12


def conv_encoder_flops(cfg, samples: int) -> int:
    """Matmul-equivalent FLOPs of the wav2vec2 conv feature extractor for
    ONE utterance of ``samples`` samples (reference model/xlsr.py:18-20 via
    fairseq ConvFeatureExtractionModel): 2·T_out·C_out·C_in·K per layer."""
    flops = 0
    t, c_in = samples, 1
    for c_out, k, s in cfg.conv_layers:
        t = (t - k) // s + 1
        flops += 2 * t * c_out * c_in * k
        c_in = c_out
    return flops


def encoder_flops(cfg, frames: int) -> int:
    """Matmul FLOPs of the transformer encoder stack for one utterance at
    ``frames`` frames: per layer 4 projections (8·T·D^2), scores + AV
    einsums (4·T^2·D), and the FFN pair (4·T·D·F); plus the grouped
    positional conv and the 512->D feature projection once."""
    d, f = cfg.encoder_dim, cfg.ffn_dim
    t = frames
    per_layer = 8 * t * d * d + 4 * t * t * d + 4 * t * d * f
    pos_conv = 2 * t * d * (d // cfg.pos_conv_groups) * cfg.pos_conv_kernel
    feat_proj = 2 * t * cfg.conv_layers[-1][0] * d
    return cfg.encoder_layers * per_layer + pos_conv + feat_proj


def linear_nll_head_flops(cfg, frames: int,
                          emb_dim: int = 128, mlp_layers: int = 3,
                          num_classes: int = 2) -> int:
    """Matmul FLOPs of the LinearNLL head (models/linear_nll.py) for one
    utterance: LL D->128, 3-layer 128->128 frame MLP, 128->classes out."""
    t = frames
    return (2 * t * cfg.out_dim * emb_dim
            + mlp_layers * 2 * t * emb_dim * emb_dim
            + 2 * emb_dim * num_classes)


def forward_flops(cfg, samples: int, batch: int = 1,
                  include_head: bool = True) -> int:
    """Total matmul FLOPs of one scoring forward at [batch, samples]."""
    frames = cfg.num_frames(samples)
    per_item = conv_encoder_flops(cfg, samples) + encoder_flops(cfg, frames)
    if include_head:
        per_item += linear_nll_head_flops(cfg, frames)
    return batch * per_item


def train_step_flops(cfg, samples: int, views: int) -> int:
    """Theoretical matmul FLOPs of one train step over ``views`` utterances
    (groups x views flattened): 3x the forward under the standard MFU
    convention (bwd = 2x fwd; remat recompute excluded by definition)."""
    return 3 * forward_flops(cfg, samples, batch=views)


def mfu(flops: int, seconds: float,
        peak: float = PUBLISHED_H100_BF16_PEAK_FLOPS) -> float:
    """Fraction of peak: (analytic FLOPs / measured seconds) / peak."""
    return flops / seconds / peak
