"""The benchmark's frozen arithmetic: matmul FLOPs of a forward and a train
step, the attention kernels' bytes and FLOPs, and the H100's published peaks.

The counts are a frozen copy of the port's ``utils/flops`` (PaLM appendix B
convention: 2*M*N*K per product, softmax, layer norm and GELU left out, a
train step 3x the forward, recomputation not counted), taken here so that a
later change to the program cannot move the yardstick.  The configuration
is the ``ssl`` block of a configuration file (a dict).  The AASIST head's
count covers its linear, its 2-D convs and its attention convs; the graph
layers' small products (under 0.1 % of a forward) are left out.

The attention bytes count each input read once and each output written once
(bf16 q, k, v, O, dO, dq, dK, dV; fp32 LSE and D), whatever the kernels read
again.
"""

from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM, data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989.4e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def num_frames(ssl: dict, samples: int) -> int:
    t = samples
    for _, k, s in ssl["conv_layers"]:
        t = (t - k) // s + 1
    return t


def conv_encoder_flops(ssl: dict, samples: int) -> int:
    flops, t, c_in = 0, samples, 1
    for c_out, k, s in ssl["conv_layers"]:
        t = (t - k) // s + 1
        flops += 2 * t * c_out * c_in * k
        c_in = c_out
    return flops


def encoder_flops(ssl: dict, frames: int) -> int:
    d, f, t = ssl["encoder_dim"], ssl["ffn_dim"], frames
    per_layer = 8 * t * d * d + 4 * t * t * d + 4 * t * d * f
    pos_conv = 2 * t * d * (d // ssl["pos_conv_groups"]) * ssl["pos_conv_kernel"]
    feat_proj = 2 * t * ssl["conv_layers"][-1][0] * d
    return ssl["encoder_layers"] * per_layer + pos_conv + feat_proj


def linear_nll_head_flops(ssl: dict, head: dict, frames: int) -> int:
    e = head["emb_dim"]
    return (2 * frames * ssl["encoder_dim"] * e + head["mlp_layers"] * 2 * frames * e * e
            + 2 * e * head["num_classes"])


def _aasist_blocks(filts: Sequence) -> list:
    seq = [tuple(filts[1]), tuple(filts[2]), tuple(filts[3])] + [tuple(filts[4])] * 3
    return [(seq[3][1] if i >= 4 else ci, co) for i, (ci, co) in enumerate(seq)]


def aasist_head_flops(ssl: dict, head: dict, frames: int) -> int:
    feat = head["feat_dim"]
    h, w = feat // 3, frames // 3  # after the (3, 3) max pool
    flops = 2 * frames * ssl["encoder_dim"] * feat
    for ci, co in _aasist_blocks(head["filts"]):
        flops += 2 * (h + 1) * w * co * ci * 6  # conv1 (2, 3), padded (1, 1)
        flops += 2 * h * w * co * co * 6  # conv2 (2, 3), padded (0, 1)
        if ci != co:
            flops += 2 * h * w * co * ci * 3  # downsample (1, 3)
    c = _aasist_blocks(head["filts"])[-1][1]
    return flops + 2 * (2 * h * w * 128 * c)  # att_conv1, att_conv2 (1 x 1)


HEAD_FLOPS = {"linear_nll": linear_nll_head_flops, "aasist": aasist_head_flops}


def forward_flops(cfg: dict, samples: int, batch: int = 1) -> int:
    """Matmul FLOPs of one scoring forward of ``batch`` clips of ``samples``
    samples through the configuration's frontend and head."""
    ssl, head = cfg["ssl"], cfg["head"]
    frames = num_frames(ssl, samples)
    per = (conv_encoder_flops(ssl, samples) + encoder_flops(ssl, frames)
           + HEAD_FLOPS[head["kind"]](ssl, head, frames))
    return batch * per


def train_step_flops(cfg: dict, samples: int, views: int) -> int:
    return 3 * forward_flops(cfg, samples, views)


def attention_shape(cfg: dict, batch: int, samples: int):
    ssl = cfg["ssl"]
    h = ssl["num_heads"]
    return batch, h, num_frames(ssl, samples), ssl["encoder_dim"] // h


def flash_fwd_work(b: int, h: int, t: int, d: int):
    """(bytes, FLOPs) of one attention forward: q, k, v, O in bf16, LSE fp32."""
    rows = b * h * t
    return 4 * rows * d * 2 + rows * 4, 4 * rows * t * d


def flash_bwd_work(b: int, h: int, t: int, d: int):
    """(bytes, FLOPs) of one attention backward, the dq and the dk/dv passes
    together: dq reads q, dO, O, K, V, LSE and writes dq, D; dk/dv reads q,
    dO, K, V, LSE, D and writes dK, dV."""
    rows = b * h * t
    one = 6 * rows * d * 2 + 2 * rows * 4
    return 2 * one, 6 * rows * t * d + 8 * rows * t * d


def bound_seconds(nbytes: float, flops: float) -> float:
    """The least time the chip could take: bytes or FLOPs at the peak."""
    return max(nbytes / PEAK_HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
