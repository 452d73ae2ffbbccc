"""Plain float32 reference of XLS-R + the SSL-AASIST head (Tak et al.,
"Automatic speaker verification spoofing and deepfake detection using
wav2vec 2.0 and data augmentation", Odyssey 2022;
github.com/TakHemlata/SSL_Anti-spoofing), eval mode.

The frame features go through a linear to ``feat_dim`` and form an image
[N, 1, feature, time]; a (3, 3) max pool, batch norm and SELU; six residual
blocks (conv (2, 3) padded (1, 1), batch norm, SELU, conv (2, 3) padded
(0, 1), plus the input through a (1, 3) conv where the channels change);
batch norm and SELU; the spectral and temporal attention pools; graph
attention over each node set and top-k graph pooling; two heterogeneous
graph-attention branches with master nodes; the element-wise max of the
branches; the readout [max |T|, mean T, max |S|, mean S, master] and the
output linear.  Scores are the raw logits, as the recipe writes them.
Batch norm in eval reads the running statistics.  The graph attention is
softmax-normalised over the output node axis, as the published code has
it; top-k pooling keeps the highest sigmoid scores, ties to the lower index.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.common import Ops, linear_spec, ssl_forward, ssl_spec


def _blocks(filts):
    seq = [tuple(filts[1]), tuple(filts[2]), tuple(filts[3])] + [tuple(filts[4])] * 3
    return [(seq[3][1] if i >= 4 else ci, co) for i, (ci, co) in enumerate(seq)]


def _bn_spec(name, c):
    return [(name + ".weight", (c,), "one"), (name + ".bias", (c,), "zero"),
            (name + ".mean", (c,), "zero"), (name + ".var", (c,), "one")]


def _conv2d_spec(name, ci, co, kh, kw):
    return [(name + ".weight", (co, ci, kh, kw), "fan_in"),
            (name + ".bias", (co,), f"fan_in:{name}.weight")]


def _gat_spec(name, d_in, d_out):
    return ([(name + ".att_weight", (d_out, 1), "xavier")]
            + linear_spec(name + ".att_proj", d_in, d_out)
            + linear_spec(name + ".proj_with_att", d_in, d_out)
            + linear_spec(name + ".proj_without_att", d_in, d_out) + _bn_spec(name + ".bn", d_out))


def _htrg_spec(name, d_in, d_out):
    spec = [(f"{name}.att_weight{s}", (d_out, 1), "xavier") for s in ("11", "22", "12", "M")]
    spec += linear_spec(name + ".proj_type1", d_in, d_in) + linear_spec(name + ".proj_type2", d_in, d_in)
    for n in ("att_proj", "att_projM", "proj_with_att", "proj_without_att", "proj_with_attM",
              "proj_without_attM"):
        spec += linear_spec(f"{name}.{n}", d_in, d_out)
    return spec + _bn_spec(name + ".bn", d_out)


def param_spec(cfg: dict):
    ssl, head = cfg["ssl"], cfg["head"]
    feat, (g0, g1) = head["feat_dim"], head["gat_dims"]
    blocks = _blocks(head["filts"])
    c = blocks[-1][1]
    spec = ssl_spec(ssl) + [("pos_S", (1, feat // 3, c), "unit"), ("master1", (1, 1, g0), "unit"),
                            ("master2", (1, 1, g0), "unit")]
    spec += linear_spec("ll", ssl["encoder_dim"], feat) + _bn_spec("first_bn", 1)
    for i, (ci, co) in enumerate(blocks):
        p = f"encoder.{i}."
        spec += _conv2d_spec(p + "conv1", ci, co, 2, 3) + _bn_spec(p + "bn2", co)
        spec += _conv2d_spec(p + "conv2", co, co, 2, 3)
        if ci != co:
            spec += _conv2d_spec(p + "downsample", ci, co, 1, 3)
    spec += _bn_spec("first_bn1", c) + _conv2d_spec("att_conv1", c, 128, 1, 1)
    spec += _bn_spec("att_bn", 128) + _conv2d_spec("att_conv2", 128, c, 1, 1)
    spec += _gat_spec("gat_S", c, g0) + _gat_spec("gat_T", c, g0)
    for n in ("S", "T"):
        spec += linear_spec(f"pool_{n}.proj", g0, 1)
    for n in ("hS1", "hT1", "hS2", "hT2"):
        spec += linear_spec(f"pool_{n}.proj", g1, 1)
    spec += _htrg_spec("htrg_st11", g0, g1) + _htrg_spec("htrg_st12", g1, g1)
    spec += _htrg_spec("htrg_st21", g0, g1) + _htrg_spec("htrg_st22", g1, g1)
    return spec + linear_spec("out_layer", 5 * g1, head["num_classes"])


def _bn(P, name, x, eps=1e-5):
    """Eval batch norm over channel axis 1 of x [N, C, ...]."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    inv = torch.rsqrt(P[name + ".var"] + eps).view(shape)
    return (x - P[name + ".mean"].view(shape)) * inv * P[name + ".weight"].view(shape) \
        + P[name + ".bias"].view(shape)


def _node_bn(P, name, y):
    return _bn(P, name, y.reshape(-1, y.shape[-1])).reshape(y.shape)


def _lin(ops, P, name, x):
    return ops.linear(x, P[name + ".weight"], P[name + ".bias"])


def _gat(ops, P, name, x, temp):
    pair = torch.tanh(_lin(ops, P, name + ".att_proj", x[:, :, None, :] * x[:, None, :, :]))
    att = torch.softmax(ops.matmul(pair, P[name + ".att_weight"])[..., 0] / temp, dim=1)
    y = _lin(ops, P, name + ".proj_with_att", ops.matmul(att, x)) \
        + _lin(ops, P, name + ".proj_without_att", x)
    return F.selu(_node_bn(P, name + ".bn", y))


def _htrg(ops, P, name, x1, x2, master, temp):
    n1 = x1.shape[1]
    x = torch.cat([_lin(ops, P, name + ".proj_type1", x1), _lin(ops, P, name + ".proj_type2", x2)], 1)
    n = x.shape[1]
    master = master.expand(x.shape[0], 1, master.shape[-1])
    pair = torch.tanh(_lin(ops, P, name + ".att_proj", x[:, :, None, :] * x[:, None, :, :]))
    is1 = (torch.arange(n, device=x.device) < n1).float()
    b11 = is1[:, None] * is1[None, :]
    b22 = (1 - is1)[:, None] * (1 - is1)[None, :]
    s = {k: ops.matmul(pair, P[f"{name}.att_weight{k}"])[..., 0] for k in ("11", "22", "12")}
    scores = s["11"] * b11 + s["22"] * b22 + s["12"] * (1.0 - b11 - b22)
    att = torch.softmax(scores / temp, dim=1)
    pair_m = torch.tanh(_lin(ops, P, name + ".att_projM", x * master))
    att_m = torch.softmax(ops.matmul(pair_m, P[name + ".att_weightM"]) / temp, dim=1)
    m_att = ops.matmul(att_m.transpose(1, 2), x)
    new_master = _lin(ops, P, name + ".proj_with_attM", m_att) \
        + _lin(ops, P, name + ".proj_without_attM", master)
    y = _lin(ops, P, name + ".proj_with_att", ops.matmul(att, x)) \
        + _lin(ops, P, name + ".proj_without_att", x)
    y = F.selu(_node_bn(P, name + ".bn", y))
    return y[:, :n1], y[:, n1:], new_master


def _pool(ops, P, name, h, k):
    scores = torch.sigmoid(_lin(ops, P, name + ".proj", h))[..., 0]
    kk = max(int(h.shape[1] * k), 1)
    idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :kk]
    return (h * scores[..., None]).gather(1, idx[..., None].expand(-1, -1, h.shape[-1]))


def scores(P: Dict[str, torch.Tensor], wav: torch.Tensor, cfg: dict, ops: Ops) -> torch.Tensor:
    head = cfg["head"]
    feats = _lin(ops, P, "ll", ssl_forward(P, wav, cfg, ops))
    x = F.max_pool2d(feats.transpose(1, 2)[:, None], (3, 3))
    x = F.selu(_bn(P, "first_bn", x))
    for i, (ci, co) in enumerate(_blocks(head["filts"])):
        p = f"encoder.{i}."
        out = ops.conv2d(x, P[p + "conv1.weight"], P[p + "conv1.bias"], (1, 1, 1, 1))
        out = ops.conv2d(F.selu(_bn(P, p + "bn2", out)), P[p + "conv2.weight"],
                         P[p + "conv2.bias"], (0, 0, 1, 1))
        idn = x if ci == co else ops.conv2d(x, P[p + "downsample.weight"],
                                            P[p + "downsample.bias"], (0, 0, 1, 1))
        x = out + idn
    x = F.selu(_bn(P, "first_bn1", x))
    w = _bn(P, "att_bn", F.selu(ops.conv2d(x, P["att_conv1.weight"], P["att_conv1.bias"])))
    w = ops.conv2d(w, P["att_conv2.weight"], P["att_conv2.bias"])
    e_s = (x * torch.softmax(w, dim=3)).sum(dim=3).transpose(1, 2) + P["pos_S"]
    e_t = (x * torch.softmax(w, dim=2)).sum(dim=2).transpose(1, 2)
    (t_s, t_t, t_h, _), (r0, r1, r2, _) = head["temperatures"], head["pool_ratios"]
    out_s = _pool(ops, P, "pool_S", _gat(ops, P, "gat_S", e_s, t_s), r0)
    out_t = _pool(ops, P, "pool_T", _gat(ops, P, "gat_T", e_t, t_t), r1)

    def branch(g1, g2, master, ps, pt):
        t1, s1, m1 = _htrg(ops, P, g1, out_t, out_s, P[master], t_h)
        s1, t1 = _pool(ops, P, ps, s1, r2), _pool(ops, P, pt, t1, r2)
        ta, sa, ma = _htrg(ops, P, g2, t1, s1, m1, t_h)
        return t1 + ta, s1 + sa, m1 + ma

    t1, s1, m1 = branch("htrg_st11", "htrg_st12", "master1", "pool_hS1", "pool_hT1")
    t2, s2, m2 = branch("htrg_st21", "htrg_st22", "master2", "pool_hS2", "pool_hT2")
    ot, os_, m = torch.maximum(t1, t2), torch.maximum(s1, s2), torch.maximum(m1, m2)
    last = torch.cat([ot.abs().amax(1), ot.mean(1), os_.abs().amax(1), os_.mean(1), m[:, 0]], 1)
    return _lin(ops, P, "out_layer", last)
