"""Plain float32 reference of XLS-R + the LinearNLL head of the SCL recipe
(conf-3), scoring and the training loss.

Head: the frame features through a linear to ``emb_dim`` (kept pre-ReLU for
SupCon over frames), ReLU, ``mlp_layers`` x (linear, LeakyReLU, dropout),
mean over frames (the embedding), a linear to the classes, log-softmax.
Scores are the two log-probabilities.  Loss (``loss_type`` 1), per anchor
group of V views and then the mean over groups: the cross-entropy on the
log-probabilities, SupCon over the frame features and SupCon over the
embeddings, each divided by V.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.common import (
    Ops,
    ce_on_log_probs,
    linear_spec,
    ssl_forward,
    ssl_spec,
    supcon,
)


def param_spec(cfg: dict):
    ssl, head = cfg["ssl"], cfg["head"]
    e = head["emb_dim"]
    spec = ssl_spec(ssl) + linear_spec("ll", ssl["encoder_dim"], e)
    for i in range(head["mlp_layers"]):
        spec += linear_spec(f"backend.frame.{i}", e, e)
    return spec + linear_spec("backend.out", e, head["num_classes"])


def forward(P: Dict[str, torch.Tensor], wav: torch.Tensor, cfg: dict, ops: Ops,
            masks: Optional[Sequence[torch.Tensor]] = None):
    """-> (log_probs [N, C], frame features [N, T, E], embedding [N, E]).
    ``masks``: one boolean keep-mask a frame-MLP layer (training)."""
    head = cfg["head"]
    x = ops.linear(ssl_forward(P, wav, cfg, ops), P["ll.weight"], P["ll.bias"])
    feats = x
    x = torch.relu(x)
    keep = 1.0 - head["dropout"]
    for i in range(head["mlp_layers"]):
        x = F.leaky_relu(ops.linear(x, P[f"backend.frame.{i}.weight"],
                                    P[f"backend.frame.{i}.bias"]), head["leaky_slope"])
        if masks is not None:
            x = torch.where(masks[i], x / keep, torch.zeros_like(x))
    emb = x.mean(dim=1)
    logits = ops.linear(emb, P["backend.out.weight"], P["backend.out.bias"])
    return torch.log_softmax(logits, dim=-1), feats, emb


def scores(P, wav, cfg, ops: Ops) -> torch.Tensor:
    return forward(P, wav, cfg, ops)[0]


def dropout_shapes(cfg: dict, n: int, frames: int):
    """The shapes of the head's dropout draws of one training forward, in
    the order they are drawn."""
    return [(n, frames, cfg["head"]["emb_dim"])] * cfg["head"]["mlp_layers"]


def loss(P, wav, labels, cfg: dict, ops: Ops, masks, groups: Optional[Sequence[int]] = None):
    """The step's loss over wav [G, V, S] and labels [G, V]; ``groups``
    limits the mean to those anchor groups (a planted fault)."""
    g, v = wav.shape[0], wav.shape[1]
    lp, feats, emb = forward(P, wav.reshape(g * v, -1), cfg, ops, masks)
    t = cfg["training"]["temperature"]
    totals = []
    for i in (range(g) if groups is None else groups):
        rows = slice(i * v, (i + 1) * v)
        lab = labels[i].reshape(-1)
        terms = (ce_on_log_probs(lp[rows], lab) / v,
                 supcon(feats[rows][:, None], lab, t) / v,
                 supcon(emb[rows][:, None, :, None], lab, t) / v)
        totals.append(torch.stack(terms))
    return torch.stack(totals).mean(0).sum()
