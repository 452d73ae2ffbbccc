"""Graph-attention layers of the AASIST back-end.

Counterpart of ``scl_deepfake_audio_detection_tpu/ops/graph.py``: plain
graph attention over one node set (``GAT``), heterogeneous two-type graph
attention with a master node (``HtrgGAT``) and score-based top-k node
pooling (``GraphPool``, ``pooled_nodes``).  Each module holds the JAX
tree's parameters under its names (the attention vectors ``att_weight*``
as [D, 1] parameters of their own) and, for the two attention layers, a
``BatchNorm`` over the flattened (batch * node, dim) features with its
running statistics.

Kept from the reference, as the JAX package keeps them:
- the attention weights are softmax-normalised over the *output* node
  axis (``dim=-2``, column-stochastic), then contracted over the input
  nodes;
- pooling keeps the max(floor(N * k), 1) highest sigmoid scores in
  score-descending order, ties lower index first as ``jax.lax.top_k``
  orders them: a stable descending sort, sliced, so the card keeps that
  order too.

The node features are fp32 throughout: the products run in fp32 on
weights that ``cast_matmul_params`` may have rounded to bf16, as the JAX
package's einsums promote them.  Each dropout site takes a boolean
keep-mask (``mask``) or draws from ``generator``; with neither it is the
identity.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models.base import BatchNorm, Initialised, Linear
from scl_deepfake_audio_detection_torch.ops.layers import dropout, selu


def _affine(x: torch.Tensor, lin: Linear) -> torch.Tensor:
    """x @ w^T + b in fp32 (the JAX einsum plus bias)."""
    return x @ lin.weight.float().t() + lin.bias.float()


def _pairwise(x: torch.Tensor) -> torch.Tensor:
    """x [B, N, D] -> elementwise products x_i * x_j [B, N, N, D]."""
    return x[:, :, None, :] * x[:, None, :, :]


def _xavier_vec(t: torch.Tensor, generator: torch.Generator) -> None:
    """Xavier-normal [dim, 1] attention vector."""
    t.data.normal_(0.0, math.sqrt(2.0 / (t.shape[0] + 1)), generator=generator)


def _attended(y: torch.Tensor, x: torch.Tensor, layer) -> torch.Tensor:
    """The attended nodes ``y`` and the skip nodes ``x`` through the layer's
    ``proj_with_att`` and ``proj_without_att``, summed in the JAX order."""
    w, wo = layer.proj_with_att, layer.proj_without_att
    return (y @ w.weight.float().t() + w.bias.float()
            + x @ wo.weight.float().t() + wo.bias.float())


def _node_bn(bn: BatchNorm, y: torch.Tensor, train: bool) -> torch.Tensor:
    """Batch norm over the flattened (B * N, D) nodes, the reference's
    ``view(-1, D)``."""
    return bn(y.reshape(-1, y.shape[-1]), train).reshape(y.shape)


class GAT(Initialised):
    """Graph attention over one node set [B, N, D_in] -> [B, N, D_out]:
    input dropout, pairwise-product attention map, tanh / linear / weight
    vector scores, softmax over the output nodes, attended plus skip
    projections, batch norm, SELU."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.att_proj = Linear(in_dim, out_dim)
        self.att_weight = nn.Parameter(torch.empty(out_dim, 1))
        self.proj_with_att = Linear(in_dim, out_dim)
        self.proj_without_att = Linear(in_dim, out_dim)
        self.bn = BatchNorm(out_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _xavier_vec(self.att_weight, generator)

    def forward(self, x: torch.Tensor, train: bool, temp: float = 1.0,
                input_drop: float = 0.2, draws: bool = False,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = dropout(x, input_drop, draws, generator, mask)
        pair = torch.tanh(_affine(_pairwise(x), self.att_proj))
        scores = (pair @ self.att_weight.float())[..., 0]  # [B, N_out, N_in]
        att = torch.softmax(scores.float() / temp, dim=1)
        return selu(_node_bn(self.bn, _attended(att @ x, x, self), train))


class HtrgGAT(Initialised):
    """Heterogeneous graph attention over two node types x1 [B, N1, D] and
    x2 [B, N2, D] with a master node: type-specific input projections, one
    joint attention over the N1 + N2 nodes whose scoring vector depends on
    the (type_i, type_j) block, and a directional master update.  Returns
    (x1', x2', master')."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.proj_type1 = Linear(in_dim, in_dim)
        self.proj_type2 = Linear(in_dim, in_dim)
        self.att_proj = Linear(in_dim, out_dim)
        self.att_projM = Linear(in_dim, out_dim)
        for name in ("att_weight11", "att_weight22", "att_weight12", "att_weightM"):
            setattr(self, name, nn.Parameter(torch.empty(out_dim, 1)))
        self.proj_with_att = Linear(in_dim, out_dim)
        self.proj_without_att = Linear(in_dim, out_dim)
        self.proj_with_attM = Linear(in_dim, out_dim)
        self.proj_without_attM = Linear(in_dim, out_dim)
        self.bn = BatchNorm(out_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("att_weight11", "att_weight22", "att_weight12", "att_weightM"):
            _xavier_vec(getattr(self, name), generator)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                master: Optional[torch.Tensor], train: bool, temp: float = 1.0,
                input_drop: float = 0.2, draws: bool = False,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        n1 = x1.shape[1]
        x = torch.cat([_affine(x1, self.proj_type1), _affine(x2, self.proj_type2)], dim=1)
        n = x.shape[1]
        if master is None:
            master = x.mean(dim=1, keepdim=True)
        master = master.expand(x.shape[0], 1, master.shape[-1])
        x = dropout(x, input_drop, draws, generator, mask)

        pair = torch.tanh(_affine(_pairwise(x), self.att_proj))
        is1 = (torch.arange(n, device=x.device) < n1).float()
        blk11 = is1[:, None] * is1[None, :]
        blk22 = (1 - is1)[:, None] * (1 - is1)[None, :]
        blk12 = 1.0 - blk11 - blk22
        s11 = (pair @ self.att_weight11.float())[..., 0]
        s22 = (pair @ self.att_weight22.float())[..., 0]
        s12 = (pair @ self.att_weight12.float())[..., 0]
        scores = s11 * blk11 + s22 * blk22 + s12 * blk12
        att = torch.softmax(scores.float() / temp, dim=1)

        pair_m = torch.tanh(_affine(x * master, self.att_projM))
        scores_m = pair_m @ self.att_weightM.float()  # [B, N, 1]
        att_m = torch.softmax(scores_m.float() / temp, dim=1)
        m_att = att_m.transpose(1, 2) @ x  # [B, 1, D]
        new_master = (m_att @ self.proj_with_attM.weight.float().t()
                      + self.proj_with_attM.bias.float()
                      + master @ self.proj_without_attM.weight.float().t()
                      + self.proj_without_attM.bias.float())

        y = selu(_node_bn(self.bn, _attended(att @ x, x, self), train))
        return y[:, :n1], y[:, n1:], new_master


def pooled_nodes(n_nodes: int, k: float) -> int:
    """Node count after pooling: max(int(N * k), 1), the reference's floor."""
    return max(int(n_nodes * k), 1)


class GraphPool(nn.Module):
    """Top-k node pooling: sigmoid scores of (dropped-out) nodes, the
    max(floor(N * k), 1) highest kept in score-descending order, each kept
    node scaled by its score."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.proj = Linear(in_dim, 1)

    def forward(self, h: torch.Tensor, k: float, drop: float = 0.3, draws: bool = False,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        z = dropout(h, drop, draws, generator, mask)
        scores = torch.sigmoid(_affine(z, self.proj))[..., 0]  # [B, N]
        kk = pooled_nodes(h.shape[1], k)
        idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :kk]
        weighted = h * scores[..., None]
        return weighted.gather(1, idx[..., None].expand(-1, -1, h.shape[-1]))
