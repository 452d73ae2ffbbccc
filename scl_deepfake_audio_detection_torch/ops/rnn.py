"""A single-layer, batch-first GRU as a step loop.

Counterpart of ``scl_deepfake_audio_detection_tpu/ops/rnn.py`` (a
``lax.scan``), for the BTSE 'gru' bio encoder.  torch's gate math: gates
r, z, n in that order along the 3H axis, the reset gate applied to the
hidden projection of n.  The leaves keep the JAX names and layout:
``w_ih`` [in, 3H] and ``w_hh`` [H, 3H] (right-multiplied), ``b_ih`` and
``b_hh`` [3H]; torch's ``nn.GRU`` init, U(-1/sqrt(H), 1/sqrt(H)).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models.base import Initialised


class GRU(Initialised):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(in_dim, 3 * hidden))
        self.w_hh = nn.Parameter(torch.empty(hidden, 3 * hidden))
        self.b_ih = nn.Parameter(torch.empty(3 * hidden))
        self.b_hh = nn.Parameter(torch.empty(3 * hidden))

    def reset_parameters(self, generator: torch.Generator) -> None:
        k = 1.0 / math.sqrt(self.w_hh.shape[0])
        for p in (self.w_ih, self.w_hh, self.b_ih, self.b_hh):
            p.data.uniform_(-k, k, generator=generator)

    def forward(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None):
        return gru(self, x, h0, lengths)


def gru(p: GRU, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, D] -> (outputs [B, T, H], last hidden [B, H]).

    ``lengths`` [B] freezes each hidden state past its sequence's end, so
    the last hidden is torch's packed-sequence final hidden.  The sums run
    in the wider of x's and the weights' dtypes."""
    dtype = torch.promote_types(x.dtype, p.w_ih.dtype)
    gates_x = x.to(dtype) @ p.w_ih.to(dtype) + p.b_ih  # [B, T, 3H]
    h = x.new_zeros(x.shape[0], p.w_hh.shape[0], dtype=dtype) if h0 is None else h0
    outs = []
    for t in range(x.shape[1]):
        gh = h @ p.w_hh + p.b_hh
        xr, xz, xn = gates_x[:, t].chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        if lengths is not None:
            h_new = torch.where((t < lengths)[:, None], h_new, h)
        outs.append(h_new)
        h = h_new
    return torch.stack(outs, dim=1), h
