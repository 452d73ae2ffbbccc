"""Plain PyTorch reference of the XLS-R (wav2vec 2.0 large) frontend, the
SCL losses and AdamW, in float32.

It imports nothing of the program and nothing of JAX.  It follows the
published architecture (fairseq ``Wav2Vec2Model`` with
``extractor_mode=layer_norm``, ``layer_norm_first=True``): seven strided
convs, each followed by a layer norm over channels and GELU; a layer norm
and the 512 -> D projection; the grouped positional conv (SamePad: the last
output of an even kernel dropped) and GELU added to its input; pre-norm
transformer layers; a final layer norm.  The GELU form is the one the
configuration states (``precision.gelu``).  Parameters are a dict keyed by
the names of ``param_spec``.

``Ops`` carries the precision: float32 (``Ops(None)``), or a control that
rounds both operands of every product (linears, convs and the attention
products) to float8 e4m3 with one scale a tensor (``Ops("fp8")``), the
precision below bfloat16, in the forward and, for the incoming gradient,
in the backward; the activations that the program keeps in its compute
dtype (``Ops.store``) are rounded there too.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Spec = List[Tuple[str, Tuple[int, ...], str]]  # (name, shape, init rule)
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for products and convs while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8, its gradient passed straight through."""
    return x + (_round_fp8(x.detach()) - x).detach()


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to float8
    (a product's output: the backward's products then read float8)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


class Ops:
    def __init__(self, precision: Optional[str] = None):
        if precision not in (None, "fp8"):
            raise ValueError(f"unknown reference precision {precision!r}")
        low = precision == "fp8"
        self.q = _fp8 if low else (lambda x: x)
        self.g = _RoundGrad.apply if low else (lambda y: y)

    def linear(self, x, w, b=None):
        y = self.g(self.q(x) @ self.q(w).t())
        return y if b is None else y + b

    def conv1d(self, x, w, b=None, stride=1, groups=1):
        y = self.g(F.conv1d(self.q(x), self.q(w), None, stride=stride, groups=groups))
        return y if b is None else y + b[:, None]

    def conv2d(self, x, w, b=None, padding=(0, 0, 0, 0)):
        """``padding`` is (top, bottom, left, right)."""
        pt, pb, pl, pr = padding
        x = F.pad(x, (pl, pr, pt, pb))
        y = self.g(F.conv2d(self.q(x), self.q(w)))
        return y if b is None else y + b[:, None, None]

    def matmul(self, a, b):
        return self.g(self.q(a) @ self.q(b))

    def store(self, x):
        """An activation the program keeps in its compute dtype (between
        the feature encoder's blocks, the projection, the residual stream):
        rounded, and so is its gradient."""
        return self.g(self.q(x))


def gelu(x: torch.Tensor, form: str) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if form == "tanh" else "none")


def ssl_spec(ssl: dict, prefix: str = "ssl.") -> Spec:
    spec: Spec = []
    c_in = 1
    for i, (dim, k, _) in enumerate(ssl["conv_layers"]):
        p = f"{prefix}feature_extractor.convs.{i}."
        spec += [(p + "conv.weight", (dim, c_in, k), "fan_in")]
        if ssl.get("conv_bias", True):
            spec += [(p + "conv.bias", (dim,), "fan_in:" + p + "conv.weight")]
        spec += [(p + "ln.weight", (dim,), "one"), (p + "ln.bias", (dim,), "zero")]
        c_in = dim
    d, f = ssl["encoder_dim"], ssl["ffn_dim"]
    spec += [(prefix + "post_extract_ln.weight", (c_in,), "one"),
             (prefix + "post_extract_ln.bias", (c_in,), "zero")]
    spec += linear_spec(prefix + "proj", c_in, d)
    g, k = ssl["pos_conv_groups"], ssl["pos_conv_kernel"]
    spec += [(prefix + "pos_conv.weight", (d, d // g, k), "fan_in"),
             (prefix + "pos_conv.bias", (d,), "fan_in:" + prefix + "pos_conv.weight")]
    for i in range(ssl["encoder_layers"]):
        p = f"{prefix}encoder.layers.{i}."
        spec += [(p + "ln_attn.weight", (d,), "one"), (p + "ln_attn.bias", (d,), "zero")]
        for n in ("q", "k", "v", "o"):
            spec += linear_spec(p + "attn." + n, d, d)
        spec += [(p + "ln_ffn.weight", (d,), "one"), (p + "ln_ffn.bias", (d,), "zero")]
        spec += linear_spec(p + "fc1", d, f) + linear_spec(p + "fc2", f, d)
    spec += [(prefix + "encoder.final_ln.weight", (d,), "one"),
             (prefix + "encoder.final_ln.bias", (d,), "zero")]
    return spec


def linear_spec(name: str, d_in: int, d_out: int) -> Spec:
    return [(name + ".weight", (d_out, d_in), "fan_in"),
            (name + ".bias", (d_out,), f"fan_in:{name}.weight")]


def _ln(x, P, name, eps):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], eps)


def ssl_forward(P: Dict[str, torch.Tensor], wav: torch.Tensor, cfg: dict, ops: Ops,
                prefix: str = "ssl.") -> torch.Tensor:
    """wav [B, samples] float32 -> frame features [B, T, D]."""
    ssl, form = cfg["ssl"], cfg["precision"]["gelu"]
    eps = ssl["layer_norm_eps"]
    x = wav[:, None, :]
    for i, (dim, _, s) in enumerate(ssl["conv_layers"]):
        p = f"{prefix}feature_extractor.convs.{i}."
        x = ops.conv1d(x, P[p + "conv.weight"], P.get(p + "conv.bias"), stride=s)
        x = ops.store(gelu(_ln(x.transpose(1, 2), P, p + "ln", eps).transpose(1, 2), form))
    x = _ln(x.transpose(1, 2), P, prefix + "post_extract_ln", eps)
    x = ops.store(ops.linear(x, P[prefix + "proj.weight"], P[prefix + "proj.bias"]))
    k = ssl["pos_conv_kernel"]
    xp = F.pad(x.transpose(1, 2), (k // 2, k // 2 - 1 if k % 2 == 0 else k // 2))
    pos = ops.conv1d(xp, P[prefix + "pos_conv.weight"], P[prefix + "pos_conv.bias"],
                     groups=ssl["pos_conv_groups"])
    x = ops.store(x + gelu(pos.transpose(1, 2), form))
    b, t, d = x.shape
    h = ssl["num_heads"]
    hd = d // h
    for i in range(ssl["encoder_layers"]):
        p = f"{prefix}encoder.layers.{i}."
        y = _ln(x, P, p + "ln_attn", eps)
        q, kk, v = (ops.linear(y, P[p + f"attn.{n}.weight"], P[p + f"attn.{n}.bias"])
                    .reshape(b, t, h, hd).transpose(1, 2) for n in ("q", "k", "v"))
        att = torch.softmax(ops.matmul(q * hd ** -0.5, kk.transpose(-1, -2)), dim=-1)
        a = ops.matmul(att, v).transpose(1, 2).reshape(b, t, d)
        x = ops.store(x + ops.linear(a, P[p + "attn.o.weight"], P[p + "attn.o.bias"]))
        y = _ln(x, P, p + "ln_ffn", eps)
        y = gelu(ops.linear(y, P[p + "fc1.weight"], P[p + "fc1.bias"]), form)
        x = ops.store(x + ops.linear(y, P[p + "fc2.weight"], P[p + "fc2.bias"]))
    return _ln(x, P, prefix + "encoder.final_ln", eps)


def pad_zero(wav: np.ndarray, cut: int) -> np.ndarray:
    """The eval crop: the first ``cut`` samples, zero-padded at the end."""
    out = np.zeros(cut, np.float32)
    n = min(cut, wav.shape[0])
    out[:n] = wav[:n]
    return out


# ---------------------------------------------------------------- training

def ce_on_log_probs(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference recipe's cross-entropy applied to log-probabilities (a
    second log-softmax), mean over the rows."""
    lp = torch.log_softmax(log_probs, dim=-1)
    return -lp.gather(1, labels.long()[:, None])[:, 0].mean()


def supcon(feat: torch.Tensor, labels: torch.Tensor, temperature: float) -> torch.Tensor:
    """SupCon of the SCL recipe ('all' anchors, mean-over-time similarity)
    over feat [bs, n_views, T, D]: the max taken over the diagonal-zeroed
    logits, the exponent masked by the off-diagonal, an anchor with no
    positive counted as 0."""
    bs, nv = feat.shape[0], feat.shape[1]
    mask = (labels[:, None] == labels[None, :]).float()
    contrast = torch.cat([feat[:, i] for i in range(nv)], dim=0)
    logits = torch.einsum("atd,ctd->ac", contrast, contrast) / contrast.shape[1] / temperature
    n = bs * nv
    self_mask = 1.0 - torch.eye(n, device=feat.device)
    pos = mask.repeat(nv, nv) * self_mask
    shifted = logits - (logits * self_mask).amax(dim=1, keepdim=True).detach()
    log_prob = shifted - torch.log((torch.exp(shifted * self_mask) * self_mask).sum(1, keepdim=True))
    n_pos = pos.sum(1)
    mean_pos = torch.where(n_pos > 0, (pos * log_prob).sum(1) / n_pos.clamp(min=1.0),
                           torch.zeros_like(n_pos))
    return -mean_pos.reshape(nv, bs).mean()


class AdamW:
    """Decoupled AdamW (b1 0.9, b2 0.999, eps 1e-8) over a dict of tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float):
        self.p, self.lr, self.wd, self.t = params, lr, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, p in self.p.items():
            g = grads[k] if grads.get(k) is not None else torch.zeros_like(p)
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            p.mul_(1 - self.lr * self.wd)
            p.addcdiv_(self.m[k], self.v[k].sqrt() / c2 ** 0.5 + 1e-8, value=-self.lr / c1)


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The dropout seed of one train step of the SCL recipe's engine: a
    64-bit draw of numpy's SeedSequence([seed, epoch, step])."""
    return int(np.random.SeedSequence([seed, epoch, step]).generate_state(1, np.uint64)[0])
