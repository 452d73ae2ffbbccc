"""Normalizing-flow primitives: the VITS leftovers of the reference's BTSE
package.

Counterpart of ``scl_deepfake_audio_detection_tpu/ops/flows.py`` (the
reference's ``model/wav2vec2_btse/modules.py``: the WN gated-conv stack,
DDSConv, ConvReluNorm, the HiFiGAN ResBlocks, the elementwise-affine, log
and flip flows, ResidualCouplingLayer and ConvFlow; and
``model/wav2vec2_btse/transforms.py``, the piecewise rational-quadratic
splines).  Unused by the reference's BTSE model, part of its surface.

As the JAX package:
- the layout is [B, T, C] and masks are [B, T, 1];
- the unconstrained spline runs every element through the spline on
  inputs clamped into the interval and picks the identity for the tails
  with ``torch.where`` (the torch original routes the inside elements
  through boolean indexing, ``transforms.py:66-95``); the bin search is
  the mask-sum form ``#(x >= edge) - 1`` (``transforms.py:47-52``), whose
  tie rule on a bin edge ``torch.searchsorted`` does not share;
- WN's weight norm is folded into plain kernels (a reparametrization, not
  a runtime op);
- the flows keep the reference's calling convention: forward returns
  ``(y, logdet)``, ``reverse=True`` the inverse alone
  (``modules.py:266-396``).

The modules hold their parameters under the JAX tree's names
(``models/params.from_jax`` loads a JAX ``init_*`` tree); the dilation
rate, which the JAX package passes at apply time, is a constructor
argument, as in the reference.  Each dropout site of ``ConvReluNorm``
draws from the generator in turn, so no two layers share a mask.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scl_deepfake_audio_detection_torch.models.base import Conv1d, LayerNorm
from scl_deepfake_audio_detection_torch.ops.layers import dropout, gelu

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


# ---------------------------------------------------------------------------
# rational-quadratic splines (transforms.py:12-192)
# ---------------------------------------------------------------------------


def _searchsorted(bin_locations: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """Per-element bin index: #(x >= boundary) - 1 over the last axis
    (``transforms.py:47-52``), clipped into the valid bin range."""
    locs = torch.cat([bin_locations[..., :-1], bin_locations[..., -1:] + eps], dim=-1)
    idx = torch.sum(x[..., None] >= locs, dim=-1) - 1
    return torch.clamp(idx, 0, bin_locations.shape[-1] - 2)


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(v, -1, idx[..., None])[..., 0]


def _knots(unnormalized: torch.Tensor, min_bin: float, lo: float, hi: float):
    """(cumulative edges [..., K+1], bin sizes [..., K]) of softmax bins
    with a floor of ``min_bin``, spanning [lo, hi] exactly."""
    num_bins = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_bin + (1 - min_bin * num_bins) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], hi)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    x: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
):
    """Monotonic rational-quadratic spline (Durkan et al.; the math of
    ``transforms.py:96-192``).  ``x`` [...], knot parameters [..., K] (the
    derivatives [..., K+1]).  Returns ``(y, logabsdet)`` elementwise.

    As the JAX function, it does not raise on inputs outside the domain:
    the callers clamp them ([left, right] forward, [bottom, top] inverse)."""
    num_bins = unnormalized_widths.shape[-1]
    if min_bin_width * num_bins > 1.0:
        raise ValueError("minimal bin width too large for the number of bins")
    if min_bin_height * num_bins > 1.0:
        raise ValueError("minimal bin height too large for the number of bins")

    cumwidths, widths = _knots(unnormalized_widths, min_bin_width, left, right)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)
    cumheights, heights = _knots(unnormalized_heights, min_bin_height, bottom, top)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, x)

    in_cumwidths = _take(cumwidths, bin_idx)
    in_bin_widths = _take(widths, bin_idx)
    in_cumheights = _take(cumheights, bin_idx)
    delta = heights / widths
    in_delta = _take(delta, bin_idx)
    in_deriv = _take(derivatives, bin_idx)
    in_deriv_p1 = _take(derivatives[..., 1:], bin_idx)
    in_heights = _take(heights, bin_idx)

    if inverse:
        a = (x - in_cumheights) * (in_deriv + in_deriv_p1 - 2 * in_delta) + (
            in_heights * (in_delta - in_deriv))
        b = in_heights * in_deriv - (x - in_cumheights) * (
            in_deriv + in_deriv_p1 - 2 * in_delta)
        c = -in_delta * (x - in_cumheights)
        discriminant = torch.clamp(b**2 - 4 * a * c, min=0.0)
        root = (2 * c) / (-b - torch.sqrt(discriminant))
        y = root * in_bin_widths + in_cumwidths
        theta_1mt = root * (1 - root)
        denominator = in_delta + (in_deriv + in_deriv_p1 - 2 * in_delta) * theta_1mt
        deriv_numerator = in_delta**2 * (
            in_deriv_p1 * root**2 + 2 * in_delta * theta_1mt + in_deriv * (1 - root) ** 2)
        logabsdet = torch.log(deriv_numerator) - 2 * torch.log(denominator)
        return y, -logabsdet
    theta = (x - in_cumwidths) / in_bin_widths
    theta_1mt = theta * (1 - theta)
    numerator = in_heights * (in_delta * theta**2 + in_deriv * theta_1mt)
    denominator = in_delta + (in_deriv + in_deriv_p1 - 2 * in_delta) * theta_1mt
    y = in_cumheights + numerator / denominator
    deriv_numerator = in_delta**2 * (
        in_deriv_p1 * theta**2 + 2 * in_delta * theta_1mt + in_deriv * (1 - theta) ** 2)
    logabsdet = torch.log(deriv_numerator) - 2 * torch.log(denominator)
    return y, logabsdet


def piecewise_rational_quadratic_transform(
    x: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tails: Optional[str] = "linear",
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
):
    """The spline with linear tails outside [-tail_bound, tail_bound]
    (``transforms.py:12-93``): elements outside map to themselves with a
    log-det of 0.  Clamp in, spline, select."""
    if tails is None:
        return rational_quadratic_spline(
            x, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
            inverse=inverse, min_bin_width=min_bin_width,
            min_bin_height=min_bin_height, min_derivative=min_derivative)
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented")
    inside = (x >= -tail_bound) & (x <= tail_bound)
    # the boundary derivative is 1 after softplus: softplus(c) + min_d == 1
    constant = math.log(math.exp(1 - min_derivative) - 1)
    ud = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    x_in = torch.clamp(x, -tail_bound, tail_bound)
    y_spline, ld_spline = rational_quadratic_spline(
        x_in, unnormalized_widths, unnormalized_heights, ud, inverse=inverse,
        left=-tail_bound, right=tail_bound, bottom=-tail_bound, top=tail_bound,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)
    y = torch.where(inside, y_spline, x)
    logabsdet = torch.where(inside, ld_spline, torch.zeros_like(ld_spline))
    return y, logabsdet


# ---------------------------------------------------------------------------
# simple flows (modules.py:266-303)
# ---------------------------------------------------------------------------


def log_flow(x: torch.Tensor, mask: torch.Tensor, reverse: bool = False):
    """y = log(max(x, 1e-5)); logdet = sum(-y) (``modules.py:266-274``)."""
    if reverse:
        return torch.exp(x) * mask
    y = torch.log(torch.clamp(x, min=1e-5)) * mask
    return y, torch.sum(-y, dim=(1, 2))


def flip_flow(x: torch.Tensor, reverse: bool = False):
    """Flip of the channel axis (``modules.py:277-284``; torch's dim 1 = C
    is the last axis in this layout)."""
    y = torch.flip(x, dims=(-1,))
    if reverse:
        return y
    return y, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)


class ElementwiseAffine(nn.Module):
    """y = (m + exp(logs) * x) * mask (``modules.py:287-302``); ``m`` and
    ``logs`` start at 0."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels))
        self.logs = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, reverse: bool = False):
        if reverse:
            return (x - self.m) * torch.exp(-self.logs) * mask
        y = (self.m + torch.exp(self.logs) * x) * mask
        return y, torch.sum(self.logs * mask, dim=(1, 2))


# ---------------------------------------------------------------------------
# WN gated-conv stack (modules.py:118-191)
# ---------------------------------------------------------------------------


def _same(k: int, dilation: int = 1):
    pad = (k * dilation - dilation) // 2
    return [(pad, pad)]


def _dilated(conv: Conv1d, x: torch.Tensor, dilation: int = 1):
    """A 'same'-padded dilated conv of ``conv``'s weights."""
    return conv(x, padding=_same(conv.weight.shape[-1], dilation), dilation=dilation)


def _gated(x_in: torch.Tensor, g_l: torch.Tensor, hidden: int) -> torch.Tensor:
    """The fused tanh-sigmoid gate (``commons.fused_add_tanh_sigmoid_multiply``)."""
    acts = x_in + g_l
    return torch.tanh(acts[..., :hidden]) * torch.sigmoid(acts[..., hidden:])


class WN(nn.Module):
    """WaveNet-style stack: per layer a dilated conv to 2*hidden (the gate),
    then a 1x1 res+skip conv (2*hidden, hidden for the last layer); a 1x1
    conditioning conv ``cond`` when ``gin`` > 0."""

    def __init__(self, hidden: int, kernel: int, n_layers: int, gin: int = 0,
                 dilation_rate: int = 1):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError("WN kernel must be odd")
        self.hidden, self.dilation_rate = hidden, dilation_rate
        self.in_layers = nn.ModuleList(Conv1d(hidden, 2 * hidden, kernel)
                                       for _ in range(n_layers))
        self.res_skip_layers = nn.ModuleList(
            Conv1d(hidden, 2 * hidden if i < n_layers - 1 else hidden, 1)
            for i in range(n_layers))
        self.cond = Conv1d(gin, 2 * hidden * n_layers, 1) if gin else None

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, H] -> the skip sum [B, T, H] (``WN.forward``,
        ``modules.py:156-186``)."""
        hidden, n_layers = self.hidden, len(self.in_layers)
        if g is not None and self.cond is None:
            # the torch WN has no cond_layer unless gin_channels was set and
            # fails on g; dropping the conditioning would train an
            # unconditional flow that only looks conditional
            raise ValueError("WN got conditioning g but was built with gin=0 "
                             "(no cond layer)")
        cond = self.cond(g) if g is not None else None
        output = torch.zeros_like(x)
        for i in range(n_layers):
            x_in = _dilated(self.in_layers[i], x, self.dilation_rate**i)
            g_l = (cond[..., i * 2 * hidden:(i + 1) * 2 * hidden] if cond is not None
                   else torch.zeros_like(x_in))
            res_skip = self.res_skip_layers[i](_gated(x_in, g_l, hidden))
            if i < n_layers - 1:
                x = (x + res_skip[..., :hidden]) * mask
                output = output + res_skip[..., hidden:]
            else:
                output = output + res_skip
        return output * mask


# ---------------------------------------------------------------------------
# DDSConv (modules.py:77-115)
# ---------------------------------------------------------------------------


class DDSConv(nn.Module):
    """Dilated depthwise-separable residual stack, dilation kernel**i
    (``DDSConv.forward``, ``modules.py:104-115``)."""

    def __init__(self, channels: int, kernel: int, n_layers: int):
        super().__init__()
        self.sep = nn.ModuleList(Conv1d(channels, channels, kernel, groups=channels)
                                 for _ in range(n_layers))
        self.pw = nn.ModuleList(Conv1d(channels, channels, 1) for _ in range(n_layers))
        self.ln1 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))
        self.ln2 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        if g is not None:
            x = x + g
        for i, (sep, pw, ln1, ln2) in enumerate(zip(self.sep, self.pw, self.ln1, self.ln2)):
            y = _dilated(sep, x * mask, sep.weight.shape[-1] ** i)
            y = gelu(ln1(y), approximate=True)  # jax.nn.gelu's default, the tanh form
            y = gelu(ln2(pw(y)), approximate=True)
            x = x + y
        return x * mask


# ---------------------------------------------------------------------------
# ConvReluNorm and the HiFiGAN ResBlocks (modules.py:42-74, 194-263)
# ---------------------------------------------------------------------------

LRELU_SLOPE = 0.1  # modules.py LRELU_SLOPE


class ConvReluNorm(nn.Module):
    """Residual conv -> LN -> ReLU stack with a zero-initialised projection
    (``ConvReluNorm``, ``modules.py:42-74``): the identity at init."""

    def __init__(self, in_ch: int, hidden: int, out_ch: int, kernel: int, n_layers: int):
        super().__init__()
        if n_layers <= 1:
            raise ValueError("n_layers should be larger than 1")
        self.convs = nn.ModuleList(
            [Conv1d(in_ch, hidden, kernel)]
            + [Conv1d(hidden, hidden, kernel) for _ in range(1, n_layers)])
        self.norms = nn.ModuleList(LayerNorm(hidden) for _ in range(n_layers))
        self.proj = _zero_conv(Conv1d(hidden, out_ch, 1))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``dropout_rate`` > 0 with a ``generator`` (or the keep ``masks``
        of each layer, in their place) drops in training: one mask a
        layer, each drawn from the generator in turn."""
        x_org = x
        train = dropout_rate > 0.0 and (generator is not None or masks is not None)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            k = conv.weight.shape[-1]
            x = torch.relu(norm(conv(x * mask, padding=[(k // 2, k // 2)])))
            x = dropout(x, dropout_rate, train, generator,
                        mask=None if masks is None else masks[i])
        return (x_org + self.proj(x)) * mask


class ResBlock1(nn.Module):
    """HiFiGAN ResBlock1 (``modules.py:194-231``): per stage, leaky ReLU ->
    dilated conv -> leaky ReLU -> undilated conv, a residual add."""

    def __init__(self, channels: int, kernel: int = 3, dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList(Conv1d(channels, channels, kernel) for _ in self.dilation)
        self.convs2 = nn.ModuleList(Conv1d(channels, channels, kernel) for _ in self.dilation)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for c1, c2, d in zip(self.convs1, self.convs2, self.dilation):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            if mask is not None:
                xt = xt * mask
            xt = F.leaky_relu(_dilated(c1, xt, d), LRELU_SLOPE)
            if mask is not None:
                xt = xt * mask
            x = _dilated(c2, xt) + x
        return x * mask if mask is not None else x


class ResBlock2(nn.Module):
    """HiFiGAN ResBlock2 (``modules.py:239-263``)."""

    def __init__(self, channels: int, kernel: int = 3, dilation: Sequence[int] = (1, 3)):
        super().__init__()
        self.dilation = tuple(dilation)
        self.convs = nn.ModuleList(Conv1d(channels, channels, kernel) for _ in self.dilation)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for c, d in zip(self.convs, self.dilation):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            if mask is not None:
                xt = xt * mask
            x = _dilated(c, xt, d) + x
        return x * mask if mask is not None else x


# ---------------------------------------------------------------------------
# coupling flows (modules.py:305-396)
# ---------------------------------------------------------------------------


def _zero_conv(conv: Conv1d) -> Conv1d:
    """A conv whose weight and bias start at zero, here and under
    ``init_parameters``: the coupling layers start as the identity
    (``modules.py:328-329,366-367``)."""
    conv.zero_init = True
    with torch.no_grad():
        conv.weight.zero_()
        if conv.bias is not None:
            conv.bias.zero_()
    return conv


class ResidualCoupling(nn.Module):
    """Affine coupling with a WN conditioner (``ResidualCouplingLayer``,
    ``modules.py:305-350``); x [B, T, C], the first half conditions the
    second."""

    def __init__(self, channels: int, hidden: int, kernel: int, n_layers: int,
                 gin: int = 0, mean_only: bool = False, dilation_rate: int = 1):
        super().__init__()
        if channels % 2 != 0:
            raise ValueError("channels should be divisible by 2")
        half = channels // 2
        self.mean_only = mean_only
        self.pre = Conv1d(half, hidden, 1)
        self.enc = WN(hidden, kernel, n_layers, gin=gin, dilation_rate=dilation_rate)
        self.post = _zero_conv(Conv1d(hidden, half * (2 - int(mean_only)), 1))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = False):
        half = x.shape[-1] // 2
        x0, x1 = x[..., :half], x[..., half:]
        h = self.pre(x0) * mask
        h = self.enc(h, mask, g=g)
        stats = self.post(h) * mask
        if self.mean_only:
            m, logs = stats, torch.zeros_like(stats)
        else:
            m, logs = stats[..., :half], stats[..., half:]
        if reverse:
            x1 = (x1 - m) * torch.exp(-logs) * mask
            return torch.cat([x0, x1], dim=-1)
        x1 = m + x1 * torch.exp(logs) * mask
        return torch.cat([x0, x1], dim=-1), torch.sum(logs, dim=(1, 2))


class ConvFlow(nn.Module):
    """Spline coupling (``ConvFlow``, ``modules.py:353-396``): a DDSConv
    conditioner predicts per-element spline knots for the second half."""

    def __init__(self, in_channels: int, filter_channels: int, kernel: int, n_layers: int,
                 num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        half = in_channels // 2
        self.num_bins, self.tail_bound = num_bins, tail_bound
        self.pre = Conv1d(half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel, n_layers)
        self.proj = _zero_conv(Conv1d(filter_channels, half * (num_bins * 3 - 1), 1))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = False):
        half, nb = x.shape[-1] // 2, self.num_bins
        x0, x1 = x[..., :half], x[..., half:]
        h = self.convs(self.pre(x0), mask, g=g)
        h = self.proj(h) * mask  # [B, T, half*(3K-1)]
        b, t = x0.shape[:2]
        h = h.reshape(b, t, half, nb * 3 - 1)
        scale = math.sqrt(self.pre.weight.shape[0])
        uw, uh, ud = h[..., :nb] / scale, h[..., nb:2 * nb] / scale, h[..., 2 * nb:]
        x1_new, logabsdet = piecewise_rational_quadratic_transform(
            x1, uw, uh, ud, inverse=reverse, tails="linear", tail_bound=self.tail_bound)
        y = torch.cat([x0, x1_new], dim=-1) * mask
        if reverse:
            return y
        return y, torch.sum(logabsdet * mask, dim=(1, 2))
