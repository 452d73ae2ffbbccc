"""Pin the zoo heads' discrete choices of a port forward onto the JAX model.

AASIST, ResNet and BTSE make choices that a rounding difference can flip:
the sign of a ReLU, LeakyReLU (BTSE's frame MLP) or SELU input (the
derivative jumps there), the arg-maximum
of a max pool, of an elementwise maximum and of AASIST's ``max |x|``
readout, and the node order of ``graph_pool``'s top-k.  The port and the
JAX package sum in different orders, so an input within a rounding error
of a tie (a ReLU input of 1e-8) can fall on either side.  One such flip
leaves the forward as it was (both sides of a ReLU meet at 0) but moves
the gradient of every weight before it, by up to 1e-2 of the leaf's
largest entry in ResNet-18 (a ReLU input of ~1e-7 decides whether one
upstream gradient entry passes).

``record_port()`` records every such choice the port makes, in call order;
``pin_jax(choices)`` makes the JAX model take the same ones (each op is
replaced by a version that reads the choice from the record: the same
values, and the gradient of the chosen branch).  The JAX code stays as it
is; only its module-level names are swapped for the duration, so the pins
hold under ``jit``, ``vjp`` and ``vmap`` alike.  ``jax_choices()``
records the choices of an eager JAX forward, for ``ties`` to show that the
two sides disagree only within a rounding error of a tie."""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.models import aasist as JA
from scl_deepfake_audio_detection_tpu.models import btse as JB
from scl_deepfake_audio_detection_tpu.models import linear_nll as JLN
from scl_deepfake_audio_detection_tpu.models import resnet as JRN
from scl_deepfake_audio_detection_tpu.ops import graph as JG
from scl_deepfake_audio_detection_tpu.ops import relpos_transformer as JRP
from scl_deepfake_audio_detection_tpu.ops.layers import leaky_relu as jax_leaky_relu
from scl_deepfake_audio_detection_tpu.ops.layers import max_pool2d as jax_max_pool2d
from scl_deepfake_audio_detection_torch.models import aasist as PA
from scl_deepfake_audio_detection_torch.models import btse as PB
from scl_deepfake_audio_detection_torch.models import linear_nll as PLN
from scl_deepfake_audio_detection_torch.models import resnet as PRN
from scl_deepfake_audio_detection_torch.ops import graph as PG
from scl_deepfake_audio_detection_torch.ops import relpos_transformer as PRP

SELU_SCALE, SELU_ALPHA = 1.0507009873554804934193349852946, 1.6732632423543772848170429916717


class _Proxy:
    """A module stand-in: the given attributes, the rest from ``base``."""

    def __init__(self, base, **over):
        self._base, self._over = base, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(self._base, name)


def _jax_layout(a: np.ndarray) -> np.ndarray:
    """The port's [N, C, H, W] as the JAX package's [N, H, W, C]; other
    ranks share one layout."""
    return np.transpose(a, (0, 2, 3, 1)) if a.ndim == 4 else a


@contextlib.contextmanager
def _swapped(pairs):
    old = [(mod, name, getattr(mod, name)) for mod, name, _ in pairs]
    try:
        for mod, name, new in pairs:
            setattr(mod, name, new)
        yield
    finally:
        for mod, name, value in old:
            setattr(mod, name, value)


# ---------------------------------------------------------------- the port

@contextlib.contextmanager
def record_port(linear_nll: bool = False):
    """Yield the list that fills with the port's choices, in call order:
    ``(kind, data)`` with data in the JAX package's layout.  With
    ``linear_nll`` also ``LinearNLL``'s ReLU and frame-MLP LeakyReLU signs
    (a distillation step runs it as teacher and student)."""
    choices = []

    def keep(kind, *data):
        choices.append((kind,) + tuple(_jax_layout(d.detach().cpu().numpy()) for d in data))

    def selu(x):
        keep("sign", x > 0)
        return F.selu(x)

    def relu(x):
        keep("sign", x > 0)
        return torch.relu(x)

    def leaky_relu(x, slope=0.01):
        keep("sign", x > 0)
        return F.leaky_relu(x, slope)

    def max_pool2d(x, window, stride=None):
        y, idx = F.max_pool2d(x, window, window if stride is None else stride,
                              return_indices=True)
        # flat indices into each [H, W] plane, kept in the port's layout
        choices.append(("pool", idx.cpu().numpy(), tuple(x.shape)))
        return y

    def maximum(a, b):
        keep("max2", a > b, a == b)
        return torch.maximum(a, b)

    def amax(x, dim):
        keep("amax", x == torch.amax(x, dim=dim, keepdim=True))
        return torch.amax(x, dim=dim)

    def sort(x, dim, descending, stable):
        out = torch.sort(x, dim=dim, descending=descending, stable=stable)
        keep("order", out.indices)
        return out

    with _swapped([(PA, "selu", selu), (PG, "selu", selu), (PRN, "selu", selu),
                   (PA, "max_pool2d", max_pool2d),
                   (PA, "torch", _Proxy(torch, maximum=maximum, amax=amax)),
                   (PG, "torch", _Proxy(torch, sort=sort)),
                   (PRN, "torch", _Proxy(torch, relu=relu)),
                   (PB, "leaky_relu", leaky_relu),
                   (PRP, "torch", _Proxy(torch, relu=relu))]
                  + ([(PLN, "torch", _Proxy(torch, relu=relu)), (PLN, "leaky_relu", leaky_relu)]
                     if linear_nll else [])):
        yield choices


# ---------------------------------------------------------------- JAX

@contextlib.contextmanager
def pin_jax(choices, linear_nll: bool = False):
    """Make the JAX AASIST and ResNet (and with ``linear_nll`` the JAX
    ``LinearNLL``) take ``choices`` (from ``record_port``) in call order;
    fails if the ops come in another order or shape.  Pins are constants:
    a jitted function traced inside keeps them."""
    it = iter(choices)

    def take(kind, shape):
        got = next(it, None)
        assert got is not None and got[0] == kind, f"expected {kind}, recorded {got and got[0]}"
        if kind == "pool":
            assert got[2][0] == shape[0] and got[2][1:] == (shape[3], shape[1], shape[2]), (
                got[2], shape)
        else:
            assert got[1].shape == tuple(shape), (kind, got[1].shape, shape)
        return got[1:]

    def selu(x):
        (pos,) = take("sign", x.shape)
        neg = SELU_SCALE * SELU_ALPHA * jnp.expm1(jnp.where(pos, 0.0, x))
        return jnp.where(pos, SELU_SCALE * x, neg.astype(x.dtype))

    def relu(x):
        (pos,) = take("sign", x.shape)
        return jnp.where(pos, x, jnp.zeros_like(x))

    def leaky_relu(x, slope=0.01):
        (pos,) = take("sign", x.shape)
        return jnp.where(pos, x, slope * x)

    def max_pool2d(x, window, stride=None):
        idx, _ = take("pool", x.shape)
        n, h, w, c = x.shape
        planes = jnp.transpose(x, (0, 3, 1, 2)).reshape(n, c, h * w)
        y = jnp.take_along_axis(planes, jnp.asarray(idx.reshape(n, c, -1)), axis=2)
        return jnp.transpose(y.reshape(idx.shape), (0, 2, 3, 1))

    def maximum(a, b):
        gt, eq = take("max2", jnp.broadcast_shapes(a.shape, b.shape))
        return jnp.where(gt, a, jnp.where(eq, 0.5 * (a + b), b))

    def amax(x, axis):
        (hit,) = take("amax", x.shape)
        share = hit / hit.sum(axis=axis, keepdims=True)  # ties split, as both sides do
        return jnp.sum(x * share.astype(x.dtype), axis=axis)

    def top_k(x, k):
        (order,) = take("order", x.shape)
        idx = jnp.asarray(order[:, :k])
        return jnp.take_along_axis(x, idx, axis=1), idx

    with _swapped([(JA, "selu", selu), (JG, "selu", selu), (JRN, "selu", selu),
                   (JA, "max_pool2d", max_pool2d),
                   (JA, "jnp", _Proxy(jnp, maximum=maximum, max=amax)),
                   (JG, "jax", _Proxy(jax, lax=_Proxy(jax.lax, top_k=top_k))),
                   (JRN, "jax", _Proxy(jax, nn=_Proxy(jax.nn, relu=relu))),
                   (JB, "leaky_relu", leaky_relu),
                   (JRP, "jax", _Proxy(jax, nn=_Proxy(jax.nn, relu=relu)))]
                  + ([(JLN, "jax", _Proxy(jax, nn=_Proxy(jax.nn, relu=relu))),
                      (JLN, "leaky_relu", leaky_relu)] if linear_nll else [])):
        yield
    assert next(it, None) is None, "the JAX model made fewer choices than the port"


@contextlib.contextmanager
def jax_choices():
    """Yield the list that fills with an eager (unjitted) JAX forward's
    choices and the inputs they were made on: ``(kind, margin, choice)``,
    ``margin`` the input the choice was read from."""
    seen = []

    def selu(x):
        seen.append(("sign", np.asarray(x), np.asarray(x > 0)))
        return jax.nn.selu(x)

    def relu(x):
        seen.append(("sign", np.asarray(x), np.asarray(x > 0)))
        return jax.nn.relu(x)

    def leaky_relu(x, slope=0.01):
        seen.append(("sign", np.asarray(x), np.asarray(x >= 0)))
        return jax_leaky_relu(x, slope)

    def max_pool2d(x, window, stride=None):
        y = jax_max_pool2d(x, window, stride)
        seen.append(("pool", np.asarray(x), np.asarray(y)))
        return y

    def maximum(a, b):
        seen.append(("max2", np.asarray(a), np.asarray(b)))
        return jnp.maximum(a, b)

    def amax(x, axis):
        assert axis == 1, axis
        seen.append(("amax", np.asarray(x), None))
        return jnp.max(x, axis=axis)

    def top_k(x, k):
        seen.append(("order", np.asarray(x), None))
        return jax.lax.top_k(x, k)

    with _swapped([(JA, "selu", selu), (JG, "selu", selu), (JRN, "selu", selu),
                   (JA, "max_pool2d", max_pool2d),
                   (JA, "jnp", _Proxy(jnp, maximum=maximum, max=amax)),
                   (JG, "jax", _Proxy(jax, lax=_Proxy(jax.lax, top_k=top_k))),
                   (JRN, "jax", _Proxy(jax, nn=_Proxy(jax.nn, relu=relu))),
                   (JB, "leaky_relu", leaky_relu),
                   (JRP, "jax", _Proxy(jax, nn=_Proxy(jax.nn, relu=relu)))]):
        yield seen


def disagreements(port, seen):
    """For each choice of the port (``record_port``) and of an eager JAX
    forward on the same inputs (``jax_choices``), in call order: ``(kind,
    count, gap)``, the number of elements where the two chose differently
    and the largest gap, on JAX's inputs, between what JAX chose and what
    the port chose (for a sign, the input itself), over the site's largest
    input magnitude."""
    assert [c[0] for c in port] == [s[0] for s in seen], "the two sides' choices differ in order"
    out = []
    for p, (kind, x, y) in zip(port, seen):
        scale = float(np.abs(x).max()) or 1.0
        if kind == "sign":
            bad = p[1] != y
            gap = np.abs(x)[bad]
        elif kind == "pool":
            n, h, w, c = x.shape
            planes = np.transpose(x, (0, 3, 1, 2)).reshape(n, c, h * w)
            mine = np.take_along_axis(planes, p[1].reshape(n, c, -1), axis=2).reshape(p[1].shape)
            gap = (np.transpose(y, (0, 3, 1, 2)) - mine).ravel()
            bad = gap != 0
            gap = gap[bad]
        elif kind == "max2":
            bad = ~p[2] & (p[1] != (x > y))
            gap = np.abs(x - y)[bad]
        elif kind == "amax":
            gap = (x.max(axis=1, keepdims=True) - x)[p[1]]
            bad = gap != 0
            gap = gap[bad]
        else:  # order: the scores of the nodes each side put at each place
            kept = np.take_along_axis(x, p[1], axis=1)
            want = -np.sort(-x, axis=1)
            gap = np.abs(want - kept).ravel()
            bad = gap != 0
            gap = gap[bad]
        out.append((kind, int(np.count_nonzero(bad)), float(gap.max(initial=0.0)) / scale))
    return out


# Gradients with the choices pinned, leaf by leaf (readings on the CPU at the
# tiny config, AASIST and ResNet, every term; BTSE's 'transformer' and 'gru'
# heads pass under the same rule): a leaf whose reference gradient is
# below ZERO_RULE of the largest in its part of the model (the SSL frontend
# or the head) is zero up to rounding, by the model's structure: the key
# bias of attention, a bias ahead of a batch norm or of a softmax over the
# axis it is constant on, ResNet's stem batch-norm scale (a batch norm
# follows it); those are at most 1e-5 of their part, every other leaf at
# least 3e-4.  They are held to ZERO_RULE of the part on both sides.  Every
# other leaf: rtol 1e-5 and LEAF_ATOL of its own largest entry.  The worst
# reading is 1.8e-4 of the leaf (AASIST's gat_T.att_proj.bias, whose
# gradient is a residual of sums 3000 times its size), most leaves are
# within 2e-5.
ZERO_RULE = 5e-5
LEAF_ATOL = 5e-4


def grad_tolerance(want):
    """{name: elementwise tolerance} for ``want``, {port parameter name:
    tensor} of one gradient (or anything linear in it, such as Adam's first
    moment)."""
    part = lambda n: "ssl" if n.startswith("ssl.") else "head"  # noqa: E731
    top = {}
    for n, w in want.items():
        top[part(n)] = max(top.get(part(n), 0.0), float(w.abs().max()))
    out = {}
    for n, w in want.items():
        w = w.detach().double().abs()
        s = float(w.max())
        if s <= ZERO_RULE * top[part(n)]:  # zero up to rounding
            out[n] = torch.full_like(w, ZERO_RULE * top[part(n)])
        else:
            out[n] = 1e-5 * w + LEAF_ATOL * s
    return out


def assert_grads_close(got, want, what=""):
    """``got`` within ``grad_tolerance(want)`` of ``want``, leaf by leaf."""
    for n, tol in grad_tolerance(want).items():
        diff = (got[n].detach().double() - want[n].detach().double()).abs()
        bad = diff > tol
        assert not bool(bad.any()), (what, n, int(bad.sum()), float(diff.max()),
                                     float(want[n].abs().max()))
