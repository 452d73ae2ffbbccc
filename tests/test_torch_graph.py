"""The port's zoo layers (``ops/layers``: conv2d, max_pool2d, selu,
batch_norm) and graph-attention layers (``ops/graph``: GAT, HtrgGAT,
GraphPool) against the JAX package's, on the CPU.

Inputs come from a numpy seed, parameters from the JAX ``init_*``
functions through ``models/params.load_jax_params``; dropout masks are the
JAX package's own draws (``jax.random.bernoulli`` on the key it splits),
handed to the port.  Tolerances: rtol 1e-5 / atol 2e-5 in fp32 (the same
operations, summed in another order); bf16 one bf16 ulp of the largest
magnitude (2^-7 of max |y|), since both round one fp32 result."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.ops import graph as JG
from scl_deepfake_audio_detection_tpu.ops import layers as JL
from scl_deepfake_audio_detection_torch.models.base import BatchNorm, Conv2d
from scl_deepfake_audio_detection_torch.models.params import buffers_to_jax, load_jax_params
from scl_deepfake_audio_detection_torch.ops import graph as PG
from scl_deepfake_audio_detection_torch.ops import layers as PL

RTOL, ATOL = 1e-5, 2e-5
torch.set_num_threads(2)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, err_msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, _np(want), rtol=RTOL, atol=ATOL, err_msg=err_msg)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _mask(key, rate, shape):
    """The keep-mask the JAX package's ``dropout`` draws from ``key``."""
    return torch.from_numpy(np.array(jax.random.bernoulli(key, 1.0 - rate, shape)))


def _tree(t):
    return jax.tree.map(np.asarray, t)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(y):
    return np.transpose(y.detach().float().numpy(), (0, 2, 3, 1))


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("kernel,stride,padding", [
    ((2, 3), (1, 1), [(1, 1), (1, 1)]),
    ((2, 3), (1, 1), [(0, 0), (1, 1)]),
    ((1, 3), (1, 1), [(0, 0), (1, 1)]),
    ((9, 3), (3, 1), [(1, 1), (1, 1)]),
    (3, (2, 2), [(1, 1), (1, 1)]),
    (1, (2, 2), "VALID"),
    ((3, 3), (1, 1), [(2, 0), (0, 1)]),
])
@pytest.mark.parametrize("bias", [True, False])
def test_conv2d_matches_jax(rng, kernel, stride, padding, bias):
    p = _tree(JL.init_conv2d(jax.random.key(0), 3, 5, kernel, bias=bias))
    x = rng.normal(size=(2, 13, 11, 3)).astype(np.float32)
    want = JL.conv2d(p, jnp.asarray(x), stride=stride, padding=padding)
    conv = load_jax_params(Conv2d(3, 5, kernel, bias=bias), p)
    got = conv(_nchw(x), stride=stride, padding=padding)
    np.testing.assert_allclose(_nhwc(got), _np(want), rtol=RTOL, atol=ATOL)


def test_conv2d_bf16_rounds_once_on_the_cpu(rng):
    p = _tree(JL.init_conv2d(jax.random.key(1), 4, 6, (2, 3)))
    x = rng.normal(size=(2, 9, 10, 4)).astype(np.float32)
    pad = [(1, 1), (1, 1)]
    want = _np(JL.conv2d(p, jnp.asarray(x), padding=pad, compute_dtype=jnp.bfloat16))
    conv = load_jax_params(Conv2d(4, 6, (2, 3)), p)
    got = conv(_nchw(x), padding=pad, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("window,stride", [((3, 3), None), (2, None), ((1, 3), None),
                                           ((3, 3), (2, 1))])
def test_max_pool2d_matches_jax(rng, window, stride):
    x = rng.normal(size=(2, 14, 16, 3)).astype(np.float32)
    want = JL.max_pool2d(jnp.asarray(x), window, stride)
    got = PL.max_pool2d(_nchw(x), window, stride)
    np.testing.assert_array_equal(_nhwc(got), _np(want))


def test_selu_matches_jax(rng):
    x = (3 * rng.normal(size=(4, 33))).astype(np.float32)
    _close(PL.selu(_t(x)), JL.selu(jnp.asarray(x)))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape", [(4, 7, 9, 5), (6, 5), (1, 1, 1, 3)],
                         ids=["image", "nodes", "one-value"])
def test_batch_norm_matches_jax(rng, train, shape):
    """Output and new running statistics; eval reads and keeps them.  A
    one-value batch in training is refused, as torch's batch norm refuses
    it, and leaves the statistics as they were (the JAX package's
    max(n - 1, 1) rule would move the variance towards 0; no training
    batch has fewer than 2 views)."""
    c = shape[-1]
    p = {"scale": rng.normal(size=c).astype(np.float32),
         "bias": rng.normal(size=c).astype(np.float32)}
    buf = {"mean": rng.normal(size=c).astype(np.float32),
           "var": rng.uniform(0.5, 2.0, size=c).astype(np.float32)}
    x = (2 + 3 * rng.normal(size=shape)).astype(np.float32)
    want, nb = JL.batch_norm(p, buf, jnp.asarray(x), train)
    bn = load_jax_params(BatchNorm(c), p, buf)
    xt = _t(x) if len(shape) == 2 else _nchw(x)
    if train and int(np.prod(shape[:-1])) == 1:
        with pytest.raises(ValueError, match="more than 1 value per channel"):
            bn(xt, train)
        assert torch.equal(bn.mean, _t(buf["mean"])) and torch.equal(bn.var, _t(buf["var"]))
        return
    got = bn(xt, train)
    got = got.detach().numpy() if len(shape) == 2 else _nhwc(got)
    np.testing.assert_allclose(got, _np(want), rtol=RTOL, atol=ATOL)
    for k in ("mean", "var"):
        _close(getattr(bn, k), nb[k], k)
    if not train:
        assert torch.equal(bn.mean, _t(buf["mean"])) and torch.equal(bn.var, _t(buf["var"]))


def test_batch_norm_gradients_match_jax(rng):
    c = 4
    p = {"scale": rng.normal(size=c).astype(np.float32),
         "bias": rng.normal(size=c).astype(np.float32)}
    buf = {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}
    x = rng.normal(size=(3, 5, 6, c)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(JL.batch_norm(p, buf, x, True)[0] * g)

    wp, wx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    bn = load_jax_params(BatchNorm(c), p, buf)
    xt = _nchw(x).requires_grad_()
    (bn(xt, True) * _nchw(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), _np(wx), rtol=1e-4, atol=1e-4)
    _close(bn.weight.grad, wp["scale"], "scale")
    _close(bn.bias.grad, wp["bias"], "bias")


def test_batch_norm_keeps_fp32_statistics_under_bf16(rng):
    bn = BatchNorm(3)
    x = torch.from_numpy(rng.normal(size=(4, 3, 5, 5)).astype(np.float32)).bfloat16()
    y = bn(x, True)
    assert y.dtype == torch.bfloat16 and bn.mean.dtype == bn.var.dtype == torch.float32
    want = x.float().mean(dim=(0, 2, 3)) * 0.1
    torch.testing.assert_close(bn.mean, want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------- graph

def _gat(in_dim, out_dim, key=0):
    p, buf = JG.init_gat(jax.random.key(key), in_dim, out_dim)
    p, buf = _tree(p), _tree(buf)
    return p, buf, load_jax_params(PG.GAT(in_dim, out_dim), p, buf)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("temp", [1.0, 2.0, 100.0])
def test_gat_matches_jax(rng, train, temp):
    p, buf, m = _gat(8, 6)
    x = rng.normal(size=(3, 10, 8)).astype(np.float32)
    key = jax.random.key(5) if train else None
    want, nb = JG.gat(p, buf, jnp.asarray(x), train, key, temp)
    mask = _mask(key, 0.2, x.shape) if train else None
    got = m(_t(x), train, temp, draws=train, mask=mask)
    _close(got, want)
    _close(m.bn.mean, nb["bn"]["mean"], "mean")
    _close(m.bn.var, nb["bn"]["var"], "var")


def test_gat_carries_bn_buffers():
    p, buf, m = _gat(8, 6)
    assert sorted(n for n, _ in m.named_buffers()) == ["bn.mean", "bn.var"]
    got = buffers_to_jax(m)
    assert jax.tree.structure(got) == jax.tree.structure(buf)


def test_gat_attention_normalised_over_the_output_axis(rng):
    """The reference's dim=-2 softmax: weights sum to 1 over the output
    nodes, so a column of the map, not a row, is a distribution."""
    _, _, m = _gat(4, 4)
    x = _t(rng.normal(size=(2, 5, 4)))
    pair = torch.tanh(PG._affine(PG._pairwise(x), m.att_proj))
    att = torch.softmax((pair @ m.att_weight)[..., 0] / 2.0, dim=1)
    torch.testing.assert_close(att.sum(dim=1), torch.ones(2, 5))
    assert not torch.allclose(att.sum(dim=2), torch.ones(2, 5))


def test_gat_gradients_match_jax(rng):
    p, buf, m = _gat(8, 6, key=3)
    x = rng.normal(size=(2, 7, 8)).astype(np.float32)
    g = rng.normal(size=(2, 7, 6)).astype(np.float32)
    key = jax.random.key(9)

    def jloss(p, x):
        return jnp.sum(JG.gat(p, buf, x, True, key, 2.0)[0] * g)

    wp, wx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    xt = _t(x).requires_grad_()
    (m(xt, True, 2.0, draws=True, mask=_mask(key, 0.2, x.shape)) * _t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(wx), rtol=1e-4, atol=1e-4)
    for name, want in (("att_weight", wp["att_weight"]), ("att_proj.weight", wp["att_proj"]["w"].T),
                       ("proj_with_att.weight", wp["proj_with_att"]["w"].T),
                       ("bn.weight", wp["bn"]["scale"])):
        np.testing.assert_allclose(m.get_parameter(name).grad.numpy(), _np(want),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def _htrg(in_dim, out_dim, key=0):
    p, buf = JG.init_htrg_gat(jax.random.key(key), in_dim, out_dim)
    p, buf = _tree(p), _tree(buf)
    return p, buf, load_jax_params(PG.HtrgGAT(in_dim, out_dim), p, buf)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("with_master", [True, False], ids=["master", "mean-master"])
def test_htrg_gat_matches_jax(rng, train, with_master):
    p, buf, m = _htrg(8, 6)
    x1 = rng.normal(size=(2, 4, 8)).astype(np.float32)
    x2 = rng.normal(size=(2, 7, 8)).astype(np.float32)
    master = rng.normal(size=(1, 1, 8)).astype(np.float32) if with_master else None
    key = jax.random.key(11) if train else None
    y1, y2, wm, nb = JG.htrg_gat(p, buf, jnp.asarray(x1), jnp.asarray(x2),
                                 None if master is None else jnp.asarray(master),
                                 train, key, 100.0)
    mask = _mask(key, 0.2, (2, 11, 8)) if train else None
    g1, g2, gm = m(_t(x1), _t(x2), None if master is None else _t(master), train, 100.0,
                   draws=train, mask=mask)
    for a, b, name in ((g1, y1, "x1"), (g2, y2, "x2"), (gm, wm, "master")):
        _close(a, b, name)
    _close(m.bn.mean, nb["bn"]["mean"], "mean")
    _close(m.bn.var, nb["bn"]["var"], "var")


@pytest.mark.parametrize("n,k", [(10, 0.5), (7, 0.7), (3, 0.2), (1, 0.5), (29, 0.5)])
def test_pooled_nodes_matches_jax(n, k):
    assert PG.pooled_nodes(n, k) == JG.pooled_nodes(n, k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("k", [0.5, 0.7])
def test_graph_pool_matches_jax(rng, train, k):
    p = _tree(JG.init_graph_pool(jax.random.key(2), 6))
    h = rng.normal(size=(3, 9, 6)).astype(np.float32)
    key = jax.random.key(4) if train else None
    want = JG.graph_pool(p, jnp.asarray(h), k, train, key)
    pool = load_jax_params(PG.GraphPool(6), p)
    mask = _mask(key, 0.3, h.shape) if train else None
    _close(pool(_t(h), k, draws=train, mask=mask), want)


def test_graph_pool_breaks_ties_lower_index_first():
    """Equal scores (here every node's, from a zero projection) keep the
    node order, as ``jax.lax.top_k`` does: the stable descending sort."""
    p = {"proj": {"w": np.zeros((4, 1), np.float32), "b": np.zeros(1, np.float32)}}
    h = np.arange(2 * 8 * 4, dtype=np.float32).reshape(2, 8, 4)
    want = JG.graph_pool(p, jnp.asarray(h), 0.5, False, None)
    got = load_jax_params(PG.GraphPool(4), p)(_t(h), 0.5).detach()
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(got.numpy(), h[:, :4] * 0.5)
