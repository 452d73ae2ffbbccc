"""Port layer ops (``scl_deepfake_audio_detection_torch/ops/layers.py``) vs
their JAX twins, on the CPU, from the same numpy inputs.

Tolerances: fp32 ops agree to float32 rounding of a different summation
order (<= 1e-5 at these sizes; elementwise ops to 1e-6).  bf16 ops see the
same bf16-rounded operands on both sides and accumulate in fp32; where the
result is bf16 the two may round a value to neighbouring bf16 numbers, so
they are held to 2 bf16 ulps (rtol 1.6e-2)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.ops import layers as J
from scl_deepfake_audio_detection_torch.ops import layers as P

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 8), (2, 5, 8)])
def test_linear_matches_jax(rng, dtype, shape):
    jd, td = DTYPES[dtype]
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(8, 6)).astype(np.float32)  # JAX layout [in, out]
    b = rng.normal(size=(6,)).astype(np.float32)
    want = J.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), jd)
    got = P.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b), td)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax_and_keeps_dtype(rng, dtype):
    jd, td = DTYPES[dtype]
    x = (3.0 + 2.0 * rng.normal(size=(2, 7, 16))).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    want = J.layer_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                        jnp.asarray(x).astype(jd))
    got = P.layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(scale),
                       torch.from_numpy(bias))
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


CONV_CASES = [
    # (cin, cout, k, stride, padding, groups, dilation)
    (1, 8, 10, 5, "VALID", 1, 1),
    (8, 8, 3, 2, "VALID", 1, 1),
    (8, 8, 16, 1, [(8, 7)], 4, 1),
    (8, 4, 3, 1, [(2, 2)], 2, 2),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv1d_matches_jax(rng, dtype, case):
    cin, cout, k, stride, padding, groups, dilation = case
    jd, td = DTYPES[dtype]
    x = rng.normal(size=(2, 40, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin // groups, cout)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    want = J.conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                    stride=stride, padding=padding, groups=groups,
                    dilation=dilation, compute_dtype=jd)
    got = P.conv1d(torch.from_numpy(x), torch.from_numpy(w.transpose(2, 1, 0).copy()),
                   torch.from_numpy(b), stride=stride, padding=padding,
                   groups=groups, dilation=dilation, compute_dtype=td)
    assert got.dtype == td and tuple(got.shape) == tuple(want.shape)
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(rng, approximate):
    x = (3 * rng.normal(size=(4, 33))).astype(np.float32)
    want = J.gelu(jnp.asarray(x), approximate)
    got = P.gelu(torch.from_numpy(x), approximate)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_exact_and_tanh_gelu_differ():
    x = torch.linspace(-4, 4, 101)
    d = (P.gelu(x, False) - P.gelu(x, True)).abs().max().item()
    assert 0 < d <= 3e-3


@pytest.mark.parametrize("slope", [0.01, 0.2])
def test_leaky_relu_matches_jax(rng, slope):
    x = rng.normal(size=(5, 9)).astype(np.float32)
    want = J.leaky_relu(jnp.asarray(x), slope)
    got = P.leaky_relu(torch.from_numpy(x), slope)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_dewire_pcm16_matches_jax(rng):
    pcm = rng.integers(-32768, 32767, size=(2, 50)).astype(np.int16)
    want = J.dewire_pcm16(jnp.asarray(pcm))
    got = P.dewire_pcm16(torch.from_numpy(pcm))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), _np(want))
    f = torch.randn(3, 4)
    assert P.dewire_pcm16(f) is f


def test_dropout_is_identity_at_eval(rng):
    x = torch.randn(4, 8)
    assert P.dropout(x, 0.5) is x
    assert P.dropout(x, 0.5, train=False) is x
    assert P.dropout(x, 0.0, train=True) is x
    with pytest.raises(NotImplementedError, match="not ported"):
        P.dropout(x, 0.5, train=True)
