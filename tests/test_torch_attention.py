"""Port attention (``scl_deepfake_audio_detection_torch/ops/attention.py``)
vs the JAX package, on the CPU.

``flash_attention_forward_reference`` is held against the Pallas kernel
``_flash_forward`` run in interpret mode (as ``tests/test_attention.py``
runs it), in O and LSE.  Tolerances: fp32 differs by summation order only
(2e-5); in bf16 the Pallas kernel rounds P at the running max of each
128-key block while the plain version rounds at the final max, and O is
rounded to bf16, so O is held to a few bf16 ulps (3e-2) and LSE, which
both compute in fp32, to 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.ops import attention as JA
from scl_deepfake_audio_detection_torch.ops import _kernels
from scl_deepfake_audio_detection_torch.ops import attention as PA


def _qkv(rng, b=1, h=2, t=40, d=16):
    q = (rng.normal(size=(b, h, t, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.normal(size=(b, h, t, d)).astype(np.float32)
    v = rng.normal(size=(b, h, t, d)).astype(np.float32)
    return q, k, v


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("t,kv_len", [(128, None), (128, 100), (199, None), (199, 186),
                                      (201, None), (201, 188), (256, None), (256, 201)])
def test_flash_reference_matches_interpret_pallas(rng, t, kv_len):
    from jax.experimental.pallas import tpu as pltpu

    q, k, v = _qkv(rng, t=t)
    with pltpu.force_tpu_interpret_mode():
        jo, jl = JA._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len)
    po, pl = PA.flash_attention_forward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv_len)
    assert po.shape == (1, 2, t, 16) and pl.shape == (1, 2, t) and pl.dtype == torch.float32
    np.testing.assert_allclose(po.numpy(), _f32(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(pl.numpy(), _f32(jl), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv_len", [None, 188])
def test_flash_reference_matches_interpret_pallas_bf16(rng, kv_len):
    from jax.experimental.pallas import tpu as pltpu

    q, k, v = _qkv(rng, t=201)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        jo, jl = JA._flash_forward(jq, jk, jv, kv_len)
    tq, tk, tv = (torch.from_numpy(_f32(a)).bfloat16() for a in (jq, jk, jv))
    po, pl = PA.flash_attention_forward_reference(tq, tk, tv, kv_len)
    assert po.dtype == torch.bfloat16
    np.testing.assert_allclose(po.float().numpy(), _f32(jo), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(pl.numpy(), _f32(jl), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [None, 29])
def test_attention_reference_matches_jax(rng, dtype, kv_len):
    q, k, v = _qkv(rng, b=2, t=37)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    want = JA.attention_reference(jq, jk, jv, kv_len)
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    got = PA.attention_reference(*(torch.from_numpy(_f32(a)).to(td) for a in (jq, jk, jv)),
                                 kv_len)
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(got.float().numpy(), _f32(want), rtol=tol, atol=tol)


def test_flash_reference_equals_attention_reference_fp32(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, t=50))
    o, lse = PA.flash_attention_forward_reference(q, k, v, 44)
    np.testing.assert_allclose(o.numpy(), PA.attention_reference(q, k, v, 44).numpy(),
                               rtol=1e-5, atol=1e-6)
    s = (q @ k.transpose(-1, -2))[..., :44]
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_self_attention_on_cpu_is_the_plain_flash_version(rng, impl):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, t=33))
    before = dict(_kernels.LAUNCHES)
    got = PA.self_attention(q, k, v, kv_len=30, impl=impl)
    want = PA.flash_attention_forward_reference(q, k, v, 30)[0]
    assert torch.equal(got, want)
    assert _kernels.LAUNCHES == before  # CPU tensors never reach the kernel


def test_self_attention_reference_impl_and_bad_impl(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, t=12))
    assert torch.equal(PA.self_attention(q, k, v, impl="reference"),
                       PA.attention_reference(q, k, v))
    with pytest.raises(ValueError):
        PA.self_attention(q, k, v, impl="xla")


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 8, 8)
    before = _kernels.LAUNCHES["flash_attn_fwd"]
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_attn_fwd(q, q, q)
    assert _kernels.LAUNCHES["flash_attn_fwd"] == before


BAD_INPUTS = {
    "non_contiguous": (lambda: torch.zeros(1, 8, 2, 16).transpose(1, 2), None, "contiguous"),
    "head_dim_not_multiple_of_8": (lambda: torch.zeros(1, 2, 8, 12), None, "head_dim"),
    "head_dim_above_128": (lambda: torch.zeros(1, 1, 8, 136), None, "head_dim"),
    "fp16": (lambda: torch.zeros(1, 2, 8, 16, dtype=torch.float16), None, "fp32 or bf16"),
    "kv_len_zero": (lambda: torch.zeros(1, 2, 8, 16), 0, "kv_len"),
    "kv_len_beyond_t": (lambda: torch.zeros(1, 2, 8, 16), 9, "kv_len"),
    "three_dims": (lambda: torch.zeros(2, 8, 16), None, "shape"),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_flash_forward_rejects_what_the_kernel_does_not_take(case):
    """The CPU path checks the kernel's input contract too, so a layout the
    card would refuse fails here first."""
    make, kv_len, msg = BAD_INPUTS[case]
    x = make()
    with pytest.raises(ValueError, match=msg):
        PA.flash_attention_forward(x, x, x, kv_len)


def test_kernel_library_name_tracks_source_and_flags():
    path = _kernels._library_path("flash_attn_fwd")
    assert path.parent == _kernels.BUILD_DIR and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    assert (_kernels.CSRC / "flash_attn_fwd.cu").exists()


def test_reset_launches_zeroes_every_counter():
    _kernels.LAUNCHES["flash_attn_fwd"] += 3
    _kernels.reset_launches()
    assert all(n == 0 for n in _kernels.LAUNCHES.values())
