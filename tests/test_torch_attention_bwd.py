"""Port flash-attention backward (``scl_deepfake_audio_detection_torch/
ops/attention.py``) vs the JAX package, on the CPU.

``flash_attention_backward_reference`` is held against the two Pallas
backward kernels of ``_flash_backward`` run in interpret mode (as
``tests/test_attention.py`` runs them), on the same q, k, v, O, LSE and dO.
Tolerances: fp32 differs by summation order only (2e-5 absolute, 1e-5
relative).  In bf16 both round P and dS to bf16 at the same points and only
the fp32 sums before each rounding differ in order, so a value may land one
bf16 step away: each gradient is held to one bf16 ulp of its largest
magnitude (2^-7 of max |x|).  D = rowsum(dO * O) is an fp32 sum of the same
products in both (exact products for bf16 inputs) in another order: a sum of
n terms is off by at most about n 2^-24 times the sum of their magnitudes,
so D is held to 1e-5 of the largest row's sum of |dO * O|.

Every interpreted Pallas run starts from a fresh interpret-mode state (the
``interpret`` fixture), and a mismatch names both sides' largest magnitude
and their largest difference."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.ops import attention as JA
from scl_deepfake_audio_detection_torch.ops import _kernels
from scl_deepfake_audio_detection_torch.ops import attention as PA

torch.set_num_threads(2)

# torch 2.13.0+cpu's first multi-threaded ``exp`` in a process can come out
# ~1e-4 off (relative) in one thread's chunk, and every later call is exact:
# it made the plain forward's O miss by ~2.5e-5 in one head under xdist.
# One throwaway call per process, before any test, keeps it out.
torch.exp(torch.zeros(1 << 20))


@pytest.fixture
def interpret():
    """Pallas's TPU interpret mode from a fresh simulator state: its shared
    state is per process and is left behind by a kernel that raised."""
    from jax.experimental.pallas import tpu as pltpu

    pltpu.reset_tpu_interpret_mode_state()
    return pltpu.force_tpu_interpret_mode


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _assert_close(port, jax_side, rtol, atol, name):
    """assert_allclose whose message names both sides' max |x| and the max
    |port - jax|."""
    port, jax_side = np.asarray(port, np.float32), np.asarray(jax_side, np.float32)
    msg = (f"{name}: max |port - jax| {np.abs(port - jax_side).max():.3e}, "
           f"max |port| {np.abs(port).max():.3e}, max |jax| {np.abs(jax_side).max():.3e}")
    np.testing.assert_allclose(port, jax_side, rtol=rtol, atol=atol, err_msg=msg)


def _inputs(rng, t, b=1, h=2, d=16):
    q = (rng.normal(size=(b, h, t, d)) / np.sqrt(d)).astype(np.float32)
    k, v, g = (rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3))
    return q, k, v, g


def _pallas_backward(interpret, q, k, v, g, kv_len, jdtype):
    jq, jk, jv, jg = (jnp.asarray(a, jdtype) for a in (q, k, v, g))
    with interpret():
        o, lse = JA._flash_forward(jq, jk, jv, kv_len)
        grads = JA._flash_backward(jq, jk, jv, o, lse, jg, kv_len)
    return (jq, jk, jv, o, lse, jg), grads


def _torch(a, dtype):
    return torch.from_numpy(_f32(a)).to(dtype)


@pytest.mark.parametrize("t,kv_len", [(128, None), (128, 115), (199, None), (199, 186),
                                      (201, None), (201, 188), (256, None), (256, 243)])
def test_plain_backward_matches_interpret_pallas_fp32(rng, interpret, t, kv_len):
    ins, want = _pallas_backward(interpret, *_inputs(rng, t), kv_len, jnp.float32)
    got = PA.flash_attention_backward_reference(*(_torch(a, torch.float32) for a in ins),
                                                kv_len)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == (1, 2, t, 16), name
        _assert_close(a.numpy(), _f32(b), 1e-5, 2e-5, name)
    if kv_len is not None:  # keys past kv_len get exactly zero gradient
        assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()


@pytest.mark.parametrize("kv_len", [None, 188])
def test_plain_backward_matches_interpret_pallas_bf16(rng, interpret, kv_len):
    ins, want = _pallas_backward(interpret, *_inputs(rng, 201), kv_len, jnp.bfloat16)
    got = PA.flash_attention_backward_reference(
        *(_torch(a, torch.float32 if a.dtype == jnp.float32 else torch.bfloat16)
          for a in ins), kv_len)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16, name
        w = _f32(b)
        _assert_close(a.float().numpy(), w, 0, 2.0 ** -7 * np.abs(w).max(), name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,kv_len", [(t, kv) for t in (63, 64, 65, 128, 199, 201)
                                      for kv in (None, t - 13)])
def test_plain_dq_and_delta_match_interpret_pallas(rng, interpret, t, kv_len, dtype):
    """The plain version of the dq kernel's contract, (dq, D) from q, k, v,
    O, dO and LSE, against the dq of interpret-mode ``_flash_backward`` and
    against D as ``_flash_backward`` computes it (``jnp.sum(g.astype(f32) *
    o.astype(f32), -1)``)."""
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    (jq, jk, jv, jo, jlse, jg), (jdq, _, _) = _pallas_backward(
        interpret, *_inputs(rng, t), kv_len, jdtype)
    jdelta = jnp.sum(jg.astype(jnp.float32) * jo.astype(jnp.float32), axis=-1)
    tdtype = getattr(torch, dtype)
    q, k, v, o, g = (_torch(a, tdtype) for a in (jq, jk, jv, jo, jg))
    dq, delta = PA.flash_bwd_dq_delta_reference(q, k, v, o, g, _torch(jlse, torch.float32),
                                                kv_len)
    assert dq.dtype == tdtype and tuple(dq.shape) == (1, 2, t, 16)
    assert delta.dtype == torch.float32 and tuple(delta.shape) == (1, 2, t)
    tol_delta = 1e-5 * float(np.abs(_f32(jg) * _f32(jo)).sum(-1).max())
    _assert_close(delta.numpy(), _f32(jdelta), 0, tol_delta, "D")
    w = _f32(jdq)
    if dtype == "float32":
        _assert_close(dq.numpy(), w, 1e-5, 2e-5, "dq")
    else:
        _assert_close(dq.float().numpy(), w, 0, 2.0 ** -7 * np.abs(w).max(), "dq")


@pytest.mark.parametrize("t,kv_len", [(199, None), (201, 188)])
def test_autograd_through_self_attention_matches_jax_grad(rng, interpret, t, kv_len):
    """torch.autograd through the port's dispatch vs jax.grad through the
    JAX flash_attention (Pallas forward and backward, interpret mode)."""
    q, k, v, g = _inputs(rng, t, b=2)

    def jloss(q, k, v):
        return jnp.sum(JA.flash_attention(q, k, v, kv_len) * g)

    with interpret():
        want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = PA.self_attention(tq, tk, tv, kv_len=kv_len)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, b in zip("qkv", got, want):
        _assert_close(a.numpy(), _f32(b), 1e-5, 2e-5, name)


def test_plain_backward_is_dq_and_delta_then_dkv(rng):
    """flash_attention_backward_reference is the dq contract's plain version
    followed by dk/dv's, fed its D: the same arithmetic, bit for bit."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(rng, 45))
    o, lse = PA.flash_attention_forward_reference(q, k, v, 40)
    dq, delta = PA.flash_bwd_dq_delta_reference(q, k, v, o, g, lse, 40)
    assert torch.equal(delta, (g * o).sum(-1))
    want = (dq, *PA.flash_bwd_dkv_reference(q, k, v, g, lse, delta, 40))
    got = PA.flash_attention_backward(q, k, v, o, lse, g, 40)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kv_len", [None, 30])
def test_flash_gradients_match_autograd_of_plain_attention(rng, kv_len):
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(rng, 37, b=2))
    grads = {}
    for impl in ("flash", "reference"):
        x = [a.clone().requires_grad_() for a in (q, k, v)]
        out = PA.self_attention(*x, kv_len=kv_len, impl=impl)
        grads[impl] = torch.autograd.grad((out * g).sum(), x)
    for a, b in zip(grads["flash"], grads["reference"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=2e-6)


def test_cpu_backward_never_reaches_the_kernels(rng):
    q, k, v, g = (torch.from_numpy(a).requires_grad_() for a in _inputs(rng, 20))
    before = dict(_kernels.LAUNCHES)
    (PA.flash_attention(q, k, v, 17) * g.detach()).sum().backward()
    assert _kernels.LAUNCHES == before
    assert q.grad is not None and k.grad is not None and v.grad is not None


def test_backward_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 1, 8, 8)
    s = torch.zeros(1, 1, 8)
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_attn_bwd_dq(x, x, x, x, x, s)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_attn_bwd_dkv(x, x, x, x, s, s)
    assert _kernels.LAUNCHES == before


def test_every_kernel_has_a_source_and_a_signature():
    assert set(_kernels.KERNELS) == {"flash_attn_fwd", "flash_attn_bwd_dq",
                                     "flash_attn_bwd_dkv"}
    for name in _kernels.KERNELS:
        assert (_kernels.CSRC / _kernels.SOURCES[name]).exists()
        assert name in _kernels.ARGTYPES and name in _kernels.LAUNCHES
        assert name in (_kernels.CSRC / _kernels.SOURCES[name]).read_text()
    # the two backward kernels share one library
    assert (_kernels._library_path("flash_attn_bwd_dq")
            == _kernels._library_path("flash_attn_bwd_dkv")
            != _kernels._library_path("flash_attn_fwd"))
