"""Port XLS-R (``scl_deepfake_audio_detection_torch/models/xlsr.py``) vs the
JAX package at the tiny config, on the CPU, from one set of JAX-initialised
parameters carried across by ``models/params.from_jax``.

Tolerances: fp32 agrees to 1e-5 (float32 rounding of another summation
order).  bf16 is held to 6.25e-2 absolute, 4 bf16 ulps at |x| in [2, 4),
because the two frameworks round at different points: torch evaluates GELU
in fp32 and rounds once where XLA rounds bf16 elementwise ops; the port's
conv adds its bias before the one rounding, JAX after; the port's attention
(the flash kernel's semantics) normalises after PV, JAX's CPU einsum path
before; and the bf16 residual stream carries each of these on."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_torch.models import xlsr as PX
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.params import load_jax_params

torch.set_num_threads(2)
TOL = {"float32": 1e-5, "bfloat16": 6.25e-2}


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _models(dtype):
    jcfg = JX.XLSRConfig.tiny(compute_dtype=dtype)
    params = jax.tree.map(np.asarray, JLinearNLL(ssl=jcfg, emb_dim=16).init(jax.random.key(0)))
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(compute_dtype=dtype), emb_dim=16, device="cpu")
    return jcfg, params, load_jax_params(model, params).eval()


def _close(got, want, dtype):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), _f32(want), atol=TOL[dtype], rtol=0)


@pytest.fixture
def wav():
    return (0.1 * np.random.default_rng(0).normal(size=(2, 8000))).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_encoder_matches_jax(wav, dtype):
    jcfg, params, model = _models(dtype)
    want = JX.feature_encoder(params["ssl"], jcfg, jnp.asarray(wav))
    with torch.inference_mode():
        got = model.ssl.feature_encoder(torch.from_numpy(wav))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pos_conv_embed_matches_jax(dtype):
    jcfg, params, model = _models(dtype)
    x = jnp.asarray(np.random.default_rng(1).normal(size=(2, 399, 32)), jnp.dtype(dtype))
    want = JX._pos_conv_embed(params["ssl"], jcfg, x)
    with torch.inference_mode():
        got = model.ssl.pos_conv_embed(torch.from_numpy(_f32(x)).to(getattr(torch, dtype)))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [None, 380])
def test_encoder_layer_matches_jax(dtype, kv_len):
    jcfg, params, model = _models(dtype)
    x = jnp.asarray(np.random.default_rng(2).normal(size=(2, 399, 32)), jnp.dtype(dtype))
    layer0 = jax.tree.map(lambda a: a[0], params["ssl"]["encoder"]["layers"])
    want = JX._encoder_layer(layer0, jcfg, x, kv_len, None, True)
    with torch.inference_mode():
        got = model.ssl.encoder.layers[0](
            torch.from_numpy(_f32(x)).to(getattr(torch, dtype)), kv_len)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extract_features_matches_jax(wav, dtype):
    jcfg, params, model = _models(dtype)
    want = JX.extract_features(params["ssl"], jcfg, jnp.asarray(wav))
    with torch.inference_mode():
        got = model.ssl.extract_features(torch.from_numpy(wav))
        got3 = model.ssl.extract_features(torch.from_numpy(wav)[:, :, None])
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    assert torch.equal(got, got3)


@pytest.mark.parametrize("name", PX.XLSRConfig.preset_names())
def test_presets_match_jax(name):
    mine = getattr(PX.XLSRConfig, name)(compute_dtype="bfloat16")
    ref = getattr(JX.XLSRConfig, name)(compute_dtype="bfloat16")
    for f in ("conv_layers", "conv_bias", "encoder_dim", "encoder_layers", "ffn_dim",
              "num_heads", "pos_conv_kernel", "pos_conv_groups", "layer_norm_eps"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.head_dim == ref.head_dim and mine.approx_gelu == ref.approx_gelu
    for n in (16000, 64000, 64600):
        assert mine.num_frames(n) == ref.num_frames(n)


def test_flagship_shape_constants():
    cfg = PX.XLSRConfig.xlsr_300m()
    assert (cfg.num_frames(64600), cfg.num_frames(64000), cfg.head_dim) == (201, 199, 64)
    assert not cfg.approx_gelu and cfg.with_(compute_dtype="bfloat16").approx_gelu
    assert cfg.with_(gelu_impl="tanh").approx_gelu and not cfg.with_(
        compute_dtype="bfloat16", gelu_impl="exact").approx_gelu


@pytest.mark.parametrize("kw,err", [({"model": "wav2vec2_btse"}, NotImplementedError),
                                    ({"model": "wav2vec2_btse"}, NotImplementedError),
                                    ({"model": "xlsr_btse"}, NotImplementedError),
                                    ({"attention_impl": "xla"}, ValueError)])
def test_unported_options_raise(kw, err):
    """Every XLS-R option is ported; the BTSE back-end (Slice G2) is not,
    and the TPU's 'xla' attention has no counterpart."""
    from scl_deepfake_audio_detection_torch.utils.registry import MODELS

    with pytest.raises(err):
        if "model" in kw:
            MODELS.get(kw["model"])
        else:
            PX.XLSR(PX.XLSRConfig.tiny(**kw))
    for impl in ("conv", "gemm", "phase"):
        PX.XLSR(PX.XLSRConfig.tiny(conv_impl=impl, fuse_qkv=True))


# the JAX test's phase stack (k > s overlap with cin > 1, k = s, k = 3 s / 2)
PHASE_STACK = ((6, 10, 5), (8, 5, 3), (8, 3, 2), (8, 2, 2))


@pytest.mark.parametrize("impl", ["gemm", "phase"])
@pytest.mark.parametrize("stack", [None, PHASE_STACK], ids=["tiny", "phase_stack"])
def test_conv_impls_match_jax_and_conv(impl, stack):
    """'gemm' and 'phase' against the JAX package's own impls and against
    the port's 'conv', at the JAX test's 2e-5 (fp32)."""
    kw = {} if stack is None else {"conv_layers": stack}
    jcfg = JX.XLSRConfig.tiny(conv_impl=impl, **kw)
    params = jax.tree.map(np.asarray, JX.init_xlsr(jax.random.key(0), jcfg))
    wav = np.random.default_rng(4).normal(size=(2, 3201)).astype(np.float32)
    want = np.asarray(JX.feature_encoder(params, jcfg, jnp.asarray(wav)))
    x = torch.from_numpy(wav)
    got = {}
    for name in ("conv", impl):
        model = load_jax_params(PX.XLSR(PX.XLSRConfig.tiny(conv_impl=name, **kw)), params)
        with torch.inference_mode():
            got[name] = model.feature_encoder(x).numpy()
    assert got[impl].shape == want.shape
    np.testing.assert_allclose(got[impl], want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[impl], got["conv"], atol=2e-5, rtol=0)


@pytest.mark.parametrize("impl", ["gemm", "phase"])
def test_conv_impls_bf16_match_jax(wav, impl):
    """bf16: fp32 products of bf16 operands rounded once after LN, in both
    packages; held to the file's bf16 tolerance."""
    jcfg, params, _ = _models("bfloat16")
    jcfg = jcfg.with_(conv_impl=impl)
    want = JX.feature_encoder(params["ssl"], jcfg, jnp.asarray(wav))
    model = load_jax_params(PX.XLSR(PX.XLSRConfig.tiny(compute_dtype="bfloat16",
                                                       conv_impl=impl)), params["ssl"])
    with torch.inference_mode():
        got = model.feature_encoder(torch.from_numpy(wav))
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


def _fused_grads(ssl_tree, policy):
    """Output and fp32 parameter gradients of the fused-QKV port XLS-R under
    remat ``policy`` (None: no remat) for sum(out * g)."""
    cfg = PX.XLSRConfig.tiny(fuse_qkv=True, remat=policy is not None,
                             remat_policy=policy or "attn")
    model = load_jax_params(PX.XLSR(cfg), ssl_tree)
    wav = torch.from_numpy((0.1 * np.random.default_rng(0).normal(size=(2, 2000)))
                           .astype(np.float32))
    out = model.extract_features(wav)
    g = np.random.default_rng(1).normal(size=tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), {n: p.grad.numpy() for n, p in model.named_parameters()}, g


@pytest.fixture(scope="module")
def fused_jax():
    """The JAX fuse_qkv=True forward and gradients on the same inputs."""
    from scl_deepfake_audio_detection_torch.models.params import from_jax

    tree = jax.tree.map(np.asarray, JX.init_xlsr(jax.random.key(3), JX.XLSRConfig.tiny()))
    jcfg = JX.XLSRConfig.tiny(fuse_qkv=True)
    wav = jnp.asarray((0.1 * np.random.default_rng(0).normal(size=(2, 2000))).astype(np.float32))
    out = np.asarray(JX.extract_features(jax.tree.map(jnp.asarray, tree), jcfg, wav))
    g = np.random.default_rng(1).normal(size=out.shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(JX.extract_features(p, jcfg, wav) * g))(
        jax.tree.map(jnp.asarray, tree))
    want = from_jax(jax.tree.map(np.asarray, grads), PX.XLSR(PX.XLSRConfig.tiny()))
    return tree, out, {n: t.numpy() for n, t in want.items()}


@pytest.mark.parametrize("policy", [None, *PX.REMAT_POLICIES])
def test_fuse_qkv_forward_and_grads_match_jax(fused_jax, policy):
    """fuse_qkv: one [D, 3D] product over the same q/k/v parameters, q
    scaled after the split; forward and fp32 gradients within 1e-5 of JAX's
    fuse_qkv=True (gradients relative to the leaf's largest, at least 1),
    under every remat policy."""
    tree, want_out, want = fused_jax
    got_out, got, _ = _fused_grads(tree, policy)
    np.testing.assert_allclose(got_out, want_out, atol=1e-5, rtol=0)
    assert set(got) == set(want)
    for n, a in got.items():
        tol = 1e-5 * max(np.abs(want[n]).max(), 1.0)
        np.testing.assert_allclose(a, want[n], atol=tol, rtol=0, err_msg=n)


def test_reference_attention_impl_matches_flash_in_fp32(wav):
    _, params, model = _models("float32")
    ref = LinearNLL(ssl=PX.XLSRConfig.tiny(attention_impl="reference"), emb_dim=16,
                    device="cpu")
    load_jax_params(ref, params).eval()
    with torch.inference_mode():
        a = model.ssl(torch.from_numpy(wav))
        b = ref.ssl(torch.from_numpy(wav))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
