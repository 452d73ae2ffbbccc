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


@pytest.mark.parametrize("kw,err", [({"conv_impl": "gemm"}, NotImplementedError),
                                    ({"conv_impl": "phase"}, NotImplementedError),
                                    ({"fuse_qkv": True}, NotImplementedError),
                                    ({"attention_impl": "xla"}, ValueError)])
def test_unported_options_raise(kw, err):
    with pytest.raises(err):
        PX.XLSR(PX.XLSRConfig.tiny(**kw))


def test_reference_attention_impl_matches_flash_in_fp32(wav):
    _, params, model = _models("float32")
    ref = LinearNLL(ssl=PX.XLSRConfig.tiny(attention_impl="reference"), emb_dim=16,
                    device="cpu")
    load_jax_params(ref, params).eval()
    with torch.inference_mode():
        a = model.ssl(torch.from_numpy(wav))
        b = ref.ssl(torch.from_numpy(wav))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
