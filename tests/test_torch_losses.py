"""Port losses (``ops/losses.py``, ``ops/supcon.py``, ``LinearNLL.loss``) vs
the JAX package, on the CPU, from numpy-seeded inputs.

Tolerance 1e-5 relative and absolute: both compute in fp32 and differ in
summation order only (the JAX similarities run at HIGHEST precision)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.models.base import ModelOutput as JOut
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.models.xlsr import XLSRConfig as JXLSRConfig
from scl_deepfake_audio_detection_tpu.ops import losses as JL
from scl_deepfake_audio_detection_tpu.ops import supcon as JS
from scl_deepfake_audio_detection_torch.models.base import ModelOutput
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
from scl_deepfake_audio_detection_torch.ops import losses as PL
from scl_deepfake_audio_detection_torch.ops import supcon as PS

TOL = dict(rtol=1e-5, atol=1e-5)


def _feat(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


SUPCON_CASES = {
    # name: (feat shape, labels, kwargs)
    "seq_all": ((6, 2, 5, 4), [1, 1, 0, 0, 1, 0], dict(contra_mode="all")),
    "seq_one": ((6, 2, 5, 4), [1, 1, 0, 0, 1, 0], dict(contra_mode="one")),
    "seq_length_norm": ((6, 2, 5, 4), [1, 1, 0, 0, 1, 0], dict(length_norm=True)),
    "zero_positive_row": ((5, 1, 3, 4), [1, 1, 0, 0, 2], dict(contra_mode="all")),
    "flat_dot": ((6, 2, 8), [0, 1, 0, 1, 1, 0], dict(sim_metric=None)),
    "emb_as_in_loss": ((11, 1, 16, 1), [1] * 5 + [0] * 6, dict(temperature=0.07)),
}


@pytest.mark.parametrize("case", sorted(SUPCON_CASES))
def test_supcon_matches_jax(rng, case):
    shape, labels, kw = SUPCON_CASES[case]
    feat = _feat(rng, shape)
    labels = np.array(labels)
    jkw = dict(kw)
    pkw = dict(kw)
    if "sim_metric" not in kw:
        jkw["sim_metric"], pkw["sim_metric"] = JS.seq_similarity, PS.seq_similarity

    def jloss(f):
        return JS.supcon_loss(f, labels=jnp.asarray(labels), **jkw)

    want, wgrad = jax.value_and_grad(jloss)(jnp.asarray(feat))
    f = torch.from_numpy(feat).requires_grad_()
    got = PS.supcon_loss(f, labels=torch.from_numpy(labels), **pkw)
    got.backward()
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(wgrad), **TOL)


def test_supcon_with_mask_and_without_labels_matches_jax(rng):
    feat = _feat(rng, (4, 2, 6))
    mask = (rng.random((4, 4)) > 0.5).astype(np.float32)
    np.fill_diagonal(mask, 1.0)
    for m in (mask, None):
        want = JS.supcon_loss(jnp.asarray(feat), mask=None if m is None else jnp.asarray(m),
                              sim_metric=None)
        got = PS.supcon_loss(torch.from_numpy(feat),
                             mask=None if m is None else torch.from_numpy(m), sim_metric=None)
        np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_supcon_rejects_what_jax_rejects(rng):
    f = torch.from_numpy(_feat(rng, (2, 1, 3)))
    with pytest.raises(ValueError, match="both"):
        PS.supcon_loss(f, labels=torch.tensor([0, 1]), mask=torch.eye(2))
    with pytest.raises(ValueError, match="contra_mode"):
        PS.supcon_loss(f, labels=torch.tensor([0, 1]), contra_mode="two")


def test_similarities_match_jax(rng):
    a, c = _feat(rng, (3, 7, 5)), _feat(rng, (4, 7, 5))
    np.testing.assert_allclose(
        PS.seq_similarity(torch.from_numpy(a), torch.from_numpy(c)).numpy(),
        np.asarray(JS.seq_similarity(jnp.asarray(a), jnp.asarray(c))), **TOL)
    a2, c2 = a.reshape(3, -1), c.reshape(4, -1)
    np.testing.assert_allclose(
        PS.flat_similarity(torch.from_numpy(a2), torch.from_numpy(c2)).numpy(),
        np.asarray(JS.flat_similarity(jnp.asarray(a2), jnp.asarray(c2))), **TOL)


def test_cross_entropy_and_double_softmax_match_jax(rng):
    logits = _feat(rng, (9, 2)) * 3
    labels = rng.integers(0, 2, size=9)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    for jf, pf, x in ((JL.cross_entropy, PL.cross_entropy, logits),
                      (JL.nll_on_log_probs, PL.nll_on_log_probs, lp)):
        want = jf(jnp.asarray(x), jnp.asarray(labels))
        got = pf(torch.from_numpy(np.array(x)), torch.from_numpy(labels))
        np.testing.assert_allclose(got.item(), float(want), **TOL)


@pytest.mark.parametrize("loss_type", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("contra_mode", ["all", "one"])
def test_linear_nll_loss_matches_jax(rng, loss_type, contra_mode):
    n, t, d = 11, 9, 16
    logits = _feat(rng, (n, 2))
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    feats, emb = _feat(rng, (n, t, d)), _feat(rng, (n, d))
    labels = np.array([1.0] * 5 + [0.0] * 6, np.float32)
    jm = JLinearNLL(ssl=JXLSRConfig.tiny(), emb_dim=d, loss_type=loss_type,
                    contra_mode=contra_mode)
    want = jm.loss(JOut(jnp.asarray(lp), jnp.asarray(feats), jnp.asarray(emb),
                        jnp.asarray(logits)), jnp.asarray(labels))
    pm = LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=d, loss_type=loss_type,
                   contra_mode=contra_mode, device="cpu")
    got = pm.loss(ModelOutput(*(torch.from_numpy(a) for a in (lp, feats, emb, logits))),
                  torch.from_numpy(labels))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), err_msg=k, **TOL)


def test_unknown_loss_type_raises():
    pm = LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=4, loss_type=6, device="cpu")
    out = ModelOutput(torch.zeros(2, 2), torch.zeros(2, 3, 4), torch.zeros(2, 4))
    with pytest.raises(ValueError, match="loss_type"):
        pm.loss(out, torch.tensor([0.0, 1.0]))
