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


# ------------------------------------------------ the rest of ops/losses
# fp32 from the same inputs in both; 1e-6 relative and absolute (summation
# order only, over at most a few dozen terms)
TOL6 = dict(rtol=1e-6, atol=1e-6)


def _both(fn_name, *arrays, **kw):
    """(port, JAX) value of ``fn_name`` on the same numpy inputs."""
    got = getattr(PL, fn_name)(*(torch.from_numpy(np.array(a)) for a in arrays), **kw)
    want = getattr(JL, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    return got.detach().numpy(), np.asarray(want)


@pytest.mark.parametrize("temp", [1.0, 4.0, 20.0])
def test_kld_distill_matches_jax_and_ignores_a_row_shift(rng, temp):
    """KL(teacher || student) * T^2, batchmean; the models hand it
    log-probabilities, which give the same value as the logits
    (``tests/test_distill.py``'s identity)."""
    s, t = _feat(rng, (6, 2)) * 3, _feat(rng, (6, 2)) * 3
    got, want = _both("kld_distill", s, t, temp=temp)
    np.testing.assert_allclose(got, want, **TOL6)
    logp = lambda z: torch.log_softmax(torch.from_numpy(z), -1)  # noqa: E731
    shifted = PL.kld_distill(logp(s), logp(t), temp=temp).item()
    assert shifted == pytest.approx(float(got), rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("temp", [1.0, 2.5])
def test_neg_energy_matches_jax(rng, temp):
    got, want = _both("neg_energy", _feat(rng, (7, 3)) * 2, temperature=temp)
    np.testing.assert_allclose(got, want, **TOL6)


@pytest.mark.parametrize("flag_in", [True, False])
def test_neg_energy_reg_loss_matches_jax(rng, flag_in):
    energy = _feat(rng, (9,)) * 5
    got, want = _both("neg_energy_reg_loss", energy, margin_in=-1.0, margin_out=1.5,
                      flag_in=flag_in)
    np.testing.assert_allclose(got, want, **TOL6)


def test_mixup_ce_matches_jax(rng):
    logits = _feat(rng, (8, 3)) * 2
    y1, y2 = rng.integers(0, 3, 8), rng.integers(0, 3, 8)
    gammas = rng.uniform(size=8).astype(np.float32)
    np.testing.assert_allclose(*_both("mixup_ce", logits, y1), **TOL6)
    np.testing.assert_allclose(*_both("mixup_ce", logits, y1, y2, gammas), **TOL6)
    for args in ((y1, y2, None), (y1, None, gammas)):
        with pytest.raises(ValueError, match="together") as want:
            JL.mixup_ce(jnp.asarray(logits), *(None if a is None else jnp.asarray(a)
                                               for a in args))
        with pytest.raises(ValueError, match="together") as got:
            PL.mixup_ce(torch.from_numpy(logits), *(None if a is None else torch.from_numpy(a)
                                                    for a in args))
        assert str(got.value) == str(want.value)


def test_neg_cosine_and_margin_ranking_match_jax(rng):
    a, b = _feat(rng, (3, 4)), _feat(rng, (3, 4))
    np.testing.assert_allclose(*_both("_neg_cosine", a, b), **TOL6)
    np.testing.assert_allclose(*_both("_neg_cosine", a, np.zeros_like(a)), **TOL6)
    np.testing.assert_allclose(*_both("_margin_ranking", a[0], b[0]), **TOL6)
    np.testing.assert_allclose(*_both("_margin_ranking", a[0], b[0], margin=0.5), **TOL6)


@pytest.mark.parametrize("bs", [2, 3, 6])
@pytest.mark.parametrize("variant", ["default", "anchor", "diff_mat", "margin"])
def test_rank_consistency_matches_jax(rng, bs, variant):
    """The anchored form (default anchor, a given anchor, a given difference
    matrix, the margin metric); fewer than 3 rows give 0."""
    x = _feat(rng, (bs, 5))
    kw_p, kw_j = {}, {}
    if variant == "anchor":
        anchor = _feat(rng, (5,))
        kw_p["anchor"], kw_j["anchor"] = torch.from_numpy(anchor), jnp.asarray(anchor)
    elif variant == "diff_mat":
        dm = _feat(rng, (bs, bs, 5))
        kw_p["diff_mat"], kw_j["diff_mat"] = torch.from_numpy(dm), jnp.asarray(dm)
    elif variant == "margin":
        kw_p["metric"], kw_j["metric"] = PL._margin_ranking, JL._margin_ranking
    got = PL.rank_consistency(torch.from_numpy(x), **kw_p)
    want = JL.rank_consistency(jnp.asarray(x), **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL6)


@pytest.mark.parametrize("bs", [1, 2, 3, 7])
def test_rank_consistency_v2_and_v3_match_jax(rng, bs):
    x = _feat(rng, (bs, 4))
    np.testing.assert_allclose(*_both("rank_consistency_v2", x), **TOL6)
    np.testing.assert_allclose(*_both("rank_consistency_v3", x), **TOL6)
    v = _feat(rng, (bs,))  # scalars per row, the reference's ranking use
    np.testing.assert_allclose(*_both("rank_consistency_v3", v), **TOL6)
    dm = _feat(rng, (bs, bs, 4))
    got = PL.rank_consistency_v2(None, diff_mat=torch.from_numpy(dm))
    want = JL.rank_consistency_v2(None, diff_mat=jnp.asarray(dm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL6)
