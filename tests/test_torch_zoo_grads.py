"""The AASIST and ResNet loss terms and their gradients, the port against
the JAX package, on the CPU at the tiny SSL config, under every
``loss_type`` (AASIST through a train forward with the JAX package's own
dropout draws, handed to the port as ``dropout_masks``).

The JAX gradients are taken op by op (``jax.vjp`` outside ``jit``, the
literal reading of the JAX code): one forward, one pull-back per loss term,
and a ``loss_type``'s gradient is the sum of its terms'.  The JAX model
takes the port's discrete choices (ReLU and SELU signs, arg-maxima, top-k
order; ``tests/zoo_pins.py``): both sides sum in their own order, and a
ReLU input within a rounding error of 0 can fall on either side, which
moves every gradient upstream of it by up to 1e-2 of the leaf.
``test_the_two_sides_differ_only_at_ties`` shows that the JAX model's own
choices differ from the port's only at such ties.

Tolerances, with their reasons:
- loss terms: rtol 1e-5 / atol 2e-5 (fp32, another summation order); the
  SupCon terms rtol 1e-4, since they divide the similarities by the
  temperature (0.07) inside an exponential, which carries the
  similarities' fp32 rounding up fourteen-fold;
- gradients, leaf by leaf: ``zoo_pins.assert_grads_close`` (rtol 1e-5 and
  5e-4 of the leaf's largest entry; the worst reading is 1.8e-4, most
  leaves are within 2e-5; leaves that are zero by the model's structure
  are held to 5e-5 of their part's largest gradient on both sides);
- choices: where the JAX model's own forward chose otherwise, its input was
  within 1e-4 of the site's largest input of a tie (readings: at most
  1e-5, 2 signs in AASIST and 49 in ResNet-18, none elsewhere)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.aasist import XLSRAasist as JAasist
from scl_deepfake_audio_detection_tpu.models.base import model_buffers
from scl_deepfake_audio_detection_tpu.models.resnet import XLSRResNet as JResNet
from scl_deepfake_audio_detection_torch.models import xlsr as PX
from scl_deepfake_audio_detection_torch.models.aasist import XLSRAasist
from scl_deepfake_audio_detection_torch.models.params import from_jax, load_jax_params
from scl_deepfake_audio_detection_torch.models.resnet import XLSRResNet

import zoo_pins

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_cli_eval.py
torch.set_num_threads(2)

KINDS = {"aasist": (JAasist, XLSRAasist), "resnet": (JResNet, XLSRResNet)}
TERMS = ("L_CE", "L_CF1", "L_CF2")
LOSS_TYPES = {1: TERMS, 2: ("L_CE", "L_CF1"), 3: ("L_CE", "L_CF2"), 4: ("L_CE",),
              5: ("L_CF1", "L_CF2")}


def _masks(model, key, n, t):
    if not isinstance(model, XLSRAasist):
        return None
    keys = jax.random.split(key, 24)
    return [torch.from_numpy(np.array(jax.random.bernoulli(keys[1 + i], 1.0 - rate, shape)))
            for i, (rate, shape) in enumerate(model.dropout_sites(n, t))]


@pytest.fixture(scope="module", params=sorted(KINDS))
def grads(request):
    """Both sides' loss terms and per-term gradients (port names), the JAX
    model pinned to the port's discrete choices (``tests/zoo_pins.py``),
    and the choices of the JAX model's own eager forward."""
    kind = request.param
    rng = np.random.default_rng(0)
    wav = (0.1 * rng.normal(size=(4, 3200))).astype(np.float32)
    labels = np.array([1, 1, 0, 0], np.int32)
    jm = KINDS[kind][0](ssl=JX.XLSRConfig.tiny())
    params = jax.jit(jm.init)(jax.random.key(0))
    buffers = model_buffers(jm)
    key = jax.random.key(6)

    model = load_jax_params(KINDS[kind][1](ssl=PX.XLSRConfig.tiny(), device="cpu"),
                            jax.tree.map(np.asarray, params))
    with zoo_pins.record_port() as choices:
        out = model.apply(torch.from_numpy(wav), train=True,
                          dropout_masks=_masks(model, key, *wav.shape))
    pterms = model.loss(out, torch.from_numpy(labels))
    names = [n for n, _ in model.named_parameters()]
    params_t = [p for _, p in model.named_parameters()]
    pgrads = {}
    for t in TERMS:
        g = torch.autograd.grad(pterms[t], params_t, retain_graph=True, allow_unused=True)
        pgrads[t] = {n: (torch.zeros_like(p) if gi is None else gi)
                     for n, p, gi in zip(names, params_t, g)}

    def terms_of(p):
        out, _ = jm.apply(p, jnp.asarray(wav), train=True, rng=key, buffers=buffers,
                          mutable=True)
        return jm.loss(out, jnp.asarray(labels))

    with zoo_pins.pin_jax(choices):
        jterms, pull = jax.vjp(terms_of, params)
    jgrads = {}
    for t in TERMS:
        ct = {k: jnp.ones(()) if k == t else jnp.zeros(()) for k in jterms}
        jgrads[t] = from_jax(jax.tree.map(np.asarray, pull(ct)[0]), model)
    with zoo_pins.jax_choices() as seen:
        terms_of(params)
    return kind, jm, {k: float(v) for k, v in jterms.items()}, \
        {k: float(v.detach()) for k, v in pterms.items()}, jgrads, pgrads, \
        zoo_pins.disagreements(choices, seen)


@pytest.mark.parametrize("loss_type", sorted(LOSS_TYPES))
def test_loss_terms_match_jax(grads, loss_type):
    kind, jm, jterms, pterms, _, _, _ = grads
    jm = type(jm)(ssl=jm.ssl, loss_type=loss_type)
    model = KINDS[kind][1](ssl=PX.XLSRConfig.tiny(), loss_type=loss_type, device="meta")
    from scl_deepfake_audio_detection_torch.models.base import ModelOutput

    z = torch.zeros(4, 2)
    fake = ModelOutput(log_probs=z, feats=torch.ones(4, 3, 5), emb=torch.ones(4, 5), logits=z)
    assert sorted(LOSS_TYPES[loss_type]) == sorted(
        jm.loss(_fake_out(jm), jnp.zeros(4, jnp.int32))) == sorted(
        model.loss(fake, torch.zeros(4, dtype=torch.long)))
    for t in LOSS_TYPES[loss_type]:
        rtol = 1e-5 if t == "L_CE" else 1e-4
        np.testing.assert_allclose(pterms[t], jterms[t], rtol=rtol, atol=2e-5, err_msg=t)


def _fake_out(jm):
    """A ModelOutput of the right kinds for ``loss`` to name its terms."""
    from scl_deepfake_audio_detection_tpu.models.base import ModelOutput

    z = jnp.zeros((4, 2))
    return ModelOutput(log_probs=z, feats=jnp.ones((4, 3, 5)), emb=jnp.ones((4, 5)), logits=z)


@pytest.mark.parametrize("loss_type", sorted(LOSS_TYPES))
def test_gradients_match_jax(grads, loss_type):
    _, _, _, _, jgrads, pgrads, _ = grads
    terms = LOSS_TYPES[loss_type]
    want = {n: sum(jgrads[t][n] for t in terms) for n in jgrads[terms[0]]}
    got = {n: sum(pgrads[t][n] for t in terms) for n in want}
    zoo_pins.assert_grads_close(got, want, f"loss_type {loss_type}")


def test_the_two_sides_differ_only_at_ties(grads):
    """Every ReLU / SELU sign, max pool, elementwise maximum, ``max |x|``
    and top-k order of the JAX model's own eager forward against the
    port's: where they differ, the JAX input was within 1e-4 of the site's
    largest input of a tie."""
    kind, _, _, _, _, _, sites = grads
    assert len(sites) == {"aasist": 27, "resnet": 19}[kind]
    for i, (what, count, gap) in enumerate(sites):
        assert gap <= 1e-4, (i, what, count, gap)


def test_the_zoo_losses_scale_as_the_jax_heads(grads):
    """AASIST divides every term by N, the ResNet wrappers do not."""
    kind, jm, _, _, _, _, _ = grads
    from scl_deepfake_audio_detection_tpu.models.base import ModelOutput as JOut
    from scl_deepfake_audio_detection_torch.models.base import ModelOutput as POut

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 2)).astype(np.float32)
    feats = rng.normal(size=(4, 3, 5)).astype(np.float32)
    emb = rng.normal(size=(4, 5)).astype(np.float32)
    labels = np.array([1, 0, 1, 0], np.int32)
    want = jm.loss(JOut(log_probs=jnp.asarray(logits), feats=jnp.asarray(feats),
                        emb=jnp.asarray(emb), logits=jnp.asarray(logits)), jnp.asarray(labels))
    model = KINDS[kind][1](ssl=PX.XLSRConfig.tiny(), device="meta")
    got = model.loss(POut(log_probs=torch.from_numpy(logits), feats=torch.from_numpy(feats),
                          emb=torch.from_numpy(emb), logits=torch.from_numpy(logits)),
                     torch.from_numpy(labels))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
