"""The port's BTSE back-end (``models/btse`` with ``dsp/biosegment``,
``ops/relpos_transformer``, ``ops/rnn`` and the embedding tables) against
the JAX package's, on the CPU at the tiny SSL config: the bio tokens, the
rel-pos index shuffles, the encoder and the GRU, every ``bio_encoder_type``
with and without ``is_add`` in eval, train and bf16, ``bio_mask``, the loss
terms, gradients and AdamW's first moment, the parameter layout (square
tables included) and the matmul-weight cast.

Parameters are a seeded port model's, as a JAX tree (``to_jax``), which
both sides load (the port through ``models/params.load_jax_params``): a
JAX ``init`` under ``jit`` costs seconds a configuration, and
``test_conf5_builds_the_jax_model`` holds the two trees' shapes equal.
Inputs come from a numpy seed.  The waveforms hold stretches at full level, at
-40 dB and at exact zero, so that every token (TALKING, BREATHING,
SILENCE) occurs: Gaussian noise alone gives TALKING everywhere.

The tokens are held exactly.  A frame whose energy lies within
``NEAR_DB`` of a threshold may take either token in the two packages (the
energies are summed in another order): such frames are reported, and the
JAX model is then given the port's tokens through its ``bio=`` argument
(``jax_bio``), as ``tests/zoo_pins.py`` gives it the port's ReLU signs.

Tolerances, with their reasons:
- tokens, the rel-pos shuffles and window tables: exact (integer
  thresholds; pads and reshapes);
- forwards, the encoder, the GRU and the loss terms: rtol 1e-5 / atol 1e-5
  in fp32 (the same operations summed in another order); SupCon terms
  rtol 1e-4 (the similarities over the temperature 0.07 inside an
  exponential);
- bf16 compute: 2e-3 on the log-probs, logits and embedding, and the
  frame features to 6.25e-2, the XLS-R bf16 tolerance of
  ``tests/test_torch_xlsr.py`` (the two packages round at other points);
- gradients and AdamW's first moment: ``zoo_pins.assert_grads_close`` (rtol
  1e-5 and 5e-4 of each leaf's largest entry), the JAX model pinned to the
  port's ReLU and LeakyReLU signs."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.dsp import biosegment as JBS
from scl_deepfake_audio_detection_tpu.models import btse as JB
from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.base import ModelOutput as JOut
from scl_deepfake_audio_detection_tpu.models.base import cast_matmul_params as jcast
from scl_deepfake_audio_detection_tpu.ops import relpos_transformer as JRP
from scl_deepfake_audio_detection_tpu.ops import rnn as JRNN
from scl_deepfake_audio_detection_tpu.train import engine as JE
from scl_deepfake_audio_detection_tpu.utils.config import TrainConfig as JTrainConfig
from scl_deepfake_audio_detection_tpu.utils.config import load_config as jload_config
from scl_deepfake_audio_detection_torch.dsp import biosegment as PBS
from scl_deepfake_audio_detection_torch.models import xlsr as PX
from scl_deepfake_audio_detection_torch.models.base import ModelOutput as POut
from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
from scl_deepfake_audio_detection_torch.models.btse import XLSRBtse
from scl_deepfake_audio_detection_torch.models.params import (
    from_jax,
    jax_leaf_map,
    jax_layout,
    load_jax_params,
    to_jax,
    torch_layout,
)
from scl_deepfake_audio_detection_torch.ops import relpos_transformer as PRP
from scl_deepfake_audio_detection_torch.ops import rnn as PRNN
from scl_deepfake_audio_detection_torch.ops.losses import nll_on_log_probs
from scl_deepfake_audio_detection_torch.train import engine as PE
from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
from scl_deepfake_audio_detection_torch.utils.config import TrainConfig, load_config
from scl_deepfake_audio_detection_torch.utils.registry import MODELS

import zoo_pins

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_cli_eval.py
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF5 = os.path.join(REPO, "configs", "conf-5-btse-trans64.yaml")
RTOL, ATOL = 1e-5, 1e-5
NEAR_DB = 1e-4
ENCODERS = ("transformer", "gru", "conv", "light")
TERMS = ("L_CE", "L_CF1", "L_CF2")
LOSS_TYPES = {1: TERMS, 2: ("L_CE", "L_CF1"), 3: ("L_CE", "L_CF2"), 4: ("L_CE",),
              5: ("L_CF1", "L_CF2")}
LR = 1e-4


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, _np(want), rtol=rtol, atol=atol, err_msg=what)


def bio_wav(n=4, t=3200, seed=0):
    """Gaussian noise at 0.1 with, in each row, a stretch at 1/100 of that
    (-40 dB: BREATHING) and a stretch of exact zeros (SILENCE), placed
    differently per row."""
    rng = np.random.default_rng(seed)
    wav = (0.1 * rng.normal(size=(n, t))).astype(np.float32)
    for i in range(n):
        q = (i * t // (2 * n)) // 320 * 320 + 160  # stretches off the frame grid too
        wav[i, q:q + t // 5] *= 0.01
        z = t // 2 + q // 2
        wav[i, z:z + t // 6] = 0.0
    return wav


def near_threshold(wav, upper_db=30.0, lower_db=55.0):
    """Boolean [..., T_bio]: the frames whose port energy lies within
    ``NEAR_DB`` of either threshold."""
    e, peak = PBS.frame_energy_db(torch.from_numpy(np.asarray(wav)))
    gap = torch.minimum((e - (peak - upper_db)).abs(), (e - (peak - lower_db)).abs())
    return (gap < NEAR_DB).numpy()


def jax_bio(wav):
    """The tokens the JAX model is to use on ``wav``: its own (None) unless
    a frame lies near a threshold, then the port's, with a report."""
    near = near_threshold(wav)
    if not near.any():
        return None
    print(f"bio frames within {NEAR_DB} dB of a threshold (the port's tokens "
          f"pinned): {np.argwhere(near).tolist()}")
    return jnp.asarray(PBS.wav2bio(torch.from_numpy(np.asarray(wav))).numpy())


# ------------------------------------------------------------ configuration

def test_conf5_builds_the_jax_model(tmp_path):
    """Every key ``from_config`` reads, from conf-5 and from a YAML that
    sets each one off its default."""
    other = tmp_path / "b.yaml"
    other.write_text("model:\n  name: xlsr_btse\n  flag_fix_ssl: true\n  contra_mode: one\n"
                     "  loss_type: 3\n  n_bios: 5\n  bio_dim: 16\n  bio_out: 24\n"
                     "  pf_dim: 40\n  n_heads: 2\n  n_layers: 2\n  nb_classes: 3\n"
                     "  bio_encoder_type: gru\n  bio_rnn: 12\n  bio_hid: 20\n  is_add: true\n"
                     "data: {name: eval_only}\n")
    for path in (CONF5, str(other)):
        cfg, jcfg = load_config(path), jload_config(path)
        assert cfg.model.name == jcfg.model.name == "xlsr_btse"
        assert cfg.model.extra == jcfg.model.extra
        m = XLSRBtse.from_config(cfg.model, ssl=PX.XLSRConfig.tiny(), device="meta")
        jm = JB.XLSRBtse.from_config(jcfg.model, ssl=JX.XLSRConfig.tiny())
        got = to_jax(m, host=False)
        want = jax.eval_shape(jm.init, jax.random.key(0))
        assert jax.tree.structure(got) == jax.tree.structure(want), path
        assert [tuple(a.shape) for a in jax.tree.leaves(got)] == \
            [tuple(a.shape) for a in jax.tree.leaves(want)], path
        for f in ("bio_encoder_type", "is_add", "flag_fix_ssl", "contra_mode", "loss_type",
                  "num_classes", "bio_dim"):
            assert getattr(m, f) == getattr(jm, f), (path, f)
    assert MODELS.get("xlsr_btse") is MODELS.get("wav2vec2_btse") is XLSRBtse


def test_unknown_bio_encoder_is_refused():
    with pytest.raises(ValueError, match="bio_encoder_type"):
        XLSRBtse(ssl=PX.XLSRConfig.tiny(), bio_encoder_type="lstm", device="meta")


# ------------------------------------------------------------------- tokens

@pytest.mark.parametrize("shape", [(4, 6400), (4, 6500), (2, 3, 4000)],
                         ids=["batch", "ragged-tail", "3d"])
def test_wav2bio_tokens_equal_jax(shape):
    """Exactly the JAX tokens, all three of them present; a frame near a
    threshold is reported and not held (``jax_bio`` pins it)."""
    flat = bio_wav(int(np.prod(shape[:-1])), shape[-1], seed=1)
    wav = flat.reshape(shape)
    got = PBS.wav2bio(torch.from_numpy(wav))
    want = np.asarray(JBS.wav2bio(jnp.asarray(wav)))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert want.shape[-1] == JBS.num_bio_tokens(shape[-1]) == PBS.num_bio_tokens(shape[-1])
    near = near_threshold(wav)
    if near.any():
        print(f"frames near a threshold: {np.argwhere(near).tolist()}")
    np.testing.assert_array_equal(got.numpy()[~near], want[~near])
    assert sorted(np.unique(want).tolist()) == [PBS.SILENCE, PBS.TALKING, PBS.BREATHING]
    assert (PBS.N_BIOS, PBS.SILENCE, PBS.TALKING, PBS.BREATHING) == \
        (JBS.N_BIOS, JBS.SILENCE, JBS.TALKING, JBS.BREATHING)


def test_std_is_the_population_std():
    """One frame of +-1 then 0: the population std is 0.5 (-6.02 dB); the
    sample std would read 0.5008."""
    wav = np.zeros((1, 640), np.float32)
    wav[0, :320] = np.tile([1.0, -1.0], 160) * 0.5 + 0.5
    e, peak = PBS.frame_energy_db(torch.from_numpy(wav))
    np.testing.assert_allclose(float(e[0, 0]), 20 * np.log10(0.5 + 1e-8), rtol=1e-6)
    assert float(peak[0, 0]) == float(e[0, 0])
    assert float(e[0, 1]) == pytest.approx(-160.0)


def test_a_frame_on_a_threshold_is_reported_and_pinned():
    """A frame built at exactly peak - 30 dB (a +-1 square wave at 10^(-30/20)
    of the peak frame's): it is reported near the threshold, its token
    decides the output, and the JAX model given the port's tokens
    (``jax_bio``) reproduces the port's forward."""
    t = 3200
    sq = np.tile([1.0, -1.0], 160).astype(np.float32)
    wav = np.tile(0.1 * sq, (2, t // 320))
    wav[:, 320:640] *= np.float32(10 ** (-30 / 20))
    wav[1, 1280:1600] = 0.0
    near = near_threshold(wav)
    assert near[:, 1].all() and near.sum() == 2, np.argwhere(near)
    bio = jax_bio(wav)
    assert bio is not None
    jm = JB.XLSRBtse(ssl=JX.XLSRConfig.tiny())
    params = _params(seed=2)
    model = load_jax_params(XLSRBtse(ssl=PX.XLSRConfig.tiny(), device="cpu"), params)
    with torch.no_grad():
        got = model.apply(torch.from_numpy(wav))
    want = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(wav), bio=bio)
    _close(got.logits, want.logits, "pinned")
    flipped = np.array(bio)
    flipped[:, 1] = PBS.BREATHING + PBS.TALKING - flipped[:, 1]  # the other side
    other = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(wav),
                     bio=jnp.asarray(flipped))
    assert np.abs(_np(other.logits) - _np(want.logits)).max() > 1e-4


# ------------------------------------------------------- rel-pos transformer

@pytest.mark.parametrize("length", [1, 3, 5, 9, 50])
def test_rel_shuffles_match_jax(rng, length):
    x = rng.normal(size=(2, 3, length, 2 * length - 1)).astype(np.float32)
    got = PRP._rel_to_abs(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JRP._rel_to_abs(jnp.asarray(x))))
    a = rng.normal(size=(2, 3, length, length)).astype(np.float32)
    got = PRP._abs_to_rel(torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JRP._abs_to_rel(jnp.asarray(a))))


@pytest.mark.parametrize("length", [1, 3, 5, 9, 50])
def test_window_embeddings_match_jax(rng, length):
    """Window 4: clipped to the middle rows for L <= 5, zero-padded past."""
    rel = rng.normal(size=(1, 9, 8)).astype(np.float32)
    got = PRP._window_embeddings(torch.from_numpy(rel), length, 4)
    want = np.asarray(JRP._window_embeddings(jnp.asarray(rel), length, 4))
    assert got.shape == (1, 2 * length - 1, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_relpos_encoder_matches_jax(rng, masked):
    params = jax.tree.map(np.asarray, JRP.init_relpos_encoder(jax.random.key(1), 16, 24, 4, 3))
    enc = load_jax_params(PRP.RelPosEncoder(16, 24, 4, 3), params)
    x = rng.normal(size=(3, 11, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(11)[None] < np.array([11, 6, 1])[:, None]).astype(np.float32)
    want = JRP.relpos_encoder(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                              None if mask is None else jnp.asarray(mask))
    got = enc(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    _close(got, want, "encoder")
    if masked:
        assert float(got[1, 6:].abs().max()) == 0.0


@pytest.mark.parametrize("with_lengths", [False, True], ids=["full", "lengths"])
def test_gru_matches_jax_and_torch(rng, with_lengths):
    """The step loop against the JAX scan, and its last hidden against
    torch's ``nn.GRU`` over a packed sequence."""
    params = jax.tree.map(np.asarray, JRNN.init_gru(jax.random.key(3), 6, 5))
    g = load_jax_params(PRNN.GRU(6, 5), params)
    x = rng.normal(size=(3, 7, 6)).astype(np.float32)
    lengths = np.array([7, 4, 1], np.int32) if with_lengths else None
    want_o, want_h = JRNN.gru(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                              lengths=None if lengths is None else jnp.asarray(lengths))
    got_o, got_h = g(torch.from_numpy(x),
                     lengths=None if lengths is None else torch.from_numpy(lengths))
    _close(got_o, want_o, "outputs")
    _close(got_h, want_h, "last hidden")
    ref = torch.nn.GRU(6, 5, batch_first=True)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(torch.from_numpy(params["w_ih"]).T)
        ref.weight_hh_l0.copy_(torch.from_numpy(params["w_hh"]).T)
        ref.bias_ih_l0.copy_(torch.from_numpy(params["b_ih"]))
        ref.bias_hh_l0.copy_(torch.from_numpy(params["b_hh"]))
        seq = torch.from_numpy(x)
        if with_lengths:
            seq = torch.nn.utils.rnn.pack_padded_sequence(
                seq, torch.from_numpy(lengths).long(), batch_first=True, enforce_sorted=False)
        _, h = ref(seq)
    _close(got_h, h[0].numpy(), "torch nn.GRU")


# ----------------------------------------------------------------- forwards

BTSE_CASES = [(k, a) for k in ENCODERS for a in (False, True)]


def _jmodel(kind="transformer", add=False, **ssl_kw):
    return JB.XLSRBtse(ssl=JX.XLSRConfig.tiny(**ssl_kw), bio_encoder_type=kind, is_add=add)


def _params(kind="transformer", add=False, seed=0, **kw):
    """A seeded port model's parameters as a JAX tree of numpy leaves."""
    return to_jax(XLSRBtse(ssl=PX.XLSRConfig.tiny(), bio_encoder_type=kind, is_add=add,
                           device="cpu", seed=seed, **kw))


def _port(params, kind="transformer", add=False, **kw):
    ssl_kw = {k: kw.pop(k) for k in list(kw) if k in ("compute_dtype",)}
    model = XLSRBtse(ssl=PX.XLSRConfig.tiny(**ssl_kw), bio_encoder_type=kind, is_add=add,
                     device="cpu", **kw)
    return load_jax_params(model, params)


@pytest.fixture(scope="module", params=BTSE_CASES,
                ids=[f"{k}-{'add' if a else 'concat'}" for k, a in BTSE_CASES])
def btse(request):
    kind, add = request.param
    return kind, add, _jmodel(kind, add), _params(kind, add)


def _masks(model, key, n, t):
    """The frame MLP's keep-masks the JAX model draws from ``key``: keys
    1-3 of its split into 3 + mlp_layers."""
    keys = jax.random.split(key, 6)
    return [torch.from_numpy(np.array(jax.random.bernoulli(keys[1 + i], 1.0 - rate, shape)))
            for i, (rate, shape) in enumerate(model.dropout_sites(n, t))]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(btse, train):
    """log-probs, logits, the frame features and the fused embedding; in
    train with the JAX model's own dropout draws."""
    kind, add, jm, params = btse
    wav = bio_wav()
    key = jax.random.key(4) if train else None
    want = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(wav), train=train, rng=key,
                    bio=jax_bio(wav))
    model = _port(params, kind, add)
    masks = _masks(model, key, *wav.shape) if train else None
    got = model.apply(torch.from_numpy(wav), train=train, dropout_masks=masks)
    for name in ("log_probs", "logits", "feats", "emb"):
        _close(getattr(got, name), getattr(want, name), name)
    assert got.emb.dtype == torch.float32 and got.emb.shape[1] == (
        64 if add else 128 + 64)


def test_three_d_input_is_squeezed(btse):
    kind, add, jm, params = btse
    model = _port(params, kind, add)
    wav = torch.from_numpy(bio_wav(2, 3200, seed=3))
    with torch.no_grad():
        torch.testing.assert_close(model.apply(wav[:, :, None]).logits,
                                   model.apply(wav).logits, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ENCODERS)
def test_bf16_forward_matches_jax(kind):
    jm = _jmodel(kind, compute_dtype="bfloat16")
    params = _params(kind, seed=5)
    wav = bio_wav(seed=5)
    want = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(wav), bio=jax_bio(wav))
    got = _port(params, kind, compute_dtype="bfloat16").apply(torch.from_numpy(wav))
    for name in ("log_probs", "logits", "emb"):
        _close(getattr(got, name), getattr(want, name), name, rtol=0, atol=2e-3)
    _close(got.feats, want.feats, "feats", rtol=0, atol=6.25e-2)


@pytest.mark.parametrize("kind", ENCODERS)
def test_bio_mask_reads_the_last_valid_step(kind):
    """Given tokens and a ``bio_mask`` of lengths 20, 13, 1 and 0: the JAX
    model's output, and the output of each row's valid tokens alone (the
    GRU's packed last hidden; the last valid step elsewhere)."""
    jm = _jmodel(kind)
    params = _params(kind, seed=6)
    model = _port(params, kind)
    wav = bio_wav(4, 6400, seed=6)  # 20 tokens
    bio = PBS.wav2bio(torch.from_numpy(wav))
    lengths = np.array([20, 13, 1, 0])
    assert bio.shape[1] == 20
    mask = (np.arange(bio.shape[1])[None] < lengths[:, None]).astype(np.float32)
    with torch.no_grad():
        got = model.bio_scoring_vector(bio, torch.from_numpy(mask))
        want = jm.bio_scoring(jax.tree.map(jnp.asarray, params), jnp.asarray(bio.numpy()),
                              jnp.asarray(mask))
        _close(got, want, "bio vector")
        full = model.apply(torch.from_numpy(wav), bio=bio, bio_mask=torch.from_numpy(mask))
        jfull = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(wav),
                         bio=jnp.asarray(bio.numpy()), bio_mask=jnp.asarray(mask))
        _close(full.logits, jfull.logits, "logits")
        if kind in ("gru", "light"):  # no attention across steps: a prefix alone
            alone = model.bio_scoring_vector(bio[1:2, :13])
            _close(got[1], alone[0], "row 1's 13 valid tokens alone")


# ------------------------------------------------------------------- losses

@pytest.mark.parametrize("loss_type", sorted(LOSS_TYPES))
def test_loss_terms_match_jax_without_1_over_n(loss_type):
    """The terms of each ``loss_type`` on one output: the JAX values, and
    L_CE the plain double-softmax CE (no division by N)."""
    rng = np.random.default_rng(loss_type)
    logits = rng.normal(size=(6, 2)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    feats = rng.normal(size=(6, 5, 4)).astype(np.float32)
    emb = rng.normal(size=(6, 7)).astype(np.float32)
    labels = np.array([1, 1, 0, 0, 1, 0], np.int32)
    jm = JB.XLSRBtse(ssl=JX.XLSRConfig.tiny(), loss_type=loss_type)
    want = jm.loss(JOut(log_probs=jnp.asarray(logp), feats=jnp.asarray(feats),
                        emb=jnp.asarray(emb), logits=jnp.asarray(logits)), jnp.asarray(labels))
    model = XLSRBtse(ssl=PX.XLSRConfig.tiny(), loss_type=loss_type, device="meta")
    got = model.loss(POut(log_probs=torch.from_numpy(logp), feats=torch.from_numpy(feats),
                          emb=torch.from_numpy(emb), logits=torch.from_numpy(logits)),
                     torch.from_numpy(labels))
    assert sorted(got) == sorted(want) == sorted(LOSS_TYPES[loss_type])
    for k in want:
        _close(got[k], want[k], k, rtol=RTOL if k == "L_CE" else 1e-4)
    if "L_CE" in got:
        ce = nll_on_log_probs(torch.from_numpy(logp), torch.from_numpy(labels).long())
        assert float(got["L_CE"]) == float(ce)


# ---------------------------------------------------------------- gradients

GRAD_CASES = {"transformer": False, "gru": True}  # conf-5's, and the step loop


@pytest.fixture(scope="module", params=sorted(GRAD_CASES))
def grads(request):
    """Per-term gradients of both sides from one train forward with the JAX
    model's dropout draws (port names), the JAX model pinned to the port's
    ReLU / LeakyReLU signs, and the two sides' own choices."""
    kind = request.param
    add = GRAD_CASES[kind]
    wav = bio_wav(4, 1600, seed=7)
    labels = np.array([1, 1, 0, 0], np.int32)
    jm = _jmodel(kind, add)
    params = _params(kind, add, seed=8)
    key = jax.random.key(9)
    model = _port(params, kind, add)
    params = jax.tree.map(jnp.asarray, params)
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
    bio = jax_bio(wav)

    def terms_of(p):
        return jm.loss(jm.apply(p, jnp.asarray(wav), train=True, rng=key, bio=bio),
                       jnp.asarray(labels))

    with zoo_pins.pin_jax(choices):  # the pins are constants of the traced program
        per_term = jax.jit(jax.jacrev(terms_of))(params)
    jgrads = {t: from_jax(jax.tree.map(np.asarray, per_term[t]), model) for t in TERMS}
    with zoo_pins.jax_choices() as seen:
        terms_of(params)
    return jgrads, pgrads, zoo_pins.disagreements(choices, seen)


@pytest.mark.parametrize("loss_type", sorted(LOSS_TYPES))
def test_gradients_match_jax(grads, loss_type):
    jgrads, pgrads, _ = grads
    terms = LOSS_TYPES[loss_type]
    want = {n: sum(jgrads[t][n] for t in terms) for n in jgrads[terms[0]]}
    got = {n: sum(pgrads[t][n] for t in terms) for n in want}
    zoo_pins.assert_grads_close(got, want, f"loss_type {loss_type}")


def test_the_two_sides_differ_only_at_ties(grads):
    """Where the JAX model's own ReLU / LeakyReLU signs differ from the
    port's, its input was within 1e-4 of the site's largest input of 0."""
    _, _, sites = grads
    assert sites
    for i, (what, count, gap) in enumerate(sites):
        assert gap <= 1e-4, (i, what, count, gap)


def _adam_mu(opt_state):
    found = [s.mu for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
             if hasattr(s, "mu")]
    assert len(found) == 1, len(found)
    return found[0]


def test_engine_step_and_adamw_moment_match_jax():
    """One ``Engine`` step of conf-5's model from the same parameters: the
    metrics, and AdamW's first moment leaf by leaf, the JAX step pinned to
    the port's signs and dropout draws."""
    from scl_deepfake_audio_detection_tpu.train.optim import set_learning_rate as jset_lr

    jm = _jmodel()
    params = _params(seed=10)
    wav = np.stack([bio_wav(4, 1600, seed=11), bio_wav(4, 1600, seed=12)])
    batch = {"wav": wav, "labels": np.tile([1.0, 1.0, 0.0, 0.0], (2, 1)).astype(np.float32)}
    key = jax.random.key(13)
    eng = PE.Engine(_port(params), TrainConfig())
    eng.init_state(params=params)
    set_learning_rate(eng.optimizer, LR)
    with zoo_pins.record_port() as choices:
        got = eng.train_step(eng.place_batch(batch), eng.step_generator(0, 0),
                             dropout_masks=_masks(eng.model, key, 8, 1600))
    assert jax_bio(wav.reshape(8, -1)) is None, "a bio frame near a threshold"
    jeng = JE.Engine(jm, JTrainConfig())
    p, b, o = jeng.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, params))
    with zoo_pins.pin_jax(choices):
        _, _, o, m = jeng.train_step(p, b, jset_lr(o, LR), jeng.place_batch(batch), key)
    for k in m:
        _close(got[k], m[k], k, rtol=RTOL if k in ("L_CE", "accuracy") else 1e-4)
    opt = eng.optimizer
    mu = {n: opt.adamw.state[q]["exp_avg"] for n, q in zip(opt.names, opt.params)}
    want_mu = from_jax(jax.tree.map(np.asarray, _adam_mu(o)), eng.model)
    zoo_pins.assert_grads_close(mu, want_mu, "first moment")


# ------------------------------------------------------- parameter layout

def test_square_tables_keep_their_layout(tmp_path):
    """bio_emb [4, 4] and the conv encoder's pos_emb [4, 4]: the JAX tables
    reach the port's ``Embedding`` untransposed, come back equal through
    ``to_jax``, the optimizer-state layout rule and the artifact's; the
    forward on 4 tokens matches JAX."""
    from scl_deepfake_audio_detection_torch.export import export_scorer, load_scorer

    kw = dict(n_bios=4, bio_dim=4, n_heads=2, max_bio_len=4)
    jm = JB.XLSRBtse(ssl=JX.XLSRConfig.tiny(), bio_encoder_type="conv", **kw)
    params = _params("conv", seed=14, **kw)
    assert params["bio_emb"]["w"].shape == params["bio_encoder"]["pos_emb"]["w"].shape == (4, 4)
    model = _port(params, "conv", **kw)
    np.testing.assert_array_equal(model.bio_emb.weight.detach().numpy(), params["bio_emb"]["w"])
    np.testing.assert_array_equal(model.bio_encoder.pos_emb.weight.detach().numpy(),
                                  params["bio_encoder"]["pos_emb"]["w"])
    back = to_jax(model)
    for (path, a), (_, b) in zip(jax.tree.leaves_with_path(back),
                                 jax.tree.leaves_with_path(params)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    for path, names in jax_leaf_map(model):
        t = model.get_parameter(names[0]).detach()
        assert torch.equal(torch_layout(path, jax_layout(path, t)), t), path
        if path in ("bio_emb//w", "bio_encoder//pos_emb//w"):
            assert jax_layout(path, t) is t, path
    wav = bio_wav(2, 1280, seed=14)
    want = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(wav), bio=jax_bio(wav))
    with torch.no_grad():
        got = model.apply(torch.from_numpy(wav))
    _close(got.log_probs, want.log_probs, "log_probs")
    export_scorer(model, str(tmp_path), cut=1280, compute_dtype=None)
    with np.load(os.path.join(tmp_path, "weights.npz")) as z:
        leaves = [z[f"p{i:05d}"] for i in range(len(jax.tree.leaves(params)))]
    for a, b in zip(leaves, jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(load_scorer(str(tmp_path), device="cpu").score(wav),
                               got.log_probs.numpy(), rtol=0, atol=1e-6)


def test_conv_encoder_refuses_more_tokens_than_its_table():
    model = XLSRBtse(ssl=PX.XLSRConfig.tiny(), bio_encoder_type="conv", max_bio_len=4,
                     device="cpu")
    with pytest.raises(ValueError, match="position table has 4 rows"):
        model.bio_scoring_vector(torch.zeros(1, 5, dtype=torch.int32))


# --------------------------------------------------------------- the cast

def _cast_names(model):
    m = cast_matmul_params(model, torch.bfloat16)
    return {n for n, p in m.named_parameters() if p.dtype == torch.bfloat16}


@pytest.mark.parametrize("name", ["xlsr_linear_nll", "xlsr_aasist", "xlsr_resnet",
                                  "xlsr_btse-transformer", "xlsr_btse-gru", "xlsr_btse-conv",
                                  "xlsr_btse-light"])
def test_cast_casts_the_leaves_jax_keys_w(name):
    """The port's cast picks exactly the parameters of the JAX leaves keyed
    ``w``, embedding tables included, for every model."""
    name, _, kind = name.partition("-")
    kw = {"bio_encoder_type": kind} if kind else {}
    model = MODELS.get(name)(ssl=PX.XLSRConfig.tiny(), device="cpu", **kw)
    want = {n for path, names in jax_leaf_map(model) if path.rsplit("//", 1)[-1] == "w"
            for n in names}
    assert _cast_names(model) == want
    if kind:
        assert "bio_emb.weight" in want


@pytest.mark.parametrize("kind", ENCODERS)
def test_cast_forward_matches_the_jax_cast(kind):
    """Weights cast to bf16 over fp32 compute: the port's forward against
    the JAX package's on its own cast tree, within 1e-5, and the cast
    moves the output by more than that.  The JAX 'gru' raises there (its
    scan carries a bf16 hidden state into fp32 steps): the port's is held
    against the JAX forward on the rounded weights kept in fp32, which is
    the same arithmetic."""
    jm = _jmodel(kind)
    params = _params(kind, seed=15)
    wav = bio_wav(seed=15)
    model = _port(params, kind)
    with torch.no_grad():
        plain = model.apply(torch.from_numpy(wav)).log_probs
        got = cast_matmul_params(model, torch.bfloat16).apply(torch.from_numpy(wav)).log_probs
    cast = jcast(jax.tree.map(jnp.asarray, params), jnp.bfloat16)
    assert cast["bio_emb"]["w"].dtype == jnp.bfloat16
    bio = jax_bio(wav)
    if kind == "gru":
        with pytest.raises(TypeError, match="carry"):
            jm.apply(cast, jnp.asarray(wav), bio=bio)
        cast = jax.tree.map(lambda a: a.astype(jnp.float32), cast)
    want = jm.apply(cast, jnp.asarray(wav), bio=bio).log_probs
    _close(got, want, "cast forward")
    assert float((got - plain).abs().max()) > 1e-5
