"""The port's codec simulation (``dsp/codec``) and the two codec training
augmentations (``telephone_wrapper``, ``codec_wrapper``) against the JAX
package's, on the CPU.

- G.711 A-law and mu-law codes and round trips bit-equal over every int16
  value and over random waveforms; the continuous companders;
- ``bandpass_fir`` and ``telephone_effect`` within 1e-6 (float32 numpy
  products; the same code on both sides, so equal in practice);
- ``random_codec``'s draws: the codec and bitrate it picks over 64 seeds,
  and the G.711 law of its fallback, identical;
- the lossy round trips (mp3 and opus through ``codec_roundtrip``, G.722
  through ``g722_roundtrip`` and ``telephone_effect``) bit-equal where both
  packages' native codec libraries load (byte-identical sources built with
  the same flags; ``tests/jax_native_ready.codec``), skipped otherwise;
- both wrappers through the offline cache: a miss writes the JAX wrapper's
  audio, a hit reads it back whatever the draws, a second source with the
  same basename is refused."""

import os

import numpy as np
import pytest

import scl_deepfake_audio_detection_tpu.native as jnative
from scl_deepfake_audio_detection_tpu.data import augment_registry as JR
from scl_deepfake_audio_detection_tpu.dsp import codec as JC
from scl_deepfake_audio_detection_tpu.utils.registry import AUGMENTATIONS as JAUG
from scl_deepfake_audio_detection_torch import native as pnative
from scl_deepfake_audio_detection_torch.data import augment_registry as R
from scl_deepfake_audio_detection_torch.dsp import codec as PC
from scl_deepfake_audio_detection_torch.utils.registry import AUGMENTATIONS

import jax_native_ready

SR = 16000


def _wav(seed, n=4000, scale=0.3):
    return (scale * np.random.default_rng(seed).normal(size=n)).clip(-1, 1).astype(np.float32)


def _tone(seed, n=8000):
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    return (0.5 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=n)).astype(np.float32)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), f"max |port - jax| {np.abs(a.astype(float) - b).max()}"


def _need_codec():
    if not jax_native_ready.codec():
        pytest.skip("native codec library unavailable")


# ------------------------------------------------------------------ G.711

def _all_int16_as_float():
    return (np.arange(-32768, 32768, dtype=np.int32) / 32768.0).astype(np.float32)


@pytest.mark.parametrize("law", ["alaw", "ulaw"])
def test_g711_codes_and_round_trips_are_bit_equal(law):
    enc, dec = f"{law}_encode", f"{law}_decode"
    for x in (_all_int16_as_float(), _wav(1, 5000, 0.9), np.array([-1.5, 1.5], np.float32)):
        codes = getattr(PC, enc)(x)
        _same(codes, getattr(JC, enc)(x))
        _same(getattr(PC, dec)(codes), getattr(JC, dec)(codes))
    every_code = np.arange(256, dtype=np.uint8)
    _same(getattr(PC, dec)(every_code), getattr(JC, dec)(every_code))
    for alias in {"alaw": ("alaw", "a-law", "A"), "ulaw": ("ulaw", "u-law", "mu", "MULAW", "u")}[law]:
        _same(PC.g711_roundtrip(_wav(2), alias), JC.g711_roundtrip(_wav(2), alias))


def test_unknown_companding_law_raises_as_jax():
    with pytest.raises(ValueError) as want:
        JC.g711_roundtrip(_wav(0), "gsm")
    with pytest.raises(ValueError) as got:
        PC.g711_roundtrip(_wav(0), "gsm")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("channels", [256, 1024])
@pytest.mark.parametrize("to_int", [True, False], ids=["int", "float"])
def test_companders_match_jax(channels, to_int):
    x = np.linspace(-0.999, 0.999, 4001)
    for comp, exp in (("mulaw_compand", "mulaw_expand"), ("alaw_compand", "alaw_expand")):
        y = getattr(PC, comp)(x, channels, to_int)
        _same(y, getattr(JC, comp)(x, channels, to_int))
        np.testing.assert_allclose(getattr(PC, exp)(y, channels, to_int),
                                   getattr(JC, exp)(y, channels, to_int), rtol=0, atol=1e-6)


# ---------------------------------------------------------- telephone band

@pytest.mark.parametrize("low,high,numtaps", [(300.0, 3400.0, 101), (500.0, 2500.0, 63)])
def test_bandpass_fir_matches_jax(low, high, numtaps):
    x = _tone(3)
    np.testing.assert_allclose(PC.bandpass_fir(x, SR, low, high, numtaps),
                               JC.bandpass_fir(x, SR, low, high, numtaps), rtol=0, atol=1e-6)


@pytest.mark.parametrize("encoding", ["alaw", "ulaw"])
def test_telephone_effect_matches_jax(encoding):
    x = _tone(4)
    np.testing.assert_allclose(PC.telephone_effect(x, SR, encoding),
                               JC.telephone_effect(x, SR, encoding), rtol=0, atol=1e-6)


def test_telephone_g722_matches_jax():
    """G.722 through the native library where it loads; both fall back to
    mu-law where it does not."""
    x = _tone(5)
    if jax_native_ready.codec() and pnative.encoder_available("g722"):
        _same(PC.g722_roundtrip(x, SR), JC.g722_roundtrip(x, SR))
    np.testing.assert_allclose(PC.telephone_effect(x, SR, "g722"),
                               JC.telephone_effect(x, SR, "g722"), rtol=0, atol=1e-6)


# ---------------------------------------------------------- lossy codecs

def test_random_codec_draws_the_jax_codec_and_bitrate(monkeypatch):
    """Over 64 seeds, the codec and bitrate each package asks for, and with
    no backend the G.711 law each falls back to."""
    picks = {"port": [], "jax": []}
    for side, mod in (("port", PC), ("jax", JC)):
        monkeypatch.setattr(mod, "codec_roundtrip",
                            lambda x, sr, codec, bitrate, _s=side: picks[_s].append(
                                (codec, bitrate)) or x)
    for seed in range(64):
        PC.random_codec(_wav(0, 100), np.random.default_rng(seed))
        JC.random_codec(_wav(0, 100), np.random.default_rng(seed))
    assert picks["port"] == picks["jax"]
    assert {c for c, _ in picks["port"]} == {"mp3", "opus"}

    def unavailable(*a, **k):
        raise PC.CodecUnavailable("no backend")

    def jax_unavailable(*a, **k):
        raise JC.CodecUnavailable("no backend")

    monkeypatch.setattr(PC, "codec_roundtrip", unavailable)
    monkeypatch.setattr(JC, "codec_roundtrip", jax_unavailable)
    for seed in range(64):
        rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        _same(PC.random_codec(_wav(seed), rp), JC.random_codec(_wav(seed), rj))
        assert rp.integers(1 << 30) == rj.integers(1 << 30)  # as many draws taken


@pytest.mark.parametrize("codec,bitrate", [("mp3", "16k"), ("mp3", "128k"), ("opus", "6k"),
                                           ("opus", "48k")])
def test_codec_roundtrip_is_bit_equal(codec, bitrate):
    _need_codec()
    if not pnative.encoder_available(codec):
        pytest.skip(f"no {codec} encoder in the ffmpeg libraries")
    x = _tone(6)
    got = PC.codec_roundtrip(x, SR, codec, bitrate)
    _same(got, JC.codec_roundtrip(x, SR, codec, bitrate))
    assert got.shape == x.shape and np.isfinite(got).all()


def test_no_backend_raises_as_jax(monkeypatch):
    for mod, nat in ((PC, pnative), (JC, jnative)):
        monkeypatch.setattr(nat, "codec_available", lambda: False)
        monkeypatch.setattr(mod, "ffmpeg_available", lambda: False)
    with pytest.raises(JC.CodecUnavailable) as want:
        JC.codec_roundtrip(_wav(0), SR, "mp3")
    with pytest.raises(PC.CodecUnavailable) as got:
        PC.codec_roundtrip(_wav(0), SR, "mp3")
    assert str(got.value) == str(want.value)
    with pytest.raises(PC.CodecUnavailable):
        PC.g722_roundtrip(_wav(0), SR)


# -------------------------------------------------------------- wrappers

@pytest.mark.parametrize("name", ["telephone_wrapper", "codec_wrapper"])
def test_wrappers_through_the_offline_cache(tmp_path, name):
    if name == "codec_wrapper":
        jax_native_ready.codec()  # both libraries loaded, or neither
    fn, jfn = AUGMENTATIONS.get(name), JAUG.get(name)
    assert fn.cache_method == jfn.cache_method == name.replace("_wrapper", "")
    x = _wav(7)
    _same(fn(x, np.random.default_rng(1), R.AugmentResources(), utt_id="bonafide/u1.wav"),
          jfn(x, np.random.default_rng(1), JR.AugmentResources(), utt_id="bonafide/u1.wav"))
    off = R.AugmentResources(aug_dir=str(tmp_path / "port"), online=False)
    joff = JR.AugmentResources(aug_dir=str(tmp_path / "jax"), online=False)
    miss = fn(x, np.random.default_rng(2), off, utt_id="bonafide/u1.wav")
    _same(miss, jfn(x, np.random.default_rng(2), joff, utt_id="bonafide/u1.wav"))
    assert os.path.exists(tmp_path / "port" / fn.cache_method / "u1.wav")
    _same(fn(x, np.random.default_rng(99), off, utt_id="bonafide/u1.wav"), miss)
    with pytest.raises(ValueError, match="collision"):
        fn(x, np.random.default_rng(2), off, utt_id="spoof/u1.wav")
