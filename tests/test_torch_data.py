"""The port's host data pipeline vs the JAX package, on the CPU.

Each module is a numpy copy of its JAX twin that keeps the order of the
draws, so on the same seed the port's output is bit-equal to JAX's
(``np.array_equal``) with both packages' native LnL switched off
(``native.available`` of each patched to False; no JAX file changes), and
bit-equal again with both on (the same C FIR chain, built from
byte-identical sources with the same flags).  With only the JAX package's
native LnL on, the two agree within atol 1e-5, as ``tests/test_native.py``
holds that chain to numpy.

Covered: the dataset registry, the FIR design, every RawBoost algorithm,
every ``dsp/augment`` function, ``multiview_pad``, every registered
augmentation name and alias online and through the offline cache, the SCL
view batch of all five variants, and ``TrainLoader`` epochs with one and two
shards.
"""

import os

import numpy as np
import pytest

import jax_native_ready
import scl_deepfake_audio_detection_tpu.native as jnative
import scl_deepfake_audio_detection_torch.native as pnative
from scl_deepfake_audio_detection_tpu.data import augment_registry as JR
from scl_deepfake_audio_detection_tpu.data import datasets as JD
from scl_deepfake_audio_detection_tpu.data import loader as JL
from scl_deepfake_audio_detection_tpu.dsp import augment as JA
from scl_deepfake_audio_detection_tpu.dsp import fir as JF
from scl_deepfake_audio_detection_tpu.dsp import pad as JP
from scl_deepfake_audio_detection_tpu.dsp import rawboost as JRB
from scl_deepfake_audio_detection_tpu.utils import config as JC
from scl_deepfake_audio_detection_tpu.utils.registry import AUGMENTATIONS as JAUG
from scl_deepfake_audio_detection_torch.data import augment_registry as R
from scl_deepfake_audio_detection_torch.data import datasets as D
from scl_deepfake_audio_detection_torch.data import loader as L
from scl_deepfake_audio_detection_torch.dsp import augment as A
from scl_deepfake_audio_detection_torch.dsp import fir as F
from scl_deepfake_audio_detection_torch.dsp import pad as P
from scl_deepfake_audio_detection_torch.dsp import rawboost as RB
from scl_deepfake_audio_detection_torch.utils import config as C
from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav
from scl_deepfake_audio_detection_torch.utils.registry import AUGMENTATIONS, DATASETS, MODELS

NATIVE_ATOL = 1e-5  # as tests/test_native.py holds the native LnL to numpy
NOT_PORTED_AUGS = {"telephone_wrapper", "telephone", "codec_wrapper", "codec"}


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(pnative, "available", lambda: False)


@pytest.fixture
def both_native():
    if not jax_native_ready.host():
        pytest.skip("a native host library does not build here")


@pytest.fixture
def jax_native_only(monkeypatch):
    if not jax_native_ready.host():
        pytest.skip("the JAX package's native library does not build here")
    monkeypatch.setattr(pnative, "available", lambda: False)


def _wav(seed, n=3000, scale=0.3):
    return (scale * np.random.default_rng(seed).normal(size=n)).clip(-1, 1).astype(np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), f"max |port - jax| {np.abs(a.astype(float) - b).max()}"


# ------------------------------------------------------------------ registry


def test_dataset_descriptors_equal_the_jax_variants():
    names = sorted(JD._VARIANTS)
    assert sorted(n for n in DATASETS.names()) == names
    for name in names:
        assert DATASETS.get(name) == JD._VARIANTS[name], name
    assert DATASETS.get("asvspoof_2019_xinwang")["repeat_pad"] is False


def test_augmentation_names_and_aliases_equal_jax():
    assert AUGMENTATIONS.names() == JAUG.names()


def test_models_registry_has_linear_nll_and_refuses_the_rest():
    """(The name is from when only LinearNLL resolved.)  LinearNLL, AASIST,
    ResNet and BTSE resolve to the port's classes, under every name of the
    JAX registry; an unknown name is refused with the list."""
    from scl_deepfake_audio_detection_tpu.utils.registry import MODELS as JMODELS
    from scl_deepfake_audio_detection_torch.models.aasist import XLSRAasist
    from scl_deepfake_audio_detection_torch.models.btse import XLSRBtse
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.resnet import XLSRResNet

    assert MODELS.get("xlsr_linear_nll") is LinearNLL
    assert MODELS.get("wav2vec2_linear_nll") is LinearNLL
    assert MODELS.get("xlsr_aasist") is MODELS.get("wav2vec2_aasist") is XLSRAasist
    for name in ("xlsr_resnet", "wav2vec2_resnet", "wav2vec2_resnet_nll", "xlsr_resnet_nll"):
        assert MODELS.get(name) is XLSRResNet, name
    for name in ("xlsr_btse", "wav2vec2_btse"):
        assert MODELS.get(name) is XLSRBtse, name
    assert set(JMODELS.names()) <= set(MODELS.names())
    with pytest.raises(KeyError, match="unknown model"):
        MODELS.get("no_such_model")


def test_rawboost_config_and_yaml_section_match_jax(tmp_path):
    assert C.RawBoostConfig() == C.RawBoostConfig(**vars(JC.RawBoostConfig()))
    p = tmp_path / "c.yaml"
    p.write_text("model: {name: wav2vec2_linear_nll}\n"
                 "data: {name: asvspoof_2019_augall_3}\n"
                 "rawboost: {algo: 3, SNRmin: 5}\n")
    assert vars(C.load_config(str(p)).rawboost) == vars(JC.load_config(str(p)).rawboost)
    p.write_text("rawboost: {algoo: 3}\n")
    for load in (C.load_config, JC.load_config):
        with pytest.raises(ValueError, match="unknown rawboost"):
            load(str(p))


# ----------------------------------------------------------------------- DSP


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_notch_chain_and_fir_match_jax(seed):
    args = (5, 20, 8000, 100, 1000, 10, 100, -5.0, -20.0, 16000)
    b, jb = F.design_notch_chain(_rng(seed), *args), JF.design_notch_chain(_rng(seed), *args)
    _same(b, jb)
    x = _wav(seed)
    _same(F.filter_fir_centered(x, b), JF.filter_fir_centered(x, jb))
    _same(F.firwin_bandstop(31, 300.0, 900.0, 16000), JF.firwin_bandstop(31, 300.0, 900.0, 16000))


@pytest.mark.parametrize("algo", range(1, 10))
def test_rawboost_matches_jax_bit_for_bit(no_native, algo):
    cfg, jcfg = C.RawBoostConfig(), JC.RawBoostConfig()
    x = _wav(algo)
    _same(RB.process_rawboost(x, 16000, cfg, _rng(algo), algo=algo),
          JRB.process_rawboost(x, 16000, jcfg, _rng(algo), algo=algo))


@pytest.mark.parametrize("algo", [1, 4, 5, 6, 8])
def test_rawboost_matches_jax_native_lnl(jax_native_only, algo):
    x = _wav(algo)
    np.testing.assert_allclose(
        RB.process_rawboost(x, 16000, C.RawBoostConfig(), _rng(algo), algo=algo),
        JRB.process_rawboost(x, 16000, JC.RawBoostConfig(), _rng(algo), algo=algo),
        atol=NATIVE_ATOL, rtol=0)


@pytest.mark.parametrize("algo", [1, 4, 5, 6, 8])
def test_rawboost_with_both_native_lnl_is_bit_equal(both_native, algo):
    x = _wav(algo)
    _same(RB.process_rawboost(x, 16000, C.RawBoostConfig(), _rng(algo), algo=algo),
          JRB.process_rawboost(x, 16000, JC.RawBoostConfig(), _rng(algo), algo=algo))


AUGMENTORS = {
    "background_noise": lambda M, x, r: M.background_noise(x, _wav(9, 2000, 0.1), r),
    "reverb": lambda M, x, r: M.reverb(x, np.exp(-np.arange(400) / 60.0).astype(np.float32)),
    "volume": lambda M, x, r: M.volume(x, r),
    "gaussian_noise": lambda M, x, r: M.gaussian_noise(x, r),
    "time_stretch": lambda M, x, r: M.time_stretch(x, 1.07),
    "speed": lambda M, x, r: M.speed(x, r),
    "pitch_shift": lambda M, x, r: M.pitch_shift(x, r, min_semitones=1),
    "time_mask": lambda M, x, r: M.time_mask(x, r),
    "freq_mask": lambda M, x, r: M.freq_mask(x, r),
    "frame_signal": lambda M, x, r: M.frame_signal(x, 400, 160),
}


@pytest.mark.parametrize("name", sorted(AUGMENTORS))
def test_augment_functions_match_jax(name):
    x = _wav(4, 5000)
    _same(AUGMENTORS[name](A, x, _rng(5)), AUGMENTORS[name](JA, x, _rng(5)))


@pytest.mark.parametrize("repeat_pad", [True, False])
@pytest.mark.parametrize("base", [700, 1000, 1600])
def test_multiview_pad_matches_jax(repeat_pad, base):
    views = [_wav(i, n) for i, n in enumerate([base, 900, 1300, 500])]
    _same(P.multiview_pad(views, 1000, repeat_pad=repeat_pad, rng=_rng(3)),
          JP.multiview_pad(views, 1000, repeat_pad=repeat_pad, rng=_rng(3)))


# ------------------------------------------------------- registered augments


def _resources(mod_res, cfg_cls, tmp, online, sub):
    noise, rir = tmp / "musan", tmp / "rirs"
    if not noise.exists():
        save_wav(str(noise / "a" / "n1.wav"), _wav(11, 4000, 0.1))
        save_wav(str(noise / "n2.wav"), _wav(12, 2500, 0.1))
        save_wav(str(rir / "r1.wav"), np.exp(-np.arange(300) / 40.0).astype(np.float32) * 0.9)
        save_wav(str(rir / "r2.wav"), np.exp(-np.arange(500) / 90.0).astype(np.float32) * 0.9)
    return mod_res(rawboost=cfg_cls(), noise_path=str(noise), rir_path=str(rir),
                   aug_dir=str(tmp / sub), online=online)


@pytest.mark.parametrize("name", sorted(set(JAUG.names()) - NOT_PORTED_AUGS))
def test_every_registered_augmentation_matches_jax(no_native, tmp_path, name):
    x = _wav(21, 4000)
    fn, jfn = AUGMENTATIONS.get(name), JAUG.get(name)
    on = _resources(R.AugmentResources, C.RawBoostConfig, tmp_path, True, "on")
    jon = _resources(JR.AugmentResources, JC.RawBoostConfig, tmp_path, True, "on")
    _same(np.asarray(fn(x, _rng(1), on, utt_id="bonafide/u1.wav")),
          np.asarray(jfn(x, _rng(1), jon, utt_id="bonafide/u1.wav")))
    # offline: a miss writes the cache and reads it back; a hit (other
    # draws) reads back what the miss wrote.  The masks are never cached.
    off = _resources(R.AugmentResources, C.RawBoostConfig, tmp_path, False, "port_cache")
    joff = _resources(JR.AugmentResources, JC.RawBoostConfig, tmp_path, False, "jax_cache")
    miss = fn(x, _rng(2), off, utt_id="bonafide/u1.wav")
    _same(miss, jfn(x, _rng(2), joff, utt_id="bonafide/u1.wav"))
    assert getattr(fn, "cache_method", None) == getattr(jfn, "cache_method", None)
    if getattr(fn, "cache_method", None):
        assert os.path.exists(tmp_path / "port_cache" / fn.cache_method / "u1.wav")
        _same(fn(x, _rng(99), off, utt_id="bonafide/u1.wav"), miss)
        with pytest.raises(ValueError, match="collision"):
            fn(x, _rng(2), off, utt_id="spoof/u1.wav")


@pytest.mark.parametrize("name", sorted(NOT_PORTED_AUGS))
def test_codec_augmentations_are_not_ported_yet(name):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        AUGMENTATIONS.get(name)(_wav(0), _rng(0), R.AugmentResources())


# -------------------------------------------------------------- view batches

VARIANT_KW = {
    "augall_3": dict(vocoders=["hifigan", "waveglow"], num_additional_real=1,
                     augmentation_methods=["RawBoost12", "background_noise_wrapper",
                                           "reverb_wrapper"]),
    "aug_2": dict(vocoders=["hifigan"], num_additional_real=2,
                  augmentation_methods=["RawBoost12", "reverb", "volume"]),
    "augall_5": dict(vocoders=["hifigan"], num_additional_real=1, num_additional_spoof=2,
                     augmentation_methods=["RawBoost12", "background_noise"]),
    "scl_normal": dict(num_additional_real=1, num_additional_spoof=2,
                       augmentation_methods=["RawBoost12", "gaussian"]),
    "xinwang": dict(vocoders=["hifigan", "waveglow"],
                    augmentation_methods=["RawBoost12", "reverb"], repeat_pad=False),
}
UTTS = [f"u{i}.wav" for i in range(5)]


def _scl_db(root):
    rng = np.random.default_rng(7)
    for i, u in enumerate(UTTS):
        n = int(rng.integers(1200, 4000))  # both sides of trim 2400
        save_wav(str(root / "bonafide" / u), _wav(100 + i, n))
        for v in ("hifigan", "waveglow"):
            save_wav(str(root / "vocoded" / f"{v}_{u}"), _wav(200 + i, n))
    for i in range(3):
        save_wav(str(root / "spoof" / f"s{i}.wav"), _wav(300 + i, 3000))
        save_wav(str(root / "spoof_train" / f"t{i}.wav"), _wav(400 + i, 2000))
    return root


@pytest.fixture(scope="module")
def scl_db(tmp_path_factory):
    return _scl_db(tmp_path_factory.mktemp("scl_db"))


def _builders(db, variant, res_dir, seed=11):
    kw = dict(VARIANT_KW[variant])
    repeat = kw.pop("repeat_pad", True)
    spec = D.SCLBatchSpec(variant=variant, trim_length=2400, repeat_pad=repeat, **kw)
    jspec = JD.SCLBatchSpec(variant=variant, trim_length=2400, repeat_pad=repeat, **kw)
    res = _resources(R.AugmentResources, C.RawBoostConfig, res_dir, True, "aug")
    jres = _resources(JR.AugmentResources, JC.RawBoostConfig, res_dir, True, "aug")
    return (D.SCLViewBatchBuilder(spec, str(db), UTTS, res, seed=seed),
            JD.SCLViewBatchBuilder(jspec, str(db), UTTS, jres, seed=seed))


@pytest.mark.parametrize("variant", sorted(VARIANT_KW))
def test_view_batch_matches_jax_for_every_variant(no_native, scl_db, tmp_path, variant):
    b, jb = _builders(scl_db, variant, tmp_path)
    assert b.spec.num_views == jb.spec.num_views
    for idx, epoch in ((0, 0), (3, 2)):
        utt, wav, labels = b.build(idx, epoch)
        jutt, jwav, jlabels = jb.build(idx, epoch)
        assert utt == jutt and wav.shape == (b.spec.num_views, 2400)
        _same(wav, jwav)
        _same(labels, jlabels)


def test_view_batch_native_lnl_within_tolerance(jax_native_only, scl_db, tmp_path):
    b, jb = _builders(scl_db, "augall_3", tmp_path)
    (_, wav, labels), (_, jwav, jlabels) = b.build(1, 0), jb.build(1, 0)
    np.testing.assert_allclose(wav, jwav, atol=NATIVE_ATOL * 32768, rtol=1e-5)
    _same(labels, jlabels)


def test_view_batch_with_both_native_lnl_is_bit_equal(both_native, scl_db, tmp_path):
    b, jb = _builders(scl_db, "augall_3", tmp_path)
    (_, wav, labels), (_, jwav, jlabels) = b.build(1, 0), jb.build(1, 0)
    _same(wav, jwav)
    _same(labels, jlabels)


def test_spec_and_resources_from_config_match_jax():
    kw = {"vocoders": ["hifigan"], "augmentation_methods": ["RawBoost12"],
          "trim_length": 32000, "noise_path": "/n", "rir_path": "/r", "aug_dir": "/a",
          "online_aug": False, "other": 1}
    for name in JD._VARIANTS:
        spec, jspec = D.spec_from_config(name, kw), JD.spec_from_config(name, kw)
        assert (spec is None) == (jspec is None)
        if spec is not None:
            assert vars(spec) == vars(jspec)
    res, jres = D.resources_from_config(kw), JD.resources_from_config(kw)
    assert ({k: v for k, v in vars(res).items() if k != "rawboost"}
            == {k: v for k, v in vars(jres).items() if k != "rawboost"})


# ------------------------------------------------------------------- loaders


@pytest.mark.parametrize("num_shards", [1, 2])
def test_train_loader_epoch_matches_jax(no_native, scl_db, tmp_path, num_shards):
    b, jb = _builders(scl_db, "augall_3", tmp_path)
    for shard in range(num_shards):
        kw = dict(groups_per_step=2, num_workers=2, seed=5, shard_index=shard,
                  num_shards=num_shards, drop_last=num_shards == 1)
        loader, jloader = L.TrainLoader(b, **kw), JL.TrainLoader(jb, **kw)
        assert len(loader) == len(jloader)
        for epoch in (0, 1):
            got, want = list(loader.epoch(epoch)), list(jloader.epoch(epoch))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g["utts"] == w["utts"]
                _same(g["wav"], w["wav"])
                _same(g["labels"], w["labels"])


def test_train_loader_surfaces_worker_errors(scl_db, tmp_path):
    b, _ = _builders(scl_db, "augall_3", tmp_path)
    b.files = UTTS[:3] + ["missing.wav"]
    with pytest.raises(FileNotFoundError):
        list(L.TrainLoader(b, groups_per_step=2, shuffle=False, num_workers=2).epoch(0))


def test_train_loader_stops_its_producer_when_the_consumer_leaves(scl_db, tmp_path):
    import threading

    b, _ = _builders(scl_db, "augall_3", tmp_path)
    before = threading.active_count()
    it = L.TrainLoader(b, groups_per_step=1, shuffle=False, num_workers=1,
                       prefetch=1).epoch(0)
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before
