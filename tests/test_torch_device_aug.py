"""The port's on-device view composer (``--device_aug``) vs the JAX package,
on the CPU.

The two packages draw different random streams, so every random step of
the port takes its draws as tensors: here the JAX package's own draws are
made with ``jax.random``, splitting the keys as ``dsp/rawboost_jax`` and
``data/device_pipeline`` do, and handed to the port's pure functions.

Tolerances: signal-scale outputs within atol 1e-5 (two FFT libraries in
fp32); int16-amplitude outputs (the 'reference' noise and reverb views,
``trunc(x * 32768)``) within 4 LSB, as the JAX package's own host-parity
tests allow 2 (``tests/test_device_pipeline.py``).  The reverb inputs have
a dominant direct path, so the peak sample that wraps to -32768 is the
same on both sides.  Host-side pieces (chain design and packing, the
chain pool, ``build_banks``, ``build_raw``, ``DeviceAugTrainLoader``
epochs) are bit-equal.  The port's own draws are held to their
distributions, and ``--device_aug`` drives the CLI on a mini database.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scl_deepfake_audio_detection_tpu.data import datasets as JD
from scl_deepfake_audio_detection_tpu.data import device_pipeline as JDP
from scl_deepfake_audio_detection_tpu.data import loader as JL
from scl_deepfake_audio_detection_tpu.dsp import fir as JF
from scl_deepfake_audio_detection_tpu.dsp import rawboost_jax as JRB
from scl_deepfake_audio_detection_tpu.utils.config import RawBoostConfig as JRawBoostConfig
from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.cli.train import composer_seed
from scl_deepfake_audio_detection_torch.data import datasets as D
from scl_deepfake_audio_detection_torch.data import device_pipeline as DP
from scl_deepfake_audio_detection_torch.data import loader as L
from scl_deepfake_audio_detection_torch.data.augment_registry import AugmentResources
from scl_deepfake_audio_detection_torch.dsp import rawboost_batched as RBB
from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav
from scl_deepfake_audio_detection_torch.utils.config import RawBoostConfig

# torch's first multi-threaded exp in a process can come out ~1e-4 off in
# one thread's chunk (ROADMAP.md, faults); the pow of the SNR gains is exp
torch.exp(torch.linspace(-5.0, 5.0, 1 << 20))

SIGNAL_ATOL = 1e-5
INT16_ATOL = 4.0
CFG, JCFG = RawBoostConfig(), JRawBoostConfig()
VARIANTS = ("augall_3", "augall_5", "aug_2", "scl_normal", "xinwang")
MODES = ("reference", "rms")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what=""):
    """Row by row: int16-amplitude rows (peak > 2) within INT16_ATOL, the
    rest within SIGNAL_ATOL."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    rows_g, rows_w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    for i, (g, w) in enumerate(zip(rows_g, rows_w)):
        atol = INT16_ATOL if np.abs(w).max() > 2.0 else SIGNAL_ATOL
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{what} row {i}")


def _signal(rng, *shape):
    return (0.2 * rng.normal(size=shape)).astype(np.float32)


def _banks(rng, n_noise=3, t_noise=9000, n_rir=2, t_rir=400):
    noise = (0.05 * rng.normal(size=(n_noise, t_noise))).astype(np.float32)
    decay = np.exp(-np.arange(t_rir) / 60.0)
    rir = (0.2 * decay * rng.normal(size=(n_rir, t_rir))).astype(np.float32)
    rir[:, 0] = 1.0  # a dominant direct path: the peak index is unambiguous
    return noise, rir


def _chains(rng, rows, nb=1024):
    return np.stack([RBB.pack_chains(RBB.design_lnl_chains(CFG, 16000, rng), nb)
                     for _ in range(rows)]).astype(np.float32)


# ----------------------------------------------------------- JAX's draws

def _jax_isd(key, r, t):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return RBB.IsdDraws(beta=_t(jax.random.uniform(k1, (r, 1)) * JCFG.P / 100.0),
                        u_mask=_t(jax.random.uniform(k2, (r, t))),
                        f1=_t(jax.random.uniform(k3, (r, t))),
                        f2=_t(jax.random.uniform(k4, (r, t))))


def _jax_rows(key, bank_shape, rows, length):
    k1, k2 = jax.random.split(key)
    idx = jax.random.randint(k1, (rows,), 0, bank_shape[0])
    starts = jax.random.randint(k2, (rows,), 0, max(bank_shape[1] - length + 1, 1))
    return _t(idx).long(), _t(starts).long()


def _jax_aug(key, r, t, noise, rir, mode):
    """The draws of JDP._device_augment_all(key)."""
    k_rb, k_noise, k_snr, k_rir = jax.random.split(key, 4)
    n_idx, n_start = _jax_rows(k_noise, noise.shape, r, t)
    r_idx, _ = _jax_rows(k_rir, rir.shape, r, rir.shape[1])
    if mode == "reference":
        snr = jax.random.randint(k_snr, (r, 1), 5, 16).astype(jnp.float32)
    else:
        snr = jax.random.uniform(k_snr, (r, 1), minval=5.0, maxval=15.0)
    return DP.AugDraws(_jax_isd(k_rb, r, t), n_idx, n_start, _t(snr), r_idx)


def _jax_random(key, r, t, noise, rir, mode):
    """The draws of JDP._device_augment_random(key)."""
    d = _jax_aug(jax.random.fold_in(key, 0), r, t, noise, rir, mode)
    d.choice = _t(jax.random.randint(jax.random.fold_in(key, 1), (r, 1), 0, 3)).long()
    return d


def _jax_view_draws(key, variant, g, n_real, n_voc, n_spoof, t, noise, rir, mode):
    """The draws of JDP.compose_views(key) by role."""
    k_a, k_v, k_r, k_s = jax.random.split(key, 4)
    out = {"anchor": _jax_aug(k_a, g, t, noise, rir, mode)}
    if variant in ("augall_3", "augall_5"):
        out["vocoded"] = _jax_isd(k_v, g * n_voc, t)
    elif variant == "aug_2":
        out["reals"] = _jax_random(k_r, g * n_real, t, noise, rir, mode)
        out["vocoded"] = _jax_random(k_v, g * n_voc, t, noise, rir, mode)
    elif variant == "scl_normal":
        out["reals"] = _jax_random(k_r, g * n_real, t, noise, rir, mode)
        out["spoofs"] = _jax_random(k_s, g * n_spoof, t, noise, rir, mode)
    else:
        out["vocoded"] = _jax_aug(k_v, g * n_voc, t, noise, rir, mode)
    return out


# ------------------------------------------------------ rawboost_batched

def test_chain_design_and_packing_equal_jax():
    chains = RBB.design_lnl_chains(CFG, 16000, np.random.default_rng(4))
    jchains = JRB.design_lnl_chains(JCFG, 16000, np.random.default_rng(4))
    assert len(chains) == len(jchains) == CFG.N_f
    for a, b in zip(chains, jchains):
        assert np.array_equal(a, b)
    assert np.array_equal(RBB.pack_chains(chains, 1024), JRB.pack_chains(jchains, 1024))
    with pytest.raises(ValueError):
        RBB.pack_chains([np.ones(9)], 8)


@pytest.mark.parametrize("nb", [64, 65])
def test_fft_fir_matches_jax_and_the_direct_fir(nb):
    rng = np.random.default_rng(nb)
    x = _signal(rng, 3, 1000)
    taps = [rng.normal(size=m) for m in (nb, nb - 7, 11)]
    b = RBB.pack_chains(taps, nb).astype(np.float32)
    got = RBB.fft_fir_centered(_t(x), _t(b)).numpy()
    want = np.asarray(JRB.fft_fir_centered(jnp.asarray(x), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=SIGNAL_ATOL)
    for i, tap in enumerate(taps):
        np.testing.assert_allclose(got[i], JF.filter_fir_centered(x[i], tap), rtol=0,
                                   atol=SIGNAL_ATOL)


def test_lnl_isd_ssi_match_jax_given_its_draws():
    rng = np.random.default_rng(0)
    r, t = 4, 3000
    x = _signal(rng, r, t)
    chains = _chains(rng, r)
    got = RBB.lnl_convolutive_noise(_t(x), _t(chains)).numpy()
    want = np.asarray(JRB.lnl_convolutive_noise(jnp.asarray(x), jnp.asarray(chains)))
    _close(got, want, "lnl")

    key = jax.random.key(3)
    d = _jax_isd(key, r, t)
    _close(RBB.isd_given(_t(x), d.beta, d.u_mask, d.f1, d.f2, CFG.g_sd).numpy(),
           JRB.isd_additive_noise(jnp.asarray(x), key, JCFG.P, JCFG.g_sd), "isd")

    ssi_chains = chains[:, 0]
    k1, k2 = jax.random.split(key)
    noise = _t(jax.random.normal(k1, (r, t)))
    snr = _t(jax.random.uniform(k2, (r, 1), minval=JCFG.SNRmin, maxval=JCFG.SNRmax))
    _close(RBB.ssi_given(_t(x), noise, _t(ssi_chains), snr).numpy(),
           JRB.ssi_additive_noise(jnp.asarray(x), key, jnp.asarray(ssi_chains),
                                  JCFG.SNRmin, JCFG.SNRmax), "ssi")


@pytest.mark.parametrize("algo", [0, 1, 2, 3, 4, 5, 6, 7, 8])
def test_rawboost_batch_matches_jax_for_every_algorithm(algo):
    rng = np.random.default_rng(10 + algo)
    r, t = 3, 2000
    x = _signal(rng, r, t)
    lnl, ssi = _chains(rng, r), _chains(rng, r)[:, 0]
    key = jax.random.key(algo)
    k_isd, k_ssi = jax.random.split(key)
    k1, k2 = jax.random.split(k_ssi)
    ssi_d = RBB.SsiDraws(noise=_t(jax.random.normal(k1, (r, t))),
                         snr=_t(jax.random.uniform(k2, (r, 1), minval=JCFG.SNRmin,
                                                   maxval=JCFG.SNRmax)))
    got = RBB.rawboost_batch_given(_t(x), _t(lnl), _t(ssi), CFG, _jax_isd(k_isd, r, t),
                                   ssi_d, algo=algo)
    want = JRB.rawboost_batch(jnp.asarray(x), key, jnp.asarray(lnl), jnp.asarray(ssi),
                              JCFG, algo=algo)
    _close(got.numpy(), want, f"algo {algo}")


def test_port_draws_follow_the_distributions():
    gen = torch.Generator().manual_seed(0)
    d = RBB.draw_isd(64, 4000, CFG.P, gen, "cpu")
    assert 0.0 <= d.beta.min() and d.beta.max() < CFG.P / 100.0
    density = (d.u_mask < d.beta).float().mean().item()
    assert abs(density - CFG.P / 200.0) < 0.01, density  # E[beta] = P/2 %
    s = RBB.draw_ssi(2000, 8, CFG.SNRmin, CFG.SNRmax, gen, "cpu")
    assert CFG.SNRmin <= s.snr.min() and s.snr.max() < CFG.SNRmax
    assert abs(s.noise.std().item() - 1.0) < 0.05

    noise, rir = (torch.zeros(5, 900), torch.zeros(3, 50))
    ref = DP.draw_augment(3000, 100, noise, rir, CFG, "reference", gen, choice=True)
    vals = ref.snr.unique()
    assert torch.equal(vals, torch.arange(5.0, 16.0)) and torch.equal(ref.snr, ref.snr.round())
    rms = DP.draw_augment(3000, 100, noise, rir, CFG, "rms", gen)
    assert 5.0 <= rms.snr.min() and rms.snr.max() < 15.0 and rms.snr.unique().numel() > 2900
    assert ref.noise_idx.max() == 4 and ref.noise_start.max() == 800 and ref.rir_idx.max() == 2
    assert set(ref.choice.unique().tolist()) == {0, 1, 2} and rms.choice is None


def test_make_batch_augmenter_uses_the_jax_chains_and_draws_anew():
    x = _signal(np.random.default_rng(1), 2, 2000)
    fn = RBB.make_batch_augmenter(CFG, 16000, batch=2, seed=3, device="cpu")
    a = fn(x, torch.Generator().manual_seed(1))
    b = fn(x, torch.Generator().manual_seed(1))
    assert a.shape == (2, 2000) and torch.isfinite(a).all()
    assert not torch.equal(a, b)  # new chains for every call, from one host rng
    if not torch.cuda.is_available():  # the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RBB.make_batch_augmenter(CFG, 16000, batch=2)


# ------------------------------------------------------- device_pipeline

def test_noise_mixing_and_reverb_match_jax():
    rng = np.random.default_rng(2)
    x = _signal(rng, 3, 4000)
    noise, rir = _banks(rng, 3, 4000, 3, 400)
    noise[2] = 0.0  # the silent row of a missing noise_path passes the signal
    snr = np.array([[5.0], [10.0], [15.0]], np.float32)
    for fn, jfn in ((DP.mix_noise_pydub, JDP.mix_noise_pydub),
                    (DP.mix_noise_at_snr, JDP.mix_noise_at_snr)):
        _close(fn(_t(x), _t(noise), _t(snr)).numpy(),
               jfn(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(snr)), fn.__name__)
    _close(DP.fft_reverb(_t(x), _t(rir)).numpy(),
           JDP.fft_reverb(jnp.asarray(x), jnp.asarray(rir)), "reverb")


def test_bank_rows_match_jax_given_its_draws():
    rng = np.random.default_rng(5)
    bank = _signal(rng, 4, 700)
    key = jax.random.key(9)
    idx, starts = _jax_rows(key, bank.shape, 6, 300)
    want = JDP._random_bank_rows(key, jnp.asarray(bank), 6, 300)
    assert np.array_equal(DP.bank_rows(_t(bank), idx, starts, 300).numpy(), np.asarray(want))
    # the whole bank row: every start is 0
    idx, starts = _jax_rows(key, bank.shape, 6, 700)
    assert starts.max() == 0
    with pytest.raises(ValueError):
        DP.bank_rows(_t(bank), idx, starts, 701)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_compose_views_matches_jax_given_its_draws(variant, mode):
    rng = np.random.default_rng(10 * VARIANTS.index(variant) + MODES.index(mode))
    g, t = 2, 3000
    n_real = 0 if variant == "xinwang" else (2 if variant == "aug_2" else 1)
    n_voc = 0 if variant == "scl_normal" else 2
    n_spoof = 2 if variant in ("augall_5", "scl_normal") else 0
    anchors, reals = _signal(rng, g, t), _signal(rng, g, n_real, t)
    voc, spoofs = _signal(rng, g, n_voc, t), _signal(rng, g, n_spoof, t)
    noise, rir = _banks(rng)
    chains = _chains(rng, g * (1 + n_voc + n_real + n_spoof))
    key = jax.random.key(17)
    want_v, want_l = JDP.compose_views(
        *(jnp.asarray(a) for a in (anchors, reals, voc, spoofs, noise, rir, chains)), key,
        JCFG, variant, mode)
    draws = _jax_view_draws(key, variant, g, n_real, n_voc, n_spoof, t, noise, rir, mode)
    got_v, got_l = DP.compose_views_given(
        *(_t(a) for a in (anchors, reals, voc, spoofs, noise, rir, chains)), draws, CFG,
        variant, mode)
    assert np.array_equal(got_l.numpy(), np.asarray(want_l))
    _close(got_v.numpy(), want_v, f"{variant}/{mode}")
    if mode == "reference":  # noise and reverb views at int16 amplitude
        assert np.abs(got_v[:, 2:4].numpy()).max() > 1000.0


def test_composer_pool_equals_jax_and_steps_are_seeded():
    rng = np.random.default_rng(3)
    noise, rir = _banks(rng)
    comp = DP.DeviceViewComposer(CFG, noise, rir, seed=3, pool_size=8, device="cpu")
    jcomp = JDP.DeviceViewComposer(JCFG, noise, rir, seed=3, pool_size=8)
    assert np.array_equal(comp.chain_pool.numpy(), np.asarray(jcomp.chain_pool))
    g, t = 2, 2000
    anchors, reals, voc = _signal(rng, g, t), _signal(rng, g, 1, t), _signal(rng, g, 3, t)
    v1, l1 = comp(anchors, reals, voc, 11)
    v2, _ = comp(anchors, reals, voc, 11)
    v3, _ = comp(anchors, reals, voc, 12)
    assert v1.shape == (g, 11, t) and torch.equal(l1[0], torch.tensor([1.0] * 5 + [0.0] * 6))
    assert torch.equal(v1, v2) and not torch.equal(v1, v3)
    jv, jl = jcomp(anchors, reals, voc, jax.random.key(0))
    assert jv.shape == v1.shape and np.array_equal(np.asarray(jl), l1.numpy())
    idx_gen, _ = comp.generators(11)
    idx = torch.randint(0, 8, (g * 5,), generator=idx_gen)
    assert 0 <= idx.min() and idx.max() < 8
    with pytest.raises(ValueError):
        DP.DeviceViewComposer(CFG, noise, rir, snr_mode="loud", device="cpu")


def test_int16_wire_equals_the_float_wire():
    """The counterpart of the JAX package's
    ``test_device_pipeline.py::test_int16_wire_matches_float_path``."""
    rng = np.random.default_rng(0)
    g, t = 2, 4000

    def q(x):
        return (np.clip(np.round(x * 32768), -32768, 32767) / 32768).astype(np.float32)

    def to16(x):
        return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)

    anchors, reals, voc = q(_signal(rng, g, t)), q(_signal(rng, g, 1, t)), q(_signal(rng, g, 2, t))
    noise, rir = _banks(rng)
    comp = DP.DeviceViewComposer(CFG, noise, rir, seed=3, pool_size=16, device="cpu")
    v_f, l_f = comp(anchors, reals, voc, 5)
    v_i, l_i = comp(to16(anchors), to16(reals), to16(voc), 5)
    assert torch.equal(l_f, l_i)
    np.testing.assert_allclose(v_i.numpy(), v_f.numpy(), rtol=0, atol=1e-6)


def test_build_banks_equals_jax(tmp_path):
    rng = np.random.default_rng(8)
    save_wav(str(tmp_path / "noise" / "a.wav"), _signal(rng, 3000))
    save_wav(str(tmp_path / "noise" / "sub" / "b.wav"), _signal(rng, 20000))
    save_wav(str(tmp_path / "rir" / "r.wav"), np.exp(-np.arange(900) / 90.0).astype(np.float32))
    (tmp_path / "noise" / "bad.wav").write_bytes(b"not audio")
    for paths in ((str(tmp_path / "noise"), str(tmp_path / "rir")), (None, None)):
        got = DP.build_banks(*paths, bank_len=16000, rir_len=800)
        want = JDP.build_banks(*paths, bank_len=16000, rir_len=800)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------ build_raw and the loader

VARIANT_KW = {
    "augall_3": dict(vocoders=["hifigan", "waveglow"], num_additional_real=1),
    "aug_2": dict(vocoders=["hifigan"], num_additional_real=2),
    "augall_5": dict(vocoders=["hifigan"], num_additional_real=1, num_additional_spoof=2),
    "scl_normal": dict(num_additional_real=1, num_additional_spoof=2),
    "xinwang": dict(vocoders=["hifigan", "waveglow"], repeat_pad=False),
}
UTTS = [f"u{i}.wav" for i in range(5)]
CONF3 = ["RawBoost12", "background_noise_wrapper", "reverb_wrapper"]


@pytest.fixture(scope="module")
def scl_db(tmp_path_factory):
    root = tmp_path_factory.mktemp("dev_aug_db")
    rng = np.random.default_rng(7)
    for u in UTTS:
        n = int(rng.integers(1200, 4000))  # both sides of trim 2400
        save_wav(str(root / "bonafide" / u), _signal(rng, n))
        for v in ("hifigan", "waveglow"):
            save_wav(str(root / "vocoded" / f"{v}_{u}"), _signal(rng, n))
    for i in range(3):
        save_wav(str(root / "spoof" / f"s{i}.wav"), _signal(rng, 3000))
        save_wav(str(root / "spoof_train" / f"t{i}.wav"), _signal(rng, 2000))
    return root


def _builders(db, variant):
    kw = dict(VARIANT_KW[variant])
    repeat = kw.pop("repeat_pad", True)
    spec = D.SCLBatchSpec(variant=variant, trim_length=2400, repeat_pad=repeat,
                          augmentation_methods=CONF3, **kw)
    jspec = JD.SCLBatchSpec(variant=variant, trim_length=2400, repeat_pad=repeat,
                            augmentation_methods=CONF3, **kw)
    return (D.SCLViewBatchBuilder(spec, str(db), UTTS, AugmentResources(), seed=11),
            JD.SCLViewBatchBuilder(jspec, str(db), UTTS, None, seed=11))


@pytest.mark.parametrize("variant", VARIANTS)
def test_build_raw_is_bit_equal_to_jax(scl_db, variant):
    b, jb = _builders(scl_db, variant)
    for idx, epoch in ((0, 0), (3, 2)):
        got, want = b.build_raw(idx, epoch), jb.build_raw(idx, epoch)
        assert list(got) == list(want) and got["utt"] == want["utt"]
        for k in ("anchor", "reals", "vocoded", "spoofs"):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_device_aug_loader_epochs_are_bit_equal_to_jax(scl_db, wire):
    b, jb = _builders(scl_db, "augall_5")
    kw = dict(groups_per_step=2, num_workers=2, seed=5, wire_dtype=wire)
    loader, jloader = L.DeviceAugTrainLoader(b, **kw), JL.DeviceAugTrainLoader(jb, **kw)
    assert len(loader) == len(jloader) == 2
    for epoch in (0, 1):
        got, want = list(loader.epoch(epoch)), list(jloader.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g) == list(w) and g["utts"] == w["utts"]
            for k in ("anchors", "reals", "vocoded", "spoofs"):
                assert g[k].dtype == w[k].dtype == np.dtype(wire)
                assert np.array_equal(g[k], w[k]), k
    with pytest.raises(ValueError):
        L.DeviceAugTrainLoader(b, wire_dtype="int8")


# --------------------------------------------------------------------- CLI

SR = 16000
TRAIN = ["--ssl_preset", "tiny", "--compute_dtype", "float32", "--batch_size", "2",
         "--num_epochs", "2", "--seed", "7", "--num_workers", "2", "--device", "cpu",
         "--device_aug"]


@pytest.fixture(scope="module")
def mini_db(tmp_path_factory):
    """Six anchors with one vocoded copy each, a noise and a RIR file, the
    scp lists and a conf-3 config cut to 4000 samples."""
    root = tmp_path_factory.mktemp("dev_aug_cli_db")
    rng = np.random.default_rng(0)
    utts = [f"u{i}.wav" for i in range(6)]
    for u in utts:
        n = int(rng.integers(3000, 6000))
        save_wav(str(root / "bonafide" / u), _signal(rng, n), SR)
        save_wav(str(root / "vocoded" / f"hifigan_{u}"), _signal(rng, n), SR)
    save_wav(str(root / "musan" / "n.wav"), 0.5 * _signal(rng, SR), SR)
    save_wav(str(root / "rirs" / "r.wav"), np.exp(-np.arange(800) / 120.0).astype(np.float32),
             SR)
    os.makedirs(root / "scp")
    (root / "scp" / "train_bonafide.lst").write_text("\n".join(utts[:4]) + "\n")
    (root / "scp" / "dev_bonafide.lst").write_text("\n".join(utts[4:]) + "\n")

    def config(name, methods):
        path = root / name
        path.write_text(f"""
model:
  name: wav2vec2_linear_nll
  loss_type: 1
data:
  name: 'asvspoof_2019_augall_3'
  kwargs:
    vocoders: ['hifigan']
    augmentation_methods: {methods}
    num_additional_real: 1
    trim_length: 4000
    wav_samp_rate: 16000
    noise_path: '{root}/musan'
    rir_path: '{root}/rirs'
""")
        return str(path)

    return root, config("conf3.yaml", CONF3), config("other.yaml", ["RawBoost12", "volume"])


def test_cli_device_aug_trains_and_composes_the_same_dev_views(mini_db, tmp_path, monkeypatch,
                                                                capsys):
    root, cfg, _ = mini_db
    seen = []
    real_call = DP.DeviceViewComposer.__call__

    def spy(self, anchors, reals, vocoded, step_seed, spoofs=None, variant="augall_3"):
        views, labels = real_call(self, anchors, reals, vocoded, step_seed, spoofs, variant)
        seen.append((step_seed, views.clone()))
        return views, labels

    monkeypatch.setattr(DP.DeviceViewComposer, "__call__", spy)
    out = str(tmp_path / "out")
    assert port_main(["--config", cfg, "--database_path", str(root), "--out_dir", out,
                      "--wire_dtype", "int16", *TRAIN]) == 0
    text = capsys.readouterr().out
    assert "device augmentation: noise bank (1, 128000), rir bank (1, 8000)" in text
    (tag,) = os.listdir(out)
    lines = [l for l in open(os.path.join(out, tag, "metrics.jsonl")) if l.strip()]
    assert len(lines) == 2 and os.path.exists(os.path.join(out, tag, "last.ckpt"))
    dev_seed = composer_seed(7, -1, 0)
    dev = [v for s, v in seen if s == dev_seed]
    train = [s for s, _ in seen if s != dev_seed]
    assert len(dev) == 2 and torch.equal(dev[0], dev[1])  # one dev pass per epoch
    assert len(train) == len(set(train)) == 4  # 2 steps in each of 2 epochs
    assert dev[0].shape == (2, 7, 4000)  # anchor, 3 augmented, 1 real || voc, rb(voc)


def test_cli_device_aug_refuses_another_recipe(mini_db, tmp_path, capsys):
    root, _, other = mini_db
    rc = port_main(["--config", other, "--database_path", str(root),
                    "--out_dir", str(tmp_path), *TRAIN])
    assert rc == 2
    err = capsys.readouterr().err
    assert ("--device_aug supports the conf-3 recipe ['RawBoost12', 'background_noise', "
            "'reverb'] only; this config requests ['RawBoost12', 'volume']") in err


def test_composer_seed_is_fixed_per_epoch_and_step():
    assert composer_seed(7, -1, 0) == composer_seed(7, -1, 0)
    seeds = {composer_seed(s, e, i) for s in (7, 8) for e in (-1, 0, 1) for i in (0, 1)}
    assert len(seeds) == 12 and all(0 <= x < 2 ** 64 for x in seeds)
