"""The port's DSP remainder against the JAX package's, on the CPU: the
energy VAD (``dsp/vad``), the silence trims (``dsp/pad``), ``wav2bio_np``
(``dsp/biosegment``), waveform morphing (``dsp/morph``) and the spectral
tools (``dsp/spectral``); and the small leftovers of ported modules
(``utils/audio_io.pcm16_decode`` and ``int16_scale``,
``utils/registry.resolve_augmentation``, ``version``).

Inputs come from a numpy seed: noise at speech level with quiet and silent
stretches, so that the VAD and the bio tokens see all their cases.
Tolerances:
- the host numpy / scipy copies (VAD, trims, morph, mel scale and
  filterbank, Griffin-Lim, LPC, the audio helpers): bit-equal;
- the tensor functions (``stft_mag``, ``melspec``, ``warp_frequency``):
  rtol 1e-5 in fp32, atol 1e-5 of the largest value (the same FFTs and
  products summed in another order);
- the bio tokens: exact, except a frame within 1e-4 dB of a threshold,
  which the two packages' energies (summed in another order) may put on
  either side; such frames are reported, as ``tests/test_torch_btse.py``
  reports them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.dsp import biosegment as JBS
from scl_deepfake_audio_detection_tpu.dsp import morph as JM
from scl_deepfake_audio_detection_tpu.dsp import pad as JP
from scl_deepfake_audio_detection_tpu.dsp import spectral as JSP
from scl_deepfake_audio_detection_tpu.dsp import vad as JV
from scl_deepfake_audio_detection_tpu.utils import audio_io as JA
from scl_deepfake_audio_detection_tpu.utils import registry as JR
from scl_deepfake_audio_detection_torch.dsp import biosegment as PBS
from scl_deepfake_audio_detection_torch.dsp import morph as PM
from scl_deepfake_audio_detection_torch.dsp import pad as PP
from scl_deepfake_audio_detection_torch.dsp import spectral as PSP
from scl_deepfake_audio_detection_torch.dsp import vad as PV
from scl_deepfake_audio_detection_torch.utils import audio_io as PA
from scl_deepfake_audio_detection_torch.utils import registry as PR

SR = 16000
NEAR_DB = 1e-4


def speech(n=24000, seed=0, lead=3000, tail=2500, gaps=((9000, 10600),)):
    """Noise at speech level with silent edges and quiet gaps."""
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal(n)).astype(np.float32)
    x[:lead] *= 1e-4
    x[n - tail:] *= 1e-4
    for a, b in gaps:
        x[a:b] *= 1e-3
    return x


SIGNALS = {"edges_and_gap": speech(),
           "short_burst": speech(seed=1, gaps=((8000, 8400), (12000, 12500))),
           "all_speech": speech(seed=2, lead=0, tail=0, gaps=()),
           "silent": np.zeros(8000, np.float32)}


def _equal(a, b):
    assert np.asarray(a).dtype == np.asarray(b).dtype
    assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------- VAD


@pytest.mark.parametrize("edge", [False, True], ids=["all", "edges_only"])
@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_vad_is_bit_equal(name, edge):
    x = SIGNALS[name]
    _equal(PV.detect_speech_frames(x, SR, only_edge_silence=edge),
           JV.detect_speech_frames(x, SR, only_edge_silence=edge))
    for normalize in (True, False):
        for got, want in zip(PV.split_speech_silence(x, SR, normalize=normalize,
                                                     only_edge_silence=edge),
                             JV.split_speech_silence(x, SR, normalize=normalize,
                                                     only_edge_silence=edge)):
            _equal(got, want)
    assert PV.speech_bounds_samples(x, SR) == JV.speech_bounds_samples(x, SR)
    tag = (np.random.default_rng(3).random(200) < 0.6).astype(int)
    _equal(PV._suppress_short_segments(tag, 4.5), JV._suppress_short_segments(tag, 4.5))


def test_vad_refuses_a_shift_as_long_as_the_frame():
    with pytest.raises(ValueError, match="frame shift"):
        PV.detect_speech_frames(SIGNALS["all_speech"], SR, frame_len=80, frame_shift=80)


@pytest.mark.parametrize("random_trim", [False, True], ids=["exact", "random"])
@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_silence_trims_are_bit_equal_for_one_seed(name, random_trim):
    x = SIGNALS[name]
    got = PP.rand_sil_trim(x, SR, random_trim, np.random.default_rng(5))
    want = JP.rand_sil_trim(x, SR, random_trim, np.random.default_rng(5))
    assert got[1:] == want[1:]
    _equal(got[0], want[0])
    views = [x, 0.5 * x, x[::-1].copy()]
    got = PP.multiview_silence_trim(views, SR, random_trim, np.random.default_rng(6))
    want = JP.multiview_silence_trim(views, SR, random_trim, np.random.default_rng(6))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _equal(g, w)


# ---------------------------------------------------------------- bio tokens


def test_wav2bio_np_gives_the_jax_tokens():
    rng = np.random.default_rng(7)
    wav = (0.1 * rng.standard_normal((3, 6400))).astype(np.float32)
    wav[:, 1000:2600] *= 0.01  # -40 dB: BREATHING
    wav[:, 4000:5000] = 0.0  # SILENCE
    got = PBS.wav2bio_np(wav, device="cpu")
    want = JBS.wav2bio_np(wav)
    assert isinstance(got, np.ndarray) and got.dtype == np.int32 and got.shape == want.shape
    e, peak = PBS.frame_energy_db(torch.from_numpy(wav))
    gap = torch.minimum((e - (peak - 30.0)).abs(), (e - (peak - 55.0)).abs())
    near = (gap < NEAR_DB).numpy()
    if near.any():
        print(f"bio frames within {NEAR_DB} dB of a threshold: {np.argwhere(near).tolist()}")
    assert np.array_equal(got[~near], want[~near])
    assert set(np.unique(got).tolist()) == {0, 1, 2}
    _equal(PBS.wav2bio_np(wav[0].astype(np.float64), device="cpu"), got[0])


def test_wav2bio_np_takes_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PBS.wav2bio_np(np.zeros(640, np.float32))


# ---------------------------------------------------------------- morph


@pytest.mark.parametrize("method", [1, 2, 3, 4, "specamp-phase"])
def test_morph_is_bit_equal(method):
    """Method 3's real part takes the un-morphed phase in both (the
    reference's quirk, kept)."""
    a = speech(8000, seed=8, lead=0, tail=0, gaps=())
    b = speech(9000, seed=9, lead=0, tail=0, gaps=())
    _equal(PM.morph_waveform(a, b, 0.3, method), JM.morph_waveform(a, b, 0.3, method))
    _equal(PM.morph_waveform(a[:, None], b, 0.6, method),
           JM.morph_waveform(a[:, None], b, 0.6, method))
    with pytest.raises(ValueError, match="morph method"):
        PM.morph_waveform(a, b, 0.3, "nope")


# ---------------------------------------------------------------- spectral


def test_spectral_host_tools_are_bit_equal():
    _equal(PSP.hz_to_mel([0.0, 440.0, 8000.0]), JSP.hz_to_mel([0.0, 440.0, 8000.0]))
    _equal(PSP.mel_to_hz([0.0, 500.0, 2840.0]), JSP.mel_to_hz([0.0, 500.0, 2840.0]))
    _equal(PSP.mel_filterbank(16000, 512, 40, 20.0, 7600.0),
           JSP.mel_filterbank(16000, 512, 40, 20.0, 7600.0))
    x = speech(6000, seed=10, lead=0, tail=0, gaps=())
    mag = np.abs(np.fft.rfft(x[:4096].reshape(16, 256) * np.hanning(256), axis=-1))
    _equal(PSP.griffin_lim(mag, n_fft=256, hop=64, n_iter=4, length=1100),
           JSP.griffin_lim(mag, n_fft=256, hop=64, n_iter=4, length=1100))
    frames = x[:4000].reshape(10, 400) * np.hanning(400)
    (a, g), (ja, jg) = PSP.lpc_analysis(frames, 12), JSP.lpc_analysis(frames, 12)
    _equal(a, ja), _equal(g, jg)
    res = PSP.lpc_residual(frames, a)
    _equal(res, JSP.lpc_residual(frames, ja))
    _equal(PSP.lpc_synthesis(res, a), JSP.lpc_synthesis(res, ja))


def _rel_close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(1500,), (2, 3, 2200)], ids=["1d", "batched"])
def test_spectral_tensor_functions_match_jax(shape):
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    _rel_close(PSP.stft_mag(torch.from_numpy(x), 256, 64),
               JSP.stft_mag(jnp.asarray(x), 256, 64))
    win = np.hamming(128).astype(np.float32)
    _rel_close(PSP.stft_mag(torch.from_numpy(x), 128, 48, window=torch.from_numpy(win)),
               JSP.stft_mag(jnp.asarray(x), 128, 48, window=jnp.asarray(win)))
    for log in (True, False):
        _rel_close(PSP.melspec(torch.from_numpy(x), n_fft=256, hop=64, n_mels=24, log=log),
                   JSP.melspec(jnp.asarray(x), n_fft=256, hop=64, n_mels=24, log=log))
    mag = np.abs(x[..., :129])
    for alpha in (0.0, 0.2, -0.3):
        _rel_close(PSP.warp_frequency(torch.from_numpy(mag), alpha),
                   JSP.warp_frequency(jnp.asarray(mag), alpha))


def test_stft_keeps_the_symmetric_hann_window():
    """``np.hanning`` (symmetric), not ``torch.stft``'s periodic default: a
    frame of ones has the symmetric window's DC sum."""
    mag = PSP.stft_mag(torch.ones(4096), 256, 64)
    assert float(mag[8, 0]) == pytest.approx(float(np.hanning(256).sum()), rel=1e-6)


# ---------------------------------------------------------------- leftovers


def test_pcm16_helpers_are_bit_equal():
    x = np.random.default_rng(12).uniform(-1.2, 1.2, 5000).astype(np.float32)
    pcm = PA.pcm16_encode(x)
    _equal(PA.pcm16_decode(pcm), JA.pcm16_decode(pcm))
    _equal(PA.pcm16_encode(PA.pcm16_decode(pcm)), pcm)  # lossless from 16 bits
    _equal(PA.int16_scale(x), JA.int16_scale(x))


def test_resolve_augmentation_resolves_every_jax_name_alike():
    names = JR.AUGMENTATIONS.names()
    assert names
    for name in names:
        assert PR.resolve_augmentation(name).__name__ == JR.resolve_augmentation(name).__name__
    with pytest.raises(KeyError, match="unknown augmentation"):
        PR.resolve_augmentation("no_such_method")


def test_version_is_the_jax_packages_and_the_package_exports_it():
    import scl_deepfake_audio_detection_torch as port
    from scl_deepfake_audio_detection_torch import version
    from scl_deepfake_audio_detection_tpu import version as jversion

    assert port.__version__ == version.__version__ == jversion.__version__ == "0.1.0"
