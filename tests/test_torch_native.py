"""The port's native host libraries and audio decode against the JAX
package's, on the CPU.

The port builds its own copies of ``native/scl_host.cpp`` and
``native/scl_codec.cpp`` with the JAX package's flags, so every bound
function must give the JAX binding's output bit for bit
(``np.array_equal``) on the same inputs, and ``load_audio`` must return the
same array, or raise the same exception type with the same message prefix,
on every kind of file.  The build is held to what six test workers need:
processes that build at once into one empty directory all load a whole
library, and importing builds nothing.
"""

import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest

import scl_deepfake_audio_detection_tpu.native as jnative
from scl_deepfake_audio_detection_tpu.utils import audio_io as jio
from scl_deepfake_audio_detection_torch import native as pnative
from scl_deepfake_audio_detection_torch.utils import audio_io as pio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def host_libs():
    if not (jnative.available() and pnative.available()):
        pytest.skip("a native host library does not build here")


@pytest.fixture
def codec():
    if not jnative.codec_available():
        pytest.skip("the JAX package's codec library does not build here")
    assert pnative.codec_available()


def _x(seed, n=4000, scale=0.3):
    return (scale * np.random.default_rng(seed).normal(size=n)).astype(np.float32)


def _pcm16_exact(x):
    return (np.clip(np.round(x * 32768), -32768, 32767) / 32768).astype(np.float32)


@pytest.mark.parametrize("name", ["scl_host.cpp", "scl_codec.cpp"])
def test_cpp_copy_is_byte_identical(name):
    with open(os.path.join(REPO, "native", name), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "scl_deepfake_audio_detection_torch", "native_src",
                           name), "rb") as f:
        assert f.read() == want


def _read_wav(mod, tmp_path):
    path = str(tmp_path / "a.wav")
    pio.save_wav(path, _x(1), 16000)
    return mod.read_wav(path)


def _chains():
    rng = np.random.default_rng(3)
    return [rng.normal(size=n) for n in (31, 41, 51, 61, 71)]


BOUND = {
    "read_wav": _read_wav,
    "fir_centered": lambda m, _: m.fir_centered(_x(2), np.random.default_rng(2).normal(size=41)),
    "lnl_apply": lambda m, _: m.lnl_apply(_x(3), _chains()),
    "isd_apply": lambda m, _: m.isd_apply(_x(4), p_max=10.0, g_sd=2.0, seed=42),
    "ssi_mix": lambda m, _: m.ssi_mix(_x(5), _x(6, scale=1.0), 12.5),
    "multiview_pad": lambda m, _: m.multiview_pad(
        [_x(7, 7000), _x(8, 5000), _x(9, 9000)], 6400, True, 321),
    "multiview_pad_zero": lambda m, _: m.multiview_pad(
        [_x(7, 3000), _x(8, 5000)], 4000, False, 0),
    "mix_at_snr": lambda m, _: m.mix_at_snr(_x(10), _x(11, 2500), 7.0),
}


@pytest.mark.parametrize("fn", sorted(BOUND))
def test_bound_function_is_bit_equal_to_jax(host_libs, tmp_path, fn):
    got, want = BOUND[fn](pnative, tmp_path), BOUND[fn](jnative, tmp_path)
    if fn == "read_wav":
        (got, sr), (want, jsr) = got, want
        assert sr == jsr == 16000
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_flac_decodes_bit_equal_through_both(codec, tmp_path, encoder):
    """A FLAC written by either package's encoder decodes to the same
    samples through both, and FLAC is lossless for PCM16 audio."""
    x = _pcm16_exact(_x(12, 20000))
    path = str(tmp_path / "a.flac")
    (jnative if encoder == "jax" else pnative).encode_audio(path, x, 16000, "flac")
    assert pnative.encoder_available("flac") == jnative.encoder_available("flac") is True
    (got, sr), (want, jsr) = pnative.read_audio(path), jnative.read_audio(path)
    assert sr == jsr == 16000 and np.array_equal(got, want)
    np.testing.assert_array_equal(got[: len(x)], x)
    np.testing.assert_array_equal(pio.load_audio(path), jio.load_audio(path))


def _write_wav24(path, x, sr):
    v = np.clip(np.round(x * (1 << 23)), -(1 << 23), (1 << 23) - 1).astype("<i4")
    raw = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], -1).astype(np.uint8)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(sr)
        w.writeframes(raw.tobytes())


def _case_file(tmp_path, case):
    x = _x(13, 8000)
    if case in ("wav_16k", "wav_8k_resampled"):
        path = str(tmp_path / "a.wav")
        pio.save_wav(path, x, 16000 if case == "wav_16k" else 8000)
    elif case == "wav_24bit":
        path = str(tmp_path / "a.wav")
        _write_wav24(path, x, 16000)
    elif case == "flac":
        path = str(tmp_path / "a.flac")
        jnative.encode_audio(path, _pcm16_exact(x), 22050, "flac")
    elif case == "unknown_extension":
        path = str(tmp_path / "a.xyz")
        with open(path, "wb") as f:
            f.write(b"not audio at all" * 64)
    else:  # missing files
        path = str(tmp_path / ("gone.wav" if case == "missing_wav" else "gone.flac"))
    return path


@pytest.mark.parametrize("case", ["wav_16k", "wav_8k_resampled", "wav_24bit", "flac",
                                  "missing_wav", "missing_flac", "unknown_extension"])
def test_load_audio_agrees_with_jax(codec, tmp_path, case):
    path = _case_file(tmp_path, case)
    outcomes = []
    for load in (pio.load_audio, jio.load_audio):
        try:
            outcomes.append(load(path))
        except Exception as e:  # noqa: BLE001 -- compared below
            outcomes.append(e)
    got, want = outcomes
    if isinstance(want, Exception):
        assert type(got) is type(want), (got, want)
        assert str(got).split(":")[0] == str(want).split(":")[0], (got, want)
        assert case.startswith("missing") or case == "unknown_extension"
    else:
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["wav_16k", "flac"])
def test_load_audio_without_the_libraries_agrees_with_jax(monkeypatch, tmp_path, case):
    """With neither package's native libraries, WAV goes through the
    stdlib reader and FLAC raises the JAX package's error."""
    if case == "flac" and not jnative.codec_available():
        pytest.skip("the JAX package's codec library does not build here")
    path = _case_file(tmp_path, case)
    for mod in (jnative, pnative):
        monkeypatch.setattr(mod, "available", lambda: False)
        monkeypatch.setattr(mod, "codec_available", lambda: False)
    if case == "flac":
        with pytest.raises(RuntimeError, match="cannot decode '.flac'") as got:
            pio.load_audio(path)
        with pytest.raises(RuntimeError, match="cannot decode '.flac'") as want:
            jio.load_audio(path)
        assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
    else:
        np.testing.assert_array_equal(pio.load_audio(path), jio.load_audio(path))


def test_a_library_that_does_not_build_is_unavailable(monkeypatch, tmp_path):
    """A failed compile leaves ``available()`` False and the callers on
    their numpy path; nothing half-built is left behind."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "scl_host.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "_SRC_DIR", src)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_tried", False)
    monkeypatch.setattr(pnative, "BUILD_ERRORS", {})
    assert not pnative.available()
    assert not any((tmp_path / "build").iterdir())
    assert "error" in pnative.BUILD_ERRORS["scl_host"]
    with pytest.raises(RuntimeError, match="native library unavailable"):
        pnative.fir_centered(_x(0), np.ones(3))


BUILD_RACE = """
import json, sys
from pathlib import Path
from scl_deepfake_audio_detection_torch import native
native.BUILD_DIR = Path(sys.argv[1])
x = [0.5, -0.25, 0.125]
host = native.available() and native.fir_centered(x, [1.0]).shape == (3,)
print(json.dumps({"host": bool(host), "codec": native.codec_available()}))
"""


def test_processes_building_at_once_all_load_the_libraries(tmp_path):
    """Four processes build both libraries into one empty directory at the
    same time, as test workers do in a fresh checkout: each loads a whole
    library, and no temporary file is left."""
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_RACE, str(build)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    codec_ok = jnative.codec_available()
    assert results == [{"host": True, "codec": codec_ok}] * 4
    names = sorted(f.name for f in build.iterdir())
    assert len(names) == 1 + codec_ok and all(n.endswith(".so") for n in names), names


def test_importing_native_builds_nothing():
    code = (
        "import importlib, pkgutil\n"
        "import scl_deepfake_audio_detection_torch as port\n"
        "for info in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):\n"
        "    if not info.name.endswith('__main__'):\n"
        "        importlib.import_module(info.name)\n"
        "from scl_deepfake_audio_detection_torch import native as n\n"
        "assert n._lib is None and n._codec_lib is None\n"
        "assert not n._tried and not n._codec_tried\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
