"""The port's decode cache (``--decode_cache``) and augmentation-cache
warm-up (``--warm_cache``) against the JAX package's, on the CPU.

- ``DecodeCache`` writes ``pcm16.bin`` and ``index.json`` byte-identical to
  the JAX package's for the same list, and refuses a stale pair as it does;
- ``--eval --decode_cache DIR`` run twice (the first builds the cache, the
  second reads it) gives the JAX CLI's rows within 1e-5 (fp32, tiny preset,
  one JAX checkpoint) and the JAX CLI's cache files, in one process's
  layout and as process 1 of 2 (``DIR/part1``, ``out.part1``);
- ``--warm_cache`` writes the JAX CLI's file set with the same bytes.
"""

import os

import numpy as np
import pytest
import torch

import jax

import jax_native_ready
import scl_deepfake_audio_detection_tpu.native as jnative
from scl_deepfake_audio_detection_tpu.cli import context as jcontext
from scl_deepfake_audio_detection_tpu.cli import main as jax_main
from scl_deepfake_audio_detection_tpu.data.decode_cache import DecodeCache as JCache
from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_tpu.utils.audio_io import load_audio as jload
import scl_deepfake_audio_detection_torch.native as pnative
from scl_deepfake_audio_detection_torch.cli import context as pcontext
from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.data.decode_cache import DecodeCache
from scl_deepfake_audio_detection_torch.utils.audio_io import load_audio, save_wav

# as tests/test_torch_cli_eval.py: one throwaway multi-threaded exp first
torch.exp(torch.zeros(1 << 20))
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "conf-eval-only.yaml")
ATOL = 1e-5
SR = 16000


def _eval_db(root):
    """Five utterances of 9000-30000 samples; two are FLAC where the codec
    library builds (the LA19 and DF21 lists ship FLAC)."""
    rng = np.random.default_rng(21)
    flac = jax_native_ready.codec()
    utts = []
    for i, n in enumerate((9000, 30000, 16000, 21000, 12000)):
        x = (np.clip(np.round(0.1 * rng.normal(size=n) * 32768), -32768, 32767)
             / 32768).astype(np.float32)
        u = f"wav/u{i}.flac" if flac and i % 2 else f"wav/u{i}.wav"
        os.makedirs(root / "wav", exist_ok=True)
        if u.endswith(".flac"):
            jnative.encode_audio(str(root / u), x, SR, "flac")
        else:
            save_wav(str(root / u), x, SR)
        utts.append(u)
    (root / "protocol.txt").write_text("".join(
        f"{u} eval {'bonafide' if i % 2 else 'spoof'}\n" for i, u in enumerate(utts)))
    return utts


def _files(d):
    out = {}
    for base, _, names in os.walk(d):
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def test_decode_cache_files_are_byte_identical_to_jax(tmp_path):
    db = tmp_path / "db"
    utts = _eval_db(db)
    cache = DecodeCache.build(str(tmp_path / "port"), utts,
                              lambda u: load_audio(str(db / u)), num_workers=2)
    jcache = JCache.build(str(tmp_path / "jax"), utts, lambda u: jload(str(db / u)),
                          num_workers=2)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert cache.ready and len(cache) == len(jcache) == len(utts)
    for u in utts:
        got = cache.get(u)
        assert got.dtype == np.float32 and np.array_equal(got, jcache.get(u))
        np.testing.assert_array_equal(got, load_audio(str(db / u)))


@pytest.mark.parametrize("stale", ["bin_longer", "bin_shorter", "no_index", "no_bin"])
def test_a_stale_cache_is_refused_as_jax_refuses_it(tmp_path, stale):
    db = tmp_path / "db"
    utts = _eval_db(db)
    d = tmp_path / "cache"
    DecodeCache.build(str(d), utts, lambda u: load_audio(str(db / u)), num_workers=1)
    if stale == "bin_longer":
        with open(d / "pcm16.bin", "ab") as f:
            f.write(b"\0\0")
    elif stale == "bin_shorter":
        data = (d / "pcm16.bin").read_bytes()
        (d / "pcm16.bin").write_bytes(data[:-2])
    else:
        os.remove(d / ("index.json" if stale == "no_index" else "pcm16.bin"))
    cache, jcache = DecodeCache(str(d)), JCache(str(d))
    assert not cache.ready and not jcache.ready
    assert len(cache) == 0 and not cache.has(utts[0]) and cache.sample_rate is None


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("decode_cache_cli")
    db = root / "db"
    utts = _eval_db(db)
    jm = JLinearNLL(ssl=JX.XLSRConfig.tiny(compute_dtype="float32"))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(6)))
    ckpt = str(root / "m.ckpt")
    jckpt.save(ckpt, {"params": params})
    common = ["--eval", "--config", CONFIG, "--database_path", str(db), "--model_path", ckpt,
              "--ssl_preset", "tiny", "--compute_dtype", "float32", "--batch_size", "2",
              "--num_workers", "2"]
    return root, utts, common


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f]


def _as_process(monkeypatch, mod, pidx, pcnt):
    """Make the CLI's runtime that of process ``pidx`` of ``pcnt``."""
    build = mod.build_runtime

    def wrapped(args):
        ctx = build(args)
        ctx.pidx, ctx.pcnt = pidx, pcnt
        return ctx

    monkeypatch.setattr(mod, "build_runtime", wrapped)


@pytest.mark.parametrize("layout", ["single", "part"])
def test_eval_with_decode_cache_twice_matches_jax(eval_setup, monkeypatch, layout):
    root, utts, common = eval_setup
    out_dir = root / layout
    pidx, pcnt = (1, 2) if layout == "part" else (0, 1)
    _as_process(monkeypatch, jcontext, pidx, pcnt)
    _as_process(monkeypatch, pcontext, pidx, pcnt)
    plain = str(out_dir / "plain_port.txt")
    assert port_main(common + ["--eval_output", plain, "--device", "cpu"]) == 0
    suffix = f".part{pidx}" if pcnt > 1 else ""
    rows = {}
    for side, main, dev in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        cache = str(out_dir / f"cache_{side}")
        for run in (1, 2):
            out = str(out_dir / f"{side}{run}.txt")
            assert main(common + ["--decode_cache", cache, "--eval_output", out] + dev) == 0
            rows[side, run] = _rows(out + suffix)
        sub = os.path.join(cache, f"part{pidx}") if pcnt > 1 else cache
        assert sorted(os.listdir(sub)) == ["index.json", "pcm16.bin"]
    assert _files(out_dir / "cache_port") == _files(out_dir / "cache_jax")
    want_utts = utts[pidx::pcnt]
    assert [r[0] for r in _rows(plain + suffix)] == want_utts
    for key, got in rows.items():
        assert [r[0] for r in got] == want_utts, key
        np.testing.assert_allclose(np.array([r[1:] for r in got], float),
                                   np.array([r[1:] for r in rows["jax", 1]], float),
                                   atol=ATOL, rtol=0, err_msg=str(key))
    # the cache is lossless here: the same rows as decoding every file
    assert rows["port", 1] == rows["port", 2] == _rows(plain + suffix)


@pytest.fixture
def natives(request, monkeypatch):
    if request.param == "off":
        for mod in (jnative, pnative):
            monkeypatch.setattr(mod, "available", lambda: False)
    elif not jax_native_ready.host():
        pytest.skip("a native host library does not build here")
    return request.param


@pytest.mark.parametrize("natives", ["off", "on"], indirect=True)
def test_warm_cache_writes_the_jax_files(tmp_path, natives, capsys):
    rng = np.random.default_rng(3)
    db = tmp_path / "db"
    utts = [f"u{i}.wav" for i in range(4)]
    for u in utts:
        n = int(rng.integers(3000, 6000))
        save_wav(str(db / "bonafide" / u), rng.normal(size=n).astype(np.float32) * 0.2, SR)
        save_wav(str(db / "vocoded" / f"hifigan_{u}"),
                 rng.normal(size=n).astype(np.float32) * 0.2, SR)
    save_wav(str(db / "musan" / "n.wav"), rng.normal(size=SR).astype(np.float32) * 0.1, SR)
    save_wav(str(db / "rirs" / "r.wav"), np.exp(-np.arange(800) / 120.0).astype(np.float32), SR)
    os.makedirs(db / "scp")
    (db / "scp" / "train_bonafide.lst").write_text("\n".join(utts[:3]) + "\n")
    (db / "scp" / "dev_bonafide.lst").write_text("\n".join(utts[3:]) + "\n")
    logs = {}
    for side, main in (("jax", jax_main), ("port", port_main)):
        cfg = tmp_path / f"{side}.yaml"
        cfg.write_text(f"""
model:
  name: wav2vec2_linear_nll
data:
  name: 'asvspoof_2019_augall_3'
  kwargs:
    vocoders: ['hifigan']
    augmentation_methods: ["RawBoost12", "background_noise_wrapper", "reverb_wrapper"]
    trim_length: 4000
    wav_samp_rate: 16000
    online_aug: false
    aug_dir: '{tmp_path}/aug_{side}'
    noise_path: '{db}/musan'
    rir_path: '{db}/rirs'
""")
        # no --device cpu: the warm-up builds no model and touches no device
        argv = ["--warm_cache", "--config", str(cfg), "--database_path", str(db),
                "--seed", "9", "--num_workers", "2"]
        assert main(argv) == 0, side
        logs[side] = [ln.split(" (")[0] for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith(("train:", "dev:"))]
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 2
    got, want = _files(tmp_path / "aug_port"), _files(tmp_path / "aug_jax")
    # every method of every file: 4 bonafide x 3, 4 vocoded x RawBoost12
    assert sorted(got) == sorted(want) and len(want) == 16
    assert got == want
