"""The port's score-parity check (``train/parity.py``, ``--parity_check``)
against the JAX package's, on the CPU.

Given one scoring function, both harnesses must print the same report,
character for character, in the PASS and the FAIL direction and with no
audio found.  Through the CLI, a reference ``epoch_N.pth`` scored by
``--eval`` passes against its own score file, a perturbed row fails (exit
1), and missing audio is skipped, as in the JAX CLI."""

import os

import numpy as np
import pytest
import torch

from scl_deepfake_audio_detection_tpu.train import parity as jparity
from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.train import parity as pparity
from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

torch.set_num_threads(2)
SR = 16000


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """A mini SCL database (audio under ``eval/``), a reference ``.pth`` of
    a tiny model with the conf-N head width and a tiny conf-3 YAML."""
    from test_torch_convert import _reference_sd

    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig

    root = tmp_path_factory.mktemp("parity_db")
    rng = np.random.default_rng(1)
    utts = [f"p{i}.wav" for i in range(5)]
    os.makedirs(root / "eval")
    os.makedirs(root / "scp")
    for u in utts:
        n = int(rng.integers(4000, 9000))
        save_wav(str(root / "eval" / u), (0.2 * rng.normal(size=n)).astype(np.float32), SR)
    (root / "scp" / "test.lst").write_text("\n".join(utts) + "\n")
    pth = str(root / "epoch_1.pth")
    torch.save(_reference_sd(XLSRConfig.tiny(), np.random.default_rng(2), emb=128), pth)
    yaml = root / "tiny.yaml"
    yaml.write_text(
        "model:\n  name: wav2vec2_linear_nll\n  flag_fix_ssl: false\n"
        "  contra_mode: 'all'\n  loss_type: 1\n"
        "data:\n  name: 'asvspoof_2019_augall_3'\n"
        "  kwargs:\n    vocoders: ['hifigan']\n"
        "    augmentation_methods: ['RawBoost12']\n"
        "    num_additional_real: 1\n    trim_length: 4000\n"
        "    wav_samp_rate: 16000\n    online_aug: true\n")
    return root, utts, pth, str(yaml)


def _score_fn(wav):
    """A fixed function of the audio: both harnesses score with it."""
    w = np.asarray(wav, np.float64)
    a = w[:, ::7].mean(1)
    return np.stack([-a, a + w.std(1)], axis=1).astype(np.float32)


def _score_file(path, root, utts, shift=None):
    from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset

    ds = EvalDataset(utts, str(root))
    rows = []
    for i, u in enumerate(utts):
        s = _score_fn(ds.get(i)[0][None])[0]
        cm1 = float(s[1]) + (shift if shift is not None and i == 2 else 0.0)
        rows.append(f"{u} {s[0]:.9f} {cm1:.9f}")
    with open(path, "w") as f:
        f.write("\n".join(rows + ["missing_utt.flac -1.0 -0.5"]) + "\n")


@pytest.mark.parametrize("shift,ok", [(None, True), (0.5, False)])
def test_parity_report_matches_jax(golden, tmp_path, shift, ok):
    """One score function through both harnesses: the same report, PASS
    and the detected mismatch."""
    root, utts, _, _ = golden
    ref = str(tmp_path / "ref.txt")
    _score_file(ref, root, utts, shift)
    kw = dict(n=0, tol=1e-4, batch_size=2, num_workers=1, score_fn=_score_fn)
    got = pparity.run_parity_check(None, ref, str(root), **kw)
    want = jparity.run_parity_check(None, None, None, ref, str(root), **kw)
    assert got.ok is want.ok is ok
    assert str(got) == str(want)
    assert got.n_scored == len(utts) and got.n_reference == len(utts) + 1
    assert ("PASS" if ok else "FAIL") in str(got)


def test_parity_report_without_audio_matches_jax(golden, tmp_path):
    root, utts, _, _ = golden
    ref = str(tmp_path / "ref.txt")
    _score_file(ref, root, utts)
    empty = tmp_path / "empty"
    (empty / "eval").mkdir(parents=True)
    got = pparity.run_parity_check(None, ref, str(empty), score_fn=_score_fn)
    want = jparity.run_parity_check(None, None, None, ref, str(empty), score_fn=_score_fn)
    assert not got.ok and str(got) == str(want)


def test_parity_check_cli_pass_then_detects_mismatch(golden, tmp_path, capsys):
    """The check of the published EERs, at the tiny preset: ``--eval`` with
    the reference ``.pth``, then ``--parity_check`` against its own scores
    passes (exit 0, as the JAX CLI's on the same files), and a row moved by
    0.5 fails (exit 1), in both CLIs."""
    from scl_deepfake_audio_detection_tpu.cli import main as jax_main

    root, utts, pth, yaml = golden
    common = ["--config", yaml, "--database_path", str(root) + "/", "--batch_size", "2",
              "--model_path", pth, "--ssl_preset", "tiny", "--num_workers", "1",
              "--compute_dtype", "float32"]
    scores = str(tmp_path / "scores.txt")
    assert port_main(common + ["--eval", "--eval_output", scores, "--device", "cpu"]) == 0
    assert len(open(scores).read().split("\n")) == len(utts) + 1
    with open(scores, "a") as f:
        f.write("missing_utt.flac -1.0 -0.5\n")  # skipped: no audio
    check = common + ["--parity_tol", "1e-4", "--parity_check"]
    capsys.readouterr()
    assert port_main(check + [scores, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"parity: {len(utts)}/{len(utts) + 1} reference rows scored" in out
    assert "-> PASS" in out

    lines = open(scores).read().strip().splitlines()
    parts = lines[2].split()
    parts[2] = str(float(parts[2]) + 0.5)
    bad = str(tmp_path / "bad.txt")
    open(bad, "w").write("\n".join(lines[:2] + [" ".join(parts)] + lines[3:]) + "\n")
    assert port_main(check + [bad, "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "(1 rows over tol 0.0001) -> FAIL" in out and parts[0] in out
    # the JAX CLI's verdicts on the same files: the port's fp32 scores are
    # the JAX package's within the tolerance
    assert jax_main(check + [scores]) == 0
    assert jax_main(check + [bad]) == 1
