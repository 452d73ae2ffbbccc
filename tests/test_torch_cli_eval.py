"""The port's eval modes and score analysis against the JAX CLI, on the CPU.

Both CLIs score one database from one JAX checkpoint at ``--ssl_preset
tiny``, fp32: ``--eval --predict``, ``--eval --emb``, ``--eval
--long_audio`` (clips longer than the 64600-sample window) and ``--eval
--resume_eval`` (a file cut mid-row) must give the JAX rows and
embeddings within 1e-5.  The analysis modes (``--analyze`` with its
options, ``--compare``, ``--fuse``, ``--fit_calibration``) must print the
JAX CLI's stdout exactly; they run with the default ``--device cuda`` and
leave CUDA uninitialised.
"""

import os

import numpy as np
import pytest
import torch

import jax

from scl_deepfake_audio_detection_tpu.cli import main as jax_main
from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

# torch 2.13.0+cpu's first multi-threaded ``exp`` in a process can come out
# ~1e-4 off (relative) in one thread's chunk, and every later call is exact;
# the tiny forward is held to 1e-5 here.  One throwaway call per process,
# before any test, keeps it out.
torch.exp(torch.zeros(1 << 20))
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "conf-eval-only.yaml")
ATOL = 1e-5
# samples per utterance: short (both padding branches), the window, and two
# clips longer than it (3 and 4 overlapping crops under --long_audio)
LENGTHS = (9000, 64600, 30000, 100000, 150000)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The database, the checkpoint and a runner: ``run(extra, name)``
    calls both CLIs with the common flags and ``--eval_output`` under
    ``<name>_{jax,port}`` and returns the two paths."""
    root = tmp_path_factory.mktemp("cli_eval")
    rng = np.random.default_rng(11)
    db = root / "db"
    utts = [f"wav/u{i}.wav" for i in range(len(LENGTHS))]
    for u, n in zip(utts, LENGTHS):
        save_wav(str(db / u), (0.1 * rng.normal(size=n)).astype(np.float32))
    (db / "protocol.txt").write_text("".join(
        f"{u} eval {'bonafide' if i % 2 else 'spoof'}\n" for i, u in enumerate(utts)))
    jm = JLinearNLL(ssl=JX.XLSRConfig.tiny(compute_dtype="float32"))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(5)))
    ckpt = str(root / "m.ckpt")
    jckpt.save(ckpt, {"params": params})
    common = ["--eval", "--config", CONFIG, "--database_path", str(db), "--model_path", ckpt,
              "--ssl_preset", "tiny", "--compute_dtype", "float32", "--batch_size", "2",
              "--num_workers", "1", "--padding_type", "repeat"]
    done = {}

    def call(extra, name, before=None):
        if name in done:
            return done[name]
        outs = []
        for side, main, dev in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
            out = str(root / f"{name}_{side}")
            if before is not None:
                before(out)
            assert main(common + extra + ["--eval_output", out] + dev) == 0, side
            outs.append(out)
        done[name] = outs
        return outs

    call.utts = utts
    call.root = root
    return call


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f]


def _assert_rows_close(got, want, score_cols=(1, 2)):
    assert [r[0] for r in got] == [r[0] for r in want]
    for c in score_cols:
        np.testing.assert_allclose([float(r[c]) for r in got], [float(r[c]) for r in want],
                                   atol=ATOL, rtol=0)


def test_predict_writes_the_jax_rows(run):
    jout, pout = run(["--predict"], "pred")
    got, want = _rows(pout), _rows(jout)
    assert [r[0] for r in got] == run.utts
    _assert_rows_close(got, want, score_cols=(1,))
    assert [r[2] for r in got] == [r[2] for r in want]
    # score is cm1 of the eval format, pred its argmax
    jeval, eout = run([], "eval")
    ev = _rows(eout)
    _assert_rows_close(ev, _rows(jeval))
    np.testing.assert_allclose([float(r[1]) for r in got], [float(r[2]) for r in ev],
                               atol=ATOL, rtol=0)
    assert [r[2] for r in got] == [str(int(float(r[2]) > float(r[1]))) for r in ev]


def test_emb_writes_the_jax_scores_and_embeddings(run):
    jdir, pdir = run(["--emb"], "emb")
    _assert_rows_close(_rows(os.path.join(pdir, "scores.txt")),
                       _rows(os.path.join(jdir, "scores.txt")))
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names and len(names) == len(LENGTHS) + 1
    for name in names:
        if name.endswith(".npy"):
            g, w = np.load(os.path.join(pdir, name)), np.load(os.path.join(jdir, name))
            assert g.shape == w.shape == (128,) and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_long_audio_writes_the_jax_rows(run):
    jout, pout = run(["--long_audio"], "long")
    got = _rows(pout)
    assert [r[0] for r in got] == run.utts
    _assert_rows_close(got, _rows(jout))
    # a clip no longer than the window scores as one repeat-padded crop
    _, fixed = run([], "eval")
    short = [i for i, n in enumerate(LENGTHS) if n <= 64600]
    _assert_rows_close([got[i] for i in short], [_rows(fixed)[i] for i in short])


def test_resume_eval_writes_the_jax_rows(run):
    _, full = run([], "eval")
    with open(full) as f:
        text = f.read()
    lines = text.splitlines(keepends=True)
    cut = "".join(lines[:2]) + lines[2][: len(lines[2]) // 2]  # 2 rows + half a row

    def torn(out):
        with open(out, "w") as f:
            f.write(cut)

    jout, pout = run(["--resume_eval"], "resume", before=torn)
    got = _rows(pout)
    with open(pout) as f:
        assert f.read().startswith("".join(lines[:2]))  # kept rows byte-identical
    assert sorted(r[0] for r in got) == sorted(run.utts) and len(got) == len(run.utts)
    _assert_rows_close(got, _rows(jout))
    _assert_rows_close(sorted(got), sorted(_rows(full)))


@pytest.mark.parametrize("argv", [["--emb", "--resume_eval"], ["--predict"]])
def test_refusals_exit_2_in_both_clis(run, argv):
    base = ["--config", CONFIG, "--database_path", str(run.root / "db"), "--ssl_preset", "tiny",
            "--compute_dtype", "float32", "--eval_output", str(run.root / "refused")]
    if "--emb" in argv:
        base.append("--eval")
    assert jax_main(base + argv) == 2
    assert port_main(base + argv + ["--device", "cpu"]) == 2


# ------------------------------------------------------------------ analysis


@pytest.fixture(scope="module")
def scores(tmp_path_factory):
    """Two systems' score files over an ASVspoof protocol with three
    attacks, a subset protocol, ASV scores and a file split into parts."""
    root = tmp_path_factory.mktemp("analysis")
    rng = np.random.default_rng(23)
    n = 60
    utts = [f"LA_E_{i:05d}" for i in range(n)]
    bona = [i % 3 == 0 for i in range(n)]
    attacks = [("-" if b else ("A07", "A08", "A09")[i % 3 - 1]) for i, b in enumerate(bona)]
    (root / "proto.txt").write_text("".join(
        f"LA_{i % 4:04d} {u} - {a} {'bonafide' if b else 'spoof'}\n"
        for i, (u, a, b) in enumerate(zip(utts, attacks, bona))))
    (root / "subset.txt").write_text("".join(
        f"flac/{u}.flac {'dev' if i % 2 else 'eval'} {'bonafide' if b else 'spoof'}\n"
        for i, (u, b) in enumerate(zip(utts, bona))))
    for name, shift in (("a", 1.2), ("b", 0.7)):
        s = rng.normal(size=n) + shift * np.asarray(bona)
        (root / f"{name}.txt").write_text("".join(
            f"{u}.flac {-abs(x) - 0.05} {x}\n" for u, x in zip(utts, s)))
    lines = (root / "a.txt").read_text().splitlines(keepends=True)
    for k in range(3):
        (root / f"a.txt.part{k}").write_text("".join(lines[k::3]).rstrip("\n"))
    (root / "asv.txt").write_text("".join(
        f"LA_0001 {key} {rng.normal(m, 1.0)}\n"
        for key, m, count in (("target", 3, 40), ("nontarget", -2, 50), ("spoof", 1, 30))
        for _ in range(count)))
    return root


ANALYSES = {
    "analyze": ["--analyze", "{r}/a.txt", "--protocol", "{r}/proto.txt"],
    "analyze_extras": ["--analyze", "{r}/a.txt", "--protocol", "{r}/proto.txt", "--per_attack",
                       "--cllr", "--asv_scores", "{r}/asv.txt", "--bootstrap_ci", "40"],
    "analyze_json": ["--analyze", "{r}/a.txt", "--protocol", "{r}/proto.txt", "--per_attack",
                     "--json", "--cllr", "--asv_scores", "{r}/asv.txt", "--bootstrap_ci", "30"],
    "analyze_revised_subset": ["--analyze", "{r}/b.txt", "--protocol", "{r}/subset.txt",
                               "--subset", "eval", "--score_format", "eval"],
    "analyze_tdcf_revised": ["--analyze", "{r}/b.txt", "--protocol", "{r}/proto.txt",
                             "--asv_scores", "{r}/asv.txt", "--tdcf_version", "revised",
                             "--per_attack"],
    "analyze_glob": ["--analyze", "{r}/a.txt.part*", "--protocol", "{r}/proto.txt"],
    "compare": ["--compare", "{r}/a.txt,{r}/b.txt", "--protocol", "{r}/proto.txt",
                "--bootstrap_ci", "60"],
    "fuse": ["--fuse", "{r}/a.txt,{r}/b.txt", "--protocol", "{r}/subset.txt",
             "--fuse_eval", "{r}/b.txt,{r}/a.txt", "--fuse_out", "{r}/fused.txt"],
    "fit_calibration": ["--fit_calibration", "{r}/b.txt", "--protocol", "{r}/proto.txt"],
}


@pytest.mark.parametrize("mode", sorted(ANALYSES))
def test_analysis_prints_the_jax_report(scores, mode, capsys):
    argv = [a.format(r=scores) for a in ANALYSES[mode]]
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    fused_jax = (scores / "fused.txt").read_text() if mode == "fuse" else None
    assert port_main(argv) == 0  # the default --device cuda, with no card here
    got = capsys.readouterr().out
    assert got == want and got.strip()
    if mode == "fuse":
        assert (scores / "fused.txt").read_text() == fused_jax
    if mode == "analyze_glob":
        assert got.startswith("merged 3 score shards\n")
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("argv", [["--analyze", "{r}/a.txt"], ["--compare", "{r}/a.txt,{r}/b.txt"],
                                  ["--fuse", "{r}/a.txt,{r}/b.txt"],
                                  ["--fit_calibration", "{r}/a.txt"],
                                  ["--analyze", "{r}/none*", "--protocol", "{r}/proto.txt"]])
def test_analysis_usage_errors_exit_2_like_jax(scores, argv, capsys):
    argv = [a.format(r=scores) for a in argv]
    assert jax_main(argv) == 2
    want = capsys.readouterr().err
    assert port_main(argv) == 2
    assert capsys.readouterr().err == want
