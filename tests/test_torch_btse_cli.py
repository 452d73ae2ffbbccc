"""The BTSE back-end through the port's CLI against the JAX CLI, on the CPU
at ``--ssl_preset tiny``, fp32, on ``configs/conf-5-btse-trans64.yaml``
with its database paths pointed at one the test writes (its training clips
cut to 4000 samples): ``--eval``, ``--predict``, ``--emb``, ``--eval
--long_audio``, ``--eval --resume_eval``, ``--serve`` and ``--serve_http``
replies, the ``--show_params`` table, the training CLI's ``last.ckpt`` in
either direction, ``--average_ckpts``, ``--export_model`` /
``--verify_export`` / ``--eval --from_export``, and ``--eval`` under the
'gru', 'conv' and 'light' bio encoders (set in the YAML's ``model:``).

Both CLIs score one database from one checkpoint the JAX package writes
(a seeded model's parameters).  The eval clips hold stretches at -40 dB
and at zero, so their bio tokens take all three values.  Rows and replies
are held within 1e-5; the artifact within 1e-4 of ``--eval`` (an fp32
program of the same products, recorded by ``torch.export``)."""

import io
import os
import sys

import numpy as np
import pytest
import torch

import jax

from scl_deepfake_audio_detection_tpu.cli import main as jax_main
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.dsp.biosegment import wav2bio
from scl_deepfake_audio_detection_torch.models.btse import XLSRBtse
from scl_deepfake_audio_detection_torch.models.params import to_jax
from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

from test_torch_zoo_cli import _flat, _rows, _rows_close

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_cli_eval.py
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF5 = os.path.join(REPO, "configs", "conf-5-btse-trans64.yaml")
SR = 16000
VOCODERS = ("hifigan", "hn-sinc-nsf-hifi", "waveglow")  # conf-5's
EVAL_LENGTHS = (20000, 64600, 100000, 30000)  # the third is 2 windows under --long_audio


def _conf5(root, encoder=None):
    """conf-5's YAML with its three paths in ``root`` and 4000-sample
    training clips; ``encoder`` sets ``bio_encoder_type``."""
    with open(CONF5) as f:
        text = f.read()
    for key, value in (("aug_dir", root / "aug"), ("noise_path", root / "musan"),
                       ("rir_path", root / "rirs")):
        line = next(ln for ln in text.splitlines() if ln.strip().startswith(f"{key}:"))
        text = text.replace(line, line.split(":")[0] + f": '{value}'")
    text = text.replace("trim_length: 64000", "trim_length: 4000")
    if encoder:
        text = text.replace("  bio_dim: 32\n", f"  bio_dim: 32\n  bio_encoder_type: {encoder}\n")
    path = root / f"conf5{'-' + encoder if encoder else ''}.yaml"
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """Eval clips with quiet and silent stretches, six training anchors with
    a copy per conf-5 vocoder, three spoofs, noise and RIR files, the YAMLs, and a
    checkpoint of each encoder's model written by the JAX package."""
    root = tmp_path_factory.mktemp("btse_cli")
    rng = np.random.default_rng(0)
    evals = [f"e{i}.wav" for i in range(len(EVAL_LENGTHS))]
    for i, (u, n) in enumerate(zip(evals, EVAL_LENGTHS)):
        x = (0.1 * rng.normal(size=n)).astype(np.float32)
        x[n // 4 + 1000 * i:n // 2] *= 0.01
        x[3 * n // 4:3 * n // 4 + 6400] = 0.0
        save_wav(str(root / "eval" / u), x, SR)
    anchors = [f"u{i}.wav" for i in range(6)]
    for u in anchors:
        n = int(rng.integers(3000, 6000))
        save_wav(str(root / "bonafide" / u), (0.2 * rng.normal(size=n)).astype(np.float32), SR)
        for v in VOCODERS:
            save_wav(str(root / "vocoded" / f"{v}_{u}"),
                     (0.2 * rng.normal(size=n)).astype(np.float32), SR)
    save_wav(str(root / "musan" / "n.wav"), (0.1 * rng.normal(size=SR)).astype(np.float32), SR)
    save_wav(str(root / "rirs" / "r.wav"), np.exp(-np.arange(800) / 120.0).astype(np.float32),
             SR)
    os.makedirs(root / "scp")
    (root / "scp" / "train_bonafide.lst").write_text("\n".join(anchors[:4]) + "\n")
    (root / "scp" / "dev_bonafide.lst").write_text("\n".join(anchors[4:]) + "\n")
    (root / "scp" / "test.lst").write_text("\n".join(evals) + "\n")
    for i in range(3):  # conf-5 adds a real spoof view
        save_wav(str(root / "spoof" / f"s{i}.wav"),
                 (0.2 * rng.normal(size=5000)).astype(np.float32), SR)
    cfgs, ckpts = {}, {}
    for enc in ("transformer", "gru", "conv", "light"):
        cfgs[enc] = _conf5(root, None if enc == "transformer" else enc)
        model = XLSRBtse(ssl=XLSRConfig.tiny(), bio_encoder_type=enc, device="cpu", seed=3)
        ckpts[enc] = str(root / f"{enc}.ckpt")
        jckpt.save(ckpts[enc], {"params": to_jax(model)})
    return root, cfgs, ckpts, evals


def _common(db, enc="transformer"):
    root, cfgs, ckpts, _ = db
    return ["--config", cfgs[enc], "--database_path", str(root), "--model_path", ckpts[enc],
            "--ssl_preset", "tiny", "--compute_dtype", "float32", "--batch_size", "2",
            "--num_workers", "1"]


def _both(argv, tmp_path, tag, before=None):
    outs = []
    for side, main, dev in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}_{side}")
        if before:
            before(out)
        assert main(argv + ["--eval_output", out] + dev) == 0, side
        outs.append(out)
    return outs


def test_eval_clips_hold_every_token(db):
    from scl_deepfake_audio_detection_torch.utils.audio_io import load_audio

    root, _, _, evals = db
    seen = set()
    for u in evals:
        x = load_audio(str(root / "eval" / u))
        seen |= set(wav2bio(torch.from_numpy(np.asarray(x, np.float32))[None, :64600])
                    .flatten().tolist())
    assert seen == {0, 1, 2}


@pytest.fixture(scope="module")
def evaluated(db, tmp_path_factory):
    """The two CLIs' ``--eval`` score files of the conf-5 model."""
    return _both(["--eval"] + _common(db), tmp_path_factory.mktemp("btse_eval"), "eval")


def test_eval_rows_match_the_jax_cli(db, evaluated):
    jout, pout = evaluated
    got = _rows(pout)
    assert [r[0] for r in got] == db[3]
    _rows_close(got, _rows(jout), (1, 2))


def test_predict_rows_match_the_jax_cli(db, tmp_path):
    jout, pout = _both(["--eval", "--predict"] + _common(db), tmp_path, "pred")
    got, want = _rows(pout), _rows(jout)
    _rows_close(got, want, (1,))
    assert [r[2] for r in got] == [r[2] for r in want]


def test_emb_matches_the_jax_cli(db, tmp_path):
    """The fused [128 + 64] embedding of every clip and the score rows."""
    jout, pout = _both(["--eval", "--emb"] + _common(db), tmp_path, "emb")
    _rows_close(_rows(os.path.join(pout, "scores.txt")),
                _rows(os.path.join(jout, "scores.txt")), (1, 2))
    for u in db[3]:
        stem = os.path.splitext(u)[0]
        got, want = (np.load(os.path.join(d, f"{stem}.npy")) for d in (pout, jout))
        assert got.shape == want.shape == (192,)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=u)


def test_long_audio_rows_match_the_jax_cli(db, tmp_path):
    jout, pout = _both(["--eval", "--long_audio"] + _common(db), tmp_path, "long")
    got = _rows(pout)
    assert [r[0] for r in got] == db[3]
    _rows_close(got, _rows(jout), (1, 2))


def test_resume_eval_rows_match_the_jax_cli(db, evaluated, tmp_path):
    """A file cut after one row and half of the next: both CLIs keep the
    row and score the rest alike."""
    with open(evaluated[1]) as f:
        lines = f.read().splitlines(keepends=True)
    cut = lines[0] + lines[1][: len(lines[1]) // 2]

    def torn(out):
        with open(out, "w") as f:
            f.write(cut)

    jout, pout = _both(["--eval", "--resume_eval"] + _common(db), tmp_path, "resume",
                       before=torn)
    got = _rows(pout)
    with open(pout) as f:
        assert f.read().startswith(lines[0])
    assert sorted(r[0] for r in got) == sorted(db[3])
    _rows_close(got, _rows(jout), (1, 2))


def test_serve_replies_match_the_jax_cli(db, monkeypatch, capsys):
    root, _, _, evals = db
    lines = [f"id{i}\t{root / 'eval' / u}" for i, u in enumerate(evals)] + ["m\tmissing.wav"]
    replies = []
    for main, dev in ((jax_main, []), (port_main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO("".join(ln + "\n" for ln in lines)))
        assert main(["--serve", "--serve_batch", "2"] + _common(db) + dev) == 0
        out = capsys.readouterr().out.splitlines()
        replies.append([ln.split("\t") for ln in out if not ln.startswith("loaded checkpoint")])
    want, got = replies
    assert [r[0] for r in got] == [r[0] for r in want] == ["id0", "id1", "id2", "id3", "m"]
    assert got[4][1].startswith("ERROR") and want[4][1].startswith("ERROR")
    np.testing.assert_allclose([float(r[1]) for r in got[:4]], [float(r[1]) for r in want[:4]],
                               atol=1e-5, rtol=0)


def test_serve_http_answers_like_the_jax_cli(db, monkeypatch):
    """``--serve_http``: ``/score`` and ``/score_batch`` (one missing file
    among them) and the client errors, as the JAX CLI's server answers
    them, through the harness of ``tests/test_torch_serving.py``."""
    import test_torch_serving as S

    root, _, _, evals = db
    files = {u: str(root / "eval" / u) for u in evals}
    files["missing.wav"] = str(root / "missing.wav")
    argv = _common(db) + ["--serve_http", "0", "--serve_batch", "2"]
    answers = {}
    for side in ("jax", "port"):
        with S._Running(S._cli_server(monkeypatch, side, argv)) as run:
            answers[side] = S._http_session(run.base, files)
    S._close(answers["port"], answers["jax"])
    assert answers["port"][0][0] == 200


def test_show_params_prints_the_jax_table_for_conf5(capsys):
    argv = ["--show_params", "--ssl_preset", "tiny", "--config", CONF5]
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert port_main(argv) == 0  # no --device cpu: the table touches no device
    got = capsys.readouterr().out
    assert got == want and "bio_emb" in got and "rel_k" in got


def _train(db, tmp_path, main, extra=()):
    root, cfgs, _, _ = db
    out = tmp_path / "runs"
    dev = ["--device", "cpu"] if main is port_main else []
    argv = ["--config", cfgs["transformer"], "--database_path", str(root),
            "--out_dir", str(out), "--ssl_preset", "tiny", "--compute_dtype", "float32",
            "--batch_size", "2", "--num_epochs", "1", "--num_workers", "1", *dev, *extra]
    assert main(argv) == 0
    return out / os.listdir(out)[0]


def test_training_cli_state_is_read_in_either_direction(db, tmp_path, capsys):
    """The port's training CLI writes a ``last.ckpt`` that the JAX package
    loads as a train state and scores from as the port does; the JAX CLI
    writes one that the port's CLI resumes at the next epoch."""
    from scl_deepfake_audio_detection_tpu.models.btse import XLSRBtse as JBtse
    from scl_deepfake_audio_detection_tpu.models.xlsr import XLSRConfig as JXLSRConfig
    from scl_deepfake_audio_detection_tpu.train.engine import Engine as JEngine
    from scl_deepfake_audio_detection_tpu.utils.config import TrainConfig as JTrainConfig

    run = _train(db, tmp_path / "port", port_main)
    last = str(run / "last.ckpt")
    tree, extra = jckpt.load(last)
    assert extra["epoch"] == 0 and "opt_state_leaves" in tree and "buffers" not in tree
    _, _, tmpl = JEngine(JBtse(ssl=JXLSRConfig.tiny()), JTrainConfig()).init_state(
        jax.random.key(0))
    p, _, _, epoch, _, _ = jckpt.load_train_state(last, tmpl)
    assert epoch == 0
    for (k, v), (_, w) in zip(_flat(p), _flat(tree["params"])):
        np.testing.assert_array_equal(np.asarray(v), w, err_msg=k)
    argv = ["--eval", "--model_path", last] + _common(db)[:4] + _common(db)[6:]
    jout, pout = _both(argv, tmp_path, "trained")
    _rows_close(_rows(pout), _rows(jout), (1, 2))

    jrun = _train(db, tmp_path / "jax", jax_main)
    jlast = str(jrun / "last.ckpt")
    capsys.readouterr()
    _train(db, tmp_path / "jax", port_main, ["--model_path", jlast])
    assert "resuming full train state at epoch 1" in capsys.readouterr().out
    assert jckpt.load(jlast)[1]["epoch"] == 1


def test_average_ckpts_prints_the_jax_line(db, tmp_path, capsys):
    a = db[2]["transformer"]
    b = str(tmp_path / "b.ckpt")
    tree, _ = jckpt.load(a)
    jckpt.save(b, jax.tree.map(lambda x: 0.5 * x, tree))
    outs = []
    for side, main in (("jax", jax_main), ("port", port_main)):
        o = str(tmp_path / f"avg_{side}.ckpt")
        assert main(["--average_ckpts", f"{a},{b}", "--avg_out", o]) == 0
        outs.append((o, capsys.readouterr().out.replace(o, "OUT")))
    assert outs[0][1] == outs[1][1]
    with np.load(outs[0][0]) as jz, np.load(outs[1][0]) as pz:
        keys = [k for k in jz.files if k != "__scl_meta__"]
        assert sorted(keys) == sorted(k for k in pz.files if k != "__scl_meta__")
        assert "params//bio_emb//w" in keys
        for k in keys:
            np.testing.assert_array_equal(pz[k], jz[k], err_msg=k)


def test_export_verify_and_score_from_the_artifact(db, evaluated, tmp_path, capsys):
    """``--export_model``, ``--verify_export`` and ``--eval --from_export``:
    the artifact's rows within 1e-4 of ``--eval``'s; its leaves are the
    JAX tree's (the token table untransposed)."""
    root, cfgs, ckpts, _ = db
    common = _common(db) + ["--device", "cpu"]
    art = str(tmp_path / "art")
    assert port_main(common + ["--export_model", art]) == 0
    capsys.readouterr()
    assert port_main(common + ["--verify_export", art]) == 0
    assert "(OK, tol" in capsys.readouterr().out
    ref, got = evaluated[1], str(tmp_path / "art.txt")
    assert port_main(["--eval", "--eval_output", got, "--from_export", art,
                      "--config", cfgs["transformer"], "--database_path", str(root),
                      "--device", "cpu", "--num_workers", "1"]) == 0
    assert [r[0] for r in _rows(got)] == db[3]
    for c in (1, 2):
        np.testing.assert_allclose([float(r[c]) for r in _rows(got)],
                                   [float(r[c]) for r in _rows(ref)], atol=1e-4, rtol=0)
    params = jckpt.load(ckpts["transformer"])[0]["params"]
    with np.load(os.path.join(art, "weights.npz")) as z:
        leaves = [z[k] for k in sorted(z.files) if k.startswith("p")]
    want = jax.tree.leaves(params)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("enc", ["gru", "conv", "light"])
def test_other_bio_encoders_eval_rows_match_the_jax_cli(db, tmp_path, enc):
    jout, pout = _both(["--eval"] + _common(db, enc), tmp_path, enc)
    _rows_close(_rows(pout), _rows(jout), (1, 2))
