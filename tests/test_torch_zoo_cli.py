"""The AASIST and ResNet back-ends through the port's CLI against the JAX
CLI, on the CPU at ``--ssl_preset tiny``, fp32: ``--eval`` on
``configs/conf-aasist.yaml`` as it is and on a ResNet YAML (the repository
ships none), ``--predict``, ``--emb``, ``--serve`` and ``--serve_http``
replies, the
``--show_params`` table, the training CLI with its ``last.ckpt`` (buffers
included) read back by the JAX package and resumed by the port,
``--average_ckpts``, ``--export_model`` / ``--verify_export`` /
``--from_export``, and the LinearNLL-only modes refused as the JAX CLI
refuses them.

Both CLIs score one database from one checkpoint the JAX package writes
(parameters and running statistics after a train forward).  Rows are held
within 1e-5.  The tiny SSL frontend's stride is 20, so a 64600-sample crop
makes 3229 frames and conf-aasist's temporal graph 1076 nodes: the
published head runs on two utterances, one at a time; ``--predict``,
``--emb`` and ``--serve`` run a narrow AASIST head (``NARROW``), and
training clips are 4000 samples."""

import io
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.cli import main as jax_main
from scl_deepfake_audio_detection_tpu.models.base import model_buffers
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_tpu.utils.config import load_config as jload_config
from scl_deepfake_audio_detection_tpu.utils.registry import MODELS as JMODELS
from scl_deepfake_audio_detection_tpu.models.xlsr import XLSRConfig as JXLSRConfig
from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_cli_eval.py
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AASIST_YAML = os.path.join(REPO, "configs", "conf-aasist.yaml")
ATOL = 1e-5
SR = 16000
DATA = """data:
  name: 'asvspoof_2019_augall_3'
  kwargs:
    vocoders: ['hifigan']
    augmentation_methods: ["RawBoost12", "background_noise_wrapper", "reverb_wrapper"]
    num_additional_real: 1
    trim_length: 4000
    wav_samp_rate: 16000
    online_aug: true
    aug_dir: '{root}/aug'
    noise_path: '{root}/musan'
    rir_path: '{root}/rirs'
"""
RESNET = "model:\n  name: wav2vec2_resnet\n  resnet: {{resnet_type: '18', num_nodes: 3}}\n" + DATA
NARROW = ("model:\n  name: wav2vec2_aasist\n  aasist:\n"
          "    filts: [128, [1, 8], [8, 8], [8, 16], [16, 16]]\n"
          "    gat_dims: [16, 8]\n" + DATA)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """An SCL database: eval clips, six training anchors with a vocoded copy
    each, noise and RIR files; the ResNet and narrow AASIST YAMLs."""
    root = tmp_path_factory.mktemp("zoo_cli")
    rng = np.random.default_rng(0)
    evals = ["e0.wav", "e1.wav", "e2.wav"]
    for i, u in enumerate(evals):
        save_wav(str(root / "eval" / u), (0.1 * rng.normal(size=20000 + 30000 * i))
                 .astype(np.float32), SR)
    anchors = [f"u{i}.wav" for i in range(6)]
    for u in anchors:
        n = int(rng.integers(3000, 6000))
        save_wav(str(root / "bonafide" / u), (0.2 * rng.normal(size=n)).astype(np.float32), SR)
        save_wav(str(root / "vocoded" / f"hifigan_{u}"),
                 (0.2 * rng.normal(size=n)).astype(np.float32), SR)
    save_wav(str(root / "musan" / "n.wav"), (0.1 * rng.normal(size=SR)).astype(np.float32), SR)
    save_wav(str(root / "rirs" / "r.wav"), np.exp(-np.arange(800) / 120.0).astype(np.float32),
             SR)
    os.makedirs(root / "scp")
    (root / "scp" / "train_bonafide.lst").write_text("\n".join(anchors[:4]) + "\n")
    (root / "scp" / "dev_bonafide.lst").write_text("\n".join(anchors[4:]) + "\n")
    (root / "scp" / "test.lst").write_text("\n".join(evals) + "\n")
    cfgs = {"aasist": AASIST_YAML}
    for name, text in (("resnet", RESNET), ("narrow", NARROW)):
        cfgs[name] = str(root / f"{name}.yaml")
        (root / f"{name}.yaml").write_text(text.format(root=root))
    return root, cfgs, evals


def _jax_ckpt(root, cfg_path, name):
    """A params + buffers checkpoint of the config's model, written by the
    JAX package: seeded init, running statistics after a train forward."""
    path = str(root / f"{name}.ckpt")
    if os.path.exists(path):
        return path
    cfg = jload_config(cfg_path)
    jm = JMODELS.get(cfg.model.name).from_config(cfg.model, ssl=JXLSRConfig.tiny())
    params = jax.jit(jm.init)(jax.random.key(3))
    wav = jnp.asarray((0.1 * np.random.default_rng(4).normal(size=(2, 4000))).astype(np.float32))
    _, buffers = jax.jit(lambda p, w: jm.apply(p, w, train=True, buffers=model_buffers(jm),
                                               mutable=True))(params, wav)
    jckpt.save(path, {"params": jax.tree.map(np.asarray, params),
                      "buffers": jax.tree.map(np.asarray, buffers)})
    return path


def _common(db, name):
    root, cfgs, _ = db
    return ["--config", cfgs[name], "--database_path", str(root),
            "--model_path", _jax_ckpt(root, cfgs[name], name), "--ssl_preset", "tiny",
            "--compute_dtype", "float32", "--batch_size", "1", "--num_workers", "1"]


def _both(argv, tmp_path, tag):
    outs = []
    for side, main, dev in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}_{side}")
        assert main(argv + ["--eval_output", out] + dev) == 0, side
        outs.append(out)
    return outs


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f]


def _rows_close(got, want, cols):
    assert [r[0] for r in got] == [r[0] for r in want]
    for c in cols:
        np.testing.assert_allclose([float(r[c]) for r in got], [float(r[c]) for r in want],
                                   atol=ATOL, rtol=0)


def _limit_eval_list(db, n):
    root = db[0]
    lst = root / "scp" / "test.lst"
    keep = lst.read_text()
    lst.write_text("\n".join(db[2][:n]) + "\n")
    return lambda: lst.write_text(keep)


@pytest.mark.parametrize("name", ["aasist", "resnet"])
def test_eval_rows_match_the_jax_cli(db, tmp_path, name):
    """``--eval`` on conf-aasist.yaml as it is (two utterances) and on a
    ResNet-18 YAML: the raw-logit rows of the JAX CLI."""
    restore = _limit_eval_list(db, 2)
    try:
        jout, pout = _both(["--eval"] + _common(db, name), tmp_path, name)
    finally:
        restore()
    got, want = _rows(pout), _rows(jout)
    assert [r[0] for r in got] == db[2][:2]
    _rows_close(got, want, (1, 2))


def test_predict_rows_match_the_jax_cli(db, tmp_path):
    jout, pout = _both(["--eval", "--predict"] + _common(db, "narrow"), tmp_path, "pred")
    got, want = _rows(pout), _rows(jout)
    _rows_close(got, want, (1,))
    assert [r[2] for r in got] == [r[2] for r in want]


def test_emb_matches_the_jax_cli(db, tmp_path):
    jout, pout = _both(["--eval", "--emb"] + _common(db, "narrow"), tmp_path, "emb")
    _rows_close(_rows(os.path.join(pout, "scores.txt")),
                _rows(os.path.join(jout, "scores.txt")), (1, 2))
    for u in db[2]:
        stem = os.path.splitext(u)[0]
        np.testing.assert_allclose(np.load(os.path.join(pout, f"{stem}.npy")),
                                   np.load(os.path.join(jout, f"{stem}.npy")),
                                   atol=ATOL, rtol=0, err_msg=u)


@pytest.mark.parametrize("name", ["narrow", "resnet"])
def test_serve_replies_match_the_jax_cli(db, monkeypatch, capsys, name):
    root, _, evals = db
    lines = [f"id{i}\t{root / 'eval' / u}" for i, u in enumerate(evals)] + ["m\tmissing.wav"]
    replies = []
    for main, dev in ((jax_main, []), (port_main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO("".join(ln + "\n" for ln in lines)))
        assert main(["--serve", "--serve_batch", "2"] + _common(db, name) + dev) == 0
        out = capsys.readouterr().out.splitlines()
        replies.append([ln.split("\t") for ln in out if not ln.startswith("loaded checkpoint")])
    want, got = replies
    assert [r[0] for r in got] == [r[0] for r in want] == ["id0", "id1", "id2", "m"]
    assert got[3][1].startswith("ERROR") and want[3][1].startswith("ERROR")
    np.testing.assert_allclose([float(r[1]) for r in got[:3]], [float(r[1]) for r in want[:3]],
                               atol=ATOL, rtol=0)


def test_serve_http_answers_like_the_jax_cli(db, monkeypatch):
    """``--serve_http``: the JSON of ``/score`` and ``/score_batch`` (one
    missing file among them) and the client errors, as the JAX CLI's
    server answers them (numbers within 1e-5); the harness of
    ``tests/test_torch_serving.py``."""
    import test_torch_serving as S

    root, _, evals = db
    files = {u: str(root / "eval" / u) for u in evals}
    files["missing.wav"] = str(root / "missing.wav")
    argv = _common(db, "narrow") + ["--serve_http", "0", "--serve_batch", "2"]
    answers = {}
    for side in ("jax", "port"):
        with S._Running(S._cli_server(monkeypatch, side, argv)) as run:
            answers[side] = S._http_session(run.base, files)
    S._close(answers["port"], answers["jax"])
    assert answers["port"][0][0] == 200


def test_show_params_prints_the_jax_table_for_conf_aasist(capsys):
    argv = ["--show_params", "--ssl_preset", "tiny", "--config", AASIST_YAML]
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert port_main(argv) == 0  # no --device cpu: the table touches no device
    got = capsys.readouterr().out
    assert got == want and "pos_S" in got and "htrg_st22" in got


def _train(db, tmp_path, extra=()):
    root, cfgs, _ = db
    out = tmp_path / "runs"
    argv = ["--config", cfgs["narrow"], "--database_path", str(root), "--out_dir", str(out),
            "--ssl_preset", "tiny", "--compute_dtype", "float32", "--device", "cpu",
            "--batch_size", "2", "--num_epochs", "1", "--num_workers", "1", *extra]
    assert port_main(argv) == 0
    return out / os.listdir(out)[0]


def test_training_cli_state_resumes_in_either_package(db, tmp_path, capsys):
    """One epoch through the port's training CLI: its ``last.ckpt`` holds
    the moved running statistics, the JAX package loads it as a train
    state, and the port resumes it at the next epoch."""
    from scl_deepfake_audio_detection_tpu.train.engine import Engine as JEngine
    from scl_deepfake_audio_detection_tpu.utils.config import TrainConfig as JTrainConfig

    run = _train(db, tmp_path)
    last = str(run / "last.ckpt")
    tree, extra = jckpt.load(last)
    assert extra["epoch"] == 0 and "buffers" in tree
    assert any(not np.allclose(v, 0.0) for k, v in _flat(tree["buffers"]) if k.endswith("mean"))
    cfg = jload_config(db[1]["narrow"])
    jm = JMODELS.get(cfg.model.name).from_config(cfg.model, ssl=JXLSRConfig.tiny())
    _, _, tmpl = JEngine(jm, JTrainConfig()).init_state(jax.random.key(0))
    p, b, _, epoch, _, _ = jckpt.load_train_state(last, tmpl)
    assert epoch == 0
    for (k, v), (_, w) in zip(_flat(b), _flat(tree["buffers"])):
        np.testing.assert_array_equal(np.asarray(v), w, err_msg=k)
    capsys.readouterr()
    again = _train(db, tmp_path, ["--model_path", last])
    assert again == run
    assert "resuming full train state at epoch 1" in capsys.readouterr().out
    assert jckpt.load(last)[1]["epoch"] == 1


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_average_ckpts_prints_the_jax_line(db, tmp_path, capsys):
    root, cfgs, _ = db
    a = _jax_ckpt(root, cfgs["narrow"], "narrow")
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
        assert any(k.startswith("buffers//") for k in keys)
        for k in keys:
            np.testing.assert_array_equal(pz[k], jz[k], err_msg=k)


def test_export_verify_and_score_from_the_artifact(db, tmp_path, capsys):
    """``--export_model`` (fp and int8), ``--verify_export`` and
    ``--eval --from_export``: the artifact's rows within 1e-5 of
    ``--eval``'s (fp), its buffers bit-equal across the two."""
    root, cfgs, _ = db
    common = _common(db, "narrow") + ["--device", "cpu"]
    arts = {}
    for q in ("fp", "int8"):
        arts[q] = str(tmp_path / f"art_{q}")
        quant = ["--export_quant", "int8"] if q == "int8" else []
        assert port_main(common + ["--export_model", arts[q]] + quant) == 0
    capsys.readouterr()
    assert port_main(common + ["--verify_export", arts["fp"]]) == 0
    assert "(OK, tol" in capsys.readouterr().out
    ref, art = str(tmp_path / "ref.txt"), str(tmp_path / "art.txt")
    assert port_main(["--eval", "--eval_output", ref] + common) == 0
    assert port_main(["--eval", "--eval_output", art, "--from_export", arts["fp"],
                      "--config", cfgs["narrow"], "--database_path", str(root),
                      "--device", "cpu", "--num_workers", "1"]) == 0
    _rows_close(_rows(art), _rows(ref), (1, 2))
    with np.load(os.path.join(arts["fp"], "weights.npz")) as a, \
            np.load(os.path.join(arts["int8"], "weights.npz")) as b:
        bufs = [k for k in a.files if k.startswith("b")]
        assert bufs and all(a[k].tobytes() == b[k].tobytes() for k in bufs)
        assert any(k.startswith("qs") for k in b.files)


@pytest.mark.parametrize("mode", ["export_reference_ckpt", "reference_pth"])
def test_linear_nll_only_modes_are_refused_as_jax_refuses(db, tmp_path, capsys, mode):
    root, cfgs, _ = db
    ckpt = _jax_ckpt(root, cfgs["narrow"], "narrow")
    if mode == "export_reference_ckpt":
        argv = ["--export_reference_ckpt", str(tmp_path / "o.pth"), "--model_path", ckpt]
    else:
        pth = tmp_path / "epoch_0.pth"
        torch.save({"LL.weight": torch.zeros(2, 2)}, pth)
        argv = ["--eval", "--model_path", str(pth)]
    argv += ["--config", cfgs["narrow"], "--database_path", str(root), "--ssl_preset", "tiny"]
    codes, errs = [], []
    for main, dev in ((jax_main, []), (port_main, ["--device", "cpu"])):
        codes.append(main(argv + dev))
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert codes == [2, 2] and errs[0] == errs[1]
