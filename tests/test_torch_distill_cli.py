"""``--distill_from`` through the port's CLI against the JAX package, on the
CPU at the tiny preset, on a mini SCL database in the fixture pattern of
``tests/test_torch_cli_train.py``.

- with a ``.ckpt`` teacher, the port's ``student_last.ckpt`` equals the JAX
  package's ``DistillEngine`` driven over the same batches (the ones the
  port's CLI drew) at the learning rate the port's CLI sets for the epoch,
  and its ``extra`` keys and epoch line equal the JAX CLI's;
- the stated difference: the JAX CLI sets no learning rate, so its
  student is its initial parameters; the port's moved;
- a reference ``.pth`` teacher (written by the port's ``.pth`` writer from
  the same parameters) distils to the same student;
- the student scores through ``--eval --model_path``;
- a batch-norm student exits 2 with the JAX package's message.

The JAX CLI runs once.  Both students start from one ``--model_path``
checkpoint; the port's student runs with head dropout 0 (the two packages
draw their masks from different generators), as the JAX engine it is held
to.  Tolerances: the metrics of the epoch rtol 1e-5 / atol 1e-5 (fp32,
summation order); the parameters rtol 1e-5 / atol 1e-5, except entries
whose AdamW first moment is zero up to rounding (the attention key bias),
which AdamW moves by up to a step either way and which are held within two
steps, as ``tests/test_torch_zoo.py``."""

import contextlib
import glob
import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.cli import main as jax_main
from scl_deepfake_audio_detection_tpu.models.aasist import XLSRAasist as JAasist
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.models.xlsr import XLSRConfig as JXC
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_tpu.train import distill as JD
from scl_deepfake_audio_detection_tpu.train.optim import cyclic_exp_lr as jcyclic_exp_lr
from scl_deepfake_audio_detection_tpu.train.optim import set_learning_rate as jset_lr
from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.models import convert
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.params import from_jax
from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt
from scl_deepfake_audio_detection_torch.train import distill as PD
from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

import zoo_pins
from seeded_params import seeded_tree

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_cli_eval.py
torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
MIN_LR, MAX_LR = 1e-4, 1e-3  # the rate of epoch 0 is MIN_LR
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def mini_db(tmp_path_factory):
    """Four train and two dev anchors with one vocoded copy each, eval
    audio, a noise and a RIR file, the scp lists, a conf-3 config cut to
    4000 samples, a tiny teacher ``.ckpt`` and the students' first
    parameters as a ``.ckpt``."""
    root = tmp_path_factory.mktemp("distill_db")
    rng = np.random.default_rng(3)
    utts = [f"u{i}.wav" for i in range(6)]
    for u in utts:
        n = int(rng.integers(3000, 6000))
        save_wav(str(root / "bonafide" / u), rng.normal(size=n).astype(np.float32) * 0.2, SR)
        save_wav(str(root / "vocoded" / f"hifigan_{u}"),
                 rng.normal(size=n).astype(np.float32) * 0.2, SR)
        save_wav(str(root / "eval" / u), rng.normal(size=n).astype(np.float32) * 0.2, SR)
    save_wav(str(root / "musan" / "n.wav"), rng.normal(size=SR).astype(np.float32) * 0.1, SR)
    save_wav(str(root / "rirs" / "r.wav"), np.exp(-np.arange(800) / 120.0).astype(np.float32), SR)
    os.makedirs(root / "scp")
    (root / "scp" / "train_bonafide.lst").write_text("\n".join(utts[:4]) + "\n")
    (root / "scp" / "dev_bonafide.lst").write_text("\n".join(utts[4:]) + "\n")
    (root / "scp" / "test.lst").write_text("\n".join(utts) + "\n")
    data = f"""data:
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
    (root / "tiny_conf3.yaml").write_text(
        "model:\n  name: wav2vec2_linear_nll\n  flag_fix_ssl: false\n  contra_mode: 'all'\n"
        "  loss_type: 1\n" + data)
    with open(os.path.join(REPO, "configs", "conf-aasist.yaml")) as f:
        aasist_model = f.read().split("\ndata:", 1)[0]
    (root / "tiny_aasist.yaml").write_text(aasist_model + "\n" + data)
    shapes = LinearNLL(ssl=XLSRConfig.tiny(), device="meta")  # the CLI's head, emb 128
    jckpt.save(str(root / "teacher.ckpt"), {"params": seeded_tree(shapes, 42)})
    jckpt.save(str(root / "student0.ckpt"), {"params": seeded_tree(shapes, 43)})
    return root, utts


def _argv(root, teacher, out):
    return ["--distill_from", str(teacher), "--teacher_preset", "tiny", "--ssl_preset", "tiny",
            "--compute_dtype", "float32", "--config", str(root / "tiny_conf3.yaml"),
            "--database_path", str(root), "--model_path", str(root / "student0.ckpt"),
            "--num_epochs", "1", "--batch_size", "2", "--seed", "7", "--num_workers", "2",
            "--min_lr", str(MIN_LR), "--max_lr", str(MAX_LR), "--distill_emb_w", "0.1",
            "--out_dir", str(out)]


def _captured(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _port_distill(argv):
    """The port's CLI with head dropout 0 in the student; returns (rc,
    stdout, stderr, the batches each epoch saw as numpy)."""
    seen = []
    from_config, run_epoch = LinearNLL.from_config.__func__, PD.DistillEngine.run_epoch

    def no_dropout(cls, model_cfg, ssl=None, **kw):
        return from_config(cls, model_cfg, ssl=ssl, dropout=0.0, **kw)

    def recorded(self, batches, epoch=0):
        batches = [{k: v for k, v in b.items() if k != "utts"} for b in batches]
        seen.append(batches)
        return run_epoch(self, batches, epoch)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(LinearNLL, "from_config", classmethod(no_dropout))
        mp.setattr(PD.DistillEngine, "run_epoch", recorded)
        rc, out, err = _captured(port_main, argv + ["--device", "cpu"])
    return rc, out, err, seen


def _student(out_dir):
    (path,) = glob.glob(os.path.join(str(out_dir), "*", "student_last.ckpt"))
    return path, pckpt.load(path)


@pytest.fixture(scope="module")
def runs(mini_db, tmp_path_factory):
    """The port's CLI with the ``.ckpt`` teacher, the JAX CLI with the same
    argv, and the JAX ``DistillEngine`` over the batches the port drew."""
    root, _ = mini_db
    tmp = tmp_path_factory.mktemp("distill_runs")
    port = _port_distill(_argv(root, root / "teacher.ckpt", tmp / "port"))
    jcli = _captured(jax_main, _argv(root, root / "teacher.ckpt", tmp / "jax"))

    teacher = JLinearNLL(ssl=JXC.tiny(compute_dtype="float32"))
    student = JLinearNLL(ssl=JXC.tiny(compute_dtype="float32"), dropout=0.0)
    eng = JD.DistillEngine(teacher, student, JD.DistillConfig(emb_loss_weight=0.1))
    t_params = jckpt.load(str(root / "teacher.ckpt"))[0]["params"]
    s0 = jckpt.load(str(root / "student0.ckpt"))[0]["params"]
    sp, opt, tp, tb = eng.init_state(jax.random.key(0), t_params, student_params=s0)
    opt = jset_lr(opt, jcyclic_exp_lr(0, MIN_LR, MAX_LR))
    (batches,) = port[3]
    sp, opt, metrics = eng.run_epoch(sp, opt, tp, batches, jax.random.key(1), teacher_buffers=tb)
    found = [s.mu for s in jax.tree.leaves(opt, is_leaf=lambda x: hasattr(x, "mu"))
             if hasattr(s, "mu")]
    return {"port": port, "port_dir": tmp / "port", "jax_cli": jcli, "jax_dir": tmp / "jax",
            "engine": (jax.tree.map(np.asarray, sp), jax.tree.map(np.asarray, found[0]),
                       {k: float(v) for k, v in metrics.items()}),
            "s0": s0, "batches": batches}


def _epoch_keys(stdout):
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith("epoch 0: ")]
    return [kv.split("=")[0] for kv in line.split()[2:-1]]


def test_port_student_matches_the_jax_engine(runs):
    rc, out, err, _ = runs["port"]
    assert rc == 0, err
    _, (tree, extra) = _student(runs["port_dir"])
    want_p, want_mu, want_m = runs["engine"]
    assert len(runs["batches"]) == 2  # 4 train anchors in groups of 2
    assert runs["batches"][0]["wav"].shape == (2, 7, 4000)  # V = 7 with one vocoder
    assert extra["epoch"] == 0 and sorted(extra) == sorted(["epoch", *want_m])
    for k, v in want_m.items():
        np.testing.assert_allclose(extra[k], v, **TOL, err_msg=k)
    model = LinearNLL(ssl=XLSRConfig.tiny(), device="meta")
    got, want = from_jax(tree["params"], model), from_jax(want_p, model)
    mu = from_jax(want_mu, model)
    tol = zoo_pins.grad_tolerance(mu)
    for name in want:
        either_way = mu[name].double().abs() <= tol[name]
        diff = (got[name] - want[name]).abs()
        if bool(either_way.any()):
            assert float(diff[either_way].max()) <= 2.0001 * MIN_LR, name
        np.testing.assert_allclose(got[name][~either_way].numpy(),
                                   want[name][~either_way].numpy(), **TOL, err_msg=name)


def test_port_cli_prints_and_saves_what_the_jax_cli_does(runs):
    rc, out, err, _ = runs["port"]
    jrc, jout, jerr = runs["jax_cli"]
    assert rc == jrc == 0, (err, jerr)
    assert _epoch_keys(out) == _epoch_keys(jout)
    assert "Total distillation time:" in out and "--ssl_preset tiny" in out
    _, (_, extra) = _student(runs["port_dir"])
    _, (_, jextra) = _student(runs["jax_dir"])
    assert sorted(extra) == sorted(jextra)


def test_jax_cli_student_stays_at_its_initial_parameters_the_port_s_moves(runs):
    """The stated difference (ROADMAP.md §3): the JAX CLI never sets a
    learning rate, AdamW runs at 0, and its ``student_last.ckpt`` is the
    student it started from; the port's CLI sets the epoch's rate."""
    s0 = runs["s0"]
    _, (jtree, _) = _student(runs["jax_dir"])
    jax.tree.map(np.testing.assert_array_equal, jtree["params"], s0)
    _, (tree, _) = _student(runs["port_dir"])
    moved = jax.tree.leaves(jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                                         tree["params"], s0))
    assert max(moved) > 0.5 * MIN_LR


def test_reference_pth_teacher_distils_to_the_same_student(mini_db, runs, tmp_path):
    """The teacher as a reference ``epoch_N.pth`` (the port's writer): its
    positional conv comes back within one fp32 ulp through weight norm, so
    the student lands within the parameter tolerance of the ``.ckpt`` run's."""
    root, _ = mini_db
    pth = tmp_path / "teacher.pth"
    convert.save_reference_checkpoint(jckpt.load(str(root / "teacher.ckpt"))[0]["params"],
                                      str(pth))
    rc, _, err, _ = _port_distill(_argv(root, pth, tmp_path / "out"))
    assert rc == 0, err
    _, (tree, extra) = _student(tmp_path / "out")
    _, (want, want_extra) = _student(runs["port_dir"])
    for k in want_extra:
        np.testing.assert_allclose(extra[k], want_extra[k], **TOL, err_msg=k)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **TOL), tree["params"],
                 want["params"])


def test_student_scores_through_eval(mini_db, runs, tmp_path):
    root, utts = mini_db
    path, _ = _student(runs["port_dir"])
    out = tmp_path / "scores.txt"
    rc, _, err = _captured(port_main, [
        "--eval", "--model_path", path, "--ssl_preset", "tiny", "--compute_dtype", "float32",
        "--config", str(root / "tiny_conf3.yaml"), "--database_path", str(root),
        "--batch_size", "2", "--eval_output", str(out), "--device", "cpu"])
    assert rc == 0, err
    rows = [ln.split() for ln in open(out)]
    assert sorted(r[0] for r in rows) == sorted(utts)
    assert np.isfinite(np.array([r[1:] for r in rows], float)).all()


def test_batch_norm_student_exits_2_with_the_jax_message(mini_db, tmp_path):
    root, _ = mini_db
    argv = _argv(root, root / "teacher.ckpt", tmp_path / "out")
    argv[argv.index("--config") + 1] = str(root / "tiny_aasist.yaml")
    argv.remove("--model_path")
    argv.remove(str(root / "student0.ckpt"))
    rc, _, err = _captured(port_main, argv + ["--device", "cpu"])
    with pytest.raises(ValueError) as want:
        JD.DistillEngine(JLinearNLL(ssl=JXC.tiny()), JAasist(ssl=JXC.tiny()))
    assert rc == 2 and err.strip() == str(want.value)
    assert not glob.glob(str(tmp_path / "out" / "*" / "student_last.ckpt"))
