"""The port's training CLI vs the JAX CLI, on the CPU at the tiny preset.

- both parsers give the same default for every flag of the JAX CLI;
- ``python -m scl_deepfake_audio_detection_torch.cli`` (no mode flag)
  trains the tiny preset for an epoch on a mini SCL database in the fixture
  pattern of ``tests/test_cli_e2e.py``, writes ``last.ckpt``,
  ``epoch_*.ckpt``, ``metrics.jsonl``, tensorboard scalars and a
  ``--profile_dir`` trace, and a second run resumes from ``last.ckpt`` at
  the next epoch;
- the JAX package reads the port's ``last.ckpt``, and the JAX ``--eval`` and
  the port's ``--eval`` score it within 1e-4 (fp32, summation order only);
- ``--show_params`` prints the JAX CLI's table;
- the flags that pinned later slices run their modes (``--distill_from``
  exits as the JAX CLI does; ``--multihost``, ``--mesh``, ``--zero1`` run
  as on one host), and without ``--device cpu`` and without a card the CLI
  exits 1 saying so.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
EVAL_ATOL = 1e-4  # as tests/test_golden_pipeline.py
TRAIN = ["--ssl_preset", "tiny", "--compute_dtype", "float32", "--batch_size", "2",
         "--num_epochs", "1", "--seed", "7", "--num_workers", "2", "--early_metric", "eer",
         "--device", "cpu"]


@pytest.fixture(scope="module")
def mini_db(tmp_path_factory):
    """Six anchors with one vocoded copy each, eval audio, a noise and a RIR
    file, the scp lists, and a conf-3 config cut to 4000 samples."""
    root = tmp_path_factory.mktemp("port_cli_db")
    rng = np.random.default_rng(0)
    utts = [f"u{i}.wav" for i in range(6)]
    for u in utts:
        n = int(rng.integers(3000, 6000))  # both sides of the 4000-sample trim
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
    cfg = root / "tiny_conf3.yaml"
    cfg.write_text(f"""
model:
  name: wav2vec2_linear_nll
  flag_fix_ssl: false
  contra_mode: 'all'
  loss_type: 1
data:
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
""")
    return root, str(cfg), utts


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def trained(mini_db, tmp_path_factory):
    """One epoch, then one more resumed from last.ckpt."""
    root, cfg, _ = mini_db
    out = tmp_path_factory.mktemp("port_cli_out")
    prof = out / "prof"
    common = ["--config", cfg, "--database_path", str(root), "--out_dir", str(out / "runs"),
              *TRAIN]
    rc1, log1 = _run(common + ["--profile_dir", str(prof)])
    run_dir = out / "runs" / os.listdir(out / "runs")[0]
    rc2, log2 = _run(common + ["--model_path", str(run_dir / "last.ckpt")])
    return {"rc": (rc1, rc2), "log": (log1, log2), "run_dir": run_dir, "prof": prof}


def test_both_parsers_give_the_same_defaults():
    from scl_deepfake_audio_detection_tpu.cli.flags import build_parser as jax_parser
    from scl_deepfake_audio_detection_torch.cli.flags import build_parser

    mine = {a.dest: a.default for a in build_parser()._actions}
    ref = {a.dest: a.default for a in jax_parser()._actions}
    assert set(mine) == set(ref) | {"device"} and len(ref) == 104  # 103 flags and --help
    assert {k: mine[k] for k in ref} == ref
    assert mine["device"] == "cuda"


def test_cli_trains_an_epoch_and_writes_its_outputs(trained):
    assert trained["rc"] == (0, 0), trained["log"]
    log = trained["log"][0]
    for line in ("no. of training trials 4", "no. of validation trials 2",
                 "model tag: model_weighted_CCE_1_2_1e-08", "epoch 0: lr=1e-08",
                 "Total training time:"):
        assert line in log, log
    names = os.listdir(trained["run_dir"])
    assert {"last.ckpt", "metrics.jsonl", "logs"} <= set(names)
    assert any(n.startswith("epoch_") and n.endswith(".ckpt") for n in names)
    rec = json.loads((trained["run_dir"] / "metrics.jsonl").read_text().splitlines()[0])
    assert rec["epoch"] == 0
    assert all(np.isfinite(v) for k, v in rec.items() if isinstance(v, float)), rec


def test_cli_resumes_from_last_ckpt_at_the_next_epoch(trained):
    log = trained["log"][1]
    assert "resuming full train state at epoch 1" in log, log
    assert "epoch 1: lr=" in log and "epoch 0:" not in log
    recs = [json.loads(ln) for ln in
            (trained["run_dir"] / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [0, 1]


def test_cli_writes_scalars_and_a_profile_trace(trained):
    from scl_deepfake_audio_detection_torch.train.tblog import tensorboard_available

    if tensorboard_available():
        assert "tensorboard scalars: " + str(trained["run_dir"] / "logs") in trained["log"][0]
        assert any(n.startswith("events.out.tfevents")
                   for n in os.listdir(trained["run_dir"] / "logs"))
    else:
        assert "tensorboard scalars: not written" in trained["log"][0]
    traces = [n for n in os.listdir(trained["prof"]) if n.endswith(".json")]
    assert len(traces) == 1
    with open(trained["prof"] / traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_jax_reads_the_ports_last_ckpt_and_both_evals_agree(trained, mini_db, tmp_path):
    from scl_deepfake_audio_detection_tpu.cli import main as jax_main
    from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.utils.tree import flatten

    root, cfg, utts = mini_db
    last = str(trained["run_dir"] / "last.ckpt")
    (jtree, jextra), (tree, _) = jckpt.load(last), ckpt.load(last)
    assert jextra["epoch"] == 1
    jflat, flat = flatten(jtree["params"]), flatten(tree["params"])
    assert sorted(jflat) == sorted(flat) and len(flat) == 46
    for k in flat:
        np.testing.assert_array_equal(jflat[k], flat[k])
    common = ["--config", cfg, "--database_path", str(root), "--eval", "--model_path", last,
              "--ssl_preset", "tiny", "--compute_dtype", "float32", "--batch_size", "2",
              "--num_workers", "1"]
    jout, pout = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    assert jax_main(common + ["--eval_output", jout]) == 0
    assert port_main(common + ["--eval_output", pout, "--device", "cpu"]) == 0
    want = [ln.split() for ln in open(jout)]
    got = [ln.split() for ln in open(pout)]
    assert [r[0] for r in got] == [r[0] for r in want] == utts
    np.testing.assert_allclose(np.array([r[1:] for r in got], float),
                               np.array([r[1:] for r in want], float), atol=EVAL_ATOL, rtol=0)


def test_show_params_prints_the_jax_table(mini_db, capsys):
    from scl_deepfake_audio_detection_tpu.cli import main as jax_main

    _, cfg, _ = mini_db
    argv = ["--show_params", "--ssl_preset", "tiny", "--config", cfg]
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert port_main(argv) == 0  # no --device cpu: the table touches no device
    got = capsys.readouterr().out
    assert got == want and got.startswith("Parameter number: ")


@pytest.mark.parametrize("argv,where", [
    (["--eval", "--predict", "--config", os.path.join(REPO, "configs", "conf-5-btse-trans64.yaml")],
     "Slice G"),
    (["--config", os.path.join(REPO, "configs", "conf-5-btse-trans64.yaml")], "Slice G"),
    (["--serve", "--config", os.path.join(REPO, "configs", "conf-5-btse-trans64.yaml")], "Slice G"),
    (["--distill_from", "t.pth"], "Slice H"), (["--eval", "--multihost"], "Slice H"),
    (["--serve", "--mesh", "2,1"], "Slice H"),
    (["--distill_from", "t.ckpt"], "Slice H"), (["--multihost"], "Slice H"),
    (["--mesh", "1,1"], "Slice H"), (["--zero1"], "Slice H"),
])
def test_later_slice_flags_exit_2(argv, where, capsys, mini_db, tmp_path, monkeypatch,
                                  request):
    """Every flag is ported now; the cases that exited 2 before their slice
    was ported run their mode.  The BTSE config of Slice G2 runs each mode
    on ``mini_db`` at conf-5's model: ``--eval --predict`` writes a row per
    utterance, training writes ``last.ckpt``, ``--serve`` replies.
    ``--distill_from`` (Slice H1): with a ``.pth`` and a ``.ckpt`` teacher
    of the tiny preset and conf-aasist's model as the student on
    ``mini_db``, the port exits as the JAX CLI does (2, a batch-norm
    student), with the JAX CLI's stderr (``tests/test_torch_distill_cli.py``
    distils).  ``--multihost``, ``--mesh`` and ``--zero1`` (Slice H2) run
    as the JAX CLI runs them on one host of one device: ``--multihost``
    with no cluster prints the JAX CLI's notice and scores or trains as
    one process, ``--mesh 1,1`` trains in a process group of one,
    ``--zero1`` over one data rank splits nothing, so the three training
    runs give the plain run's ``last.ckpt``; ``--serve --mesh 2,1`` splits
    each batch over two replicas and replies as ``--serve``
    (``tests/test_torch_parallel_cli.py`` runs them over ranks)."""
    flags = ["--device", "cpu", "--ssl_preset", "tiny"]
    if where == "Slice H" and "--distill_from" not in argv:
        _run_on_one_host(argv, flags, capsys, mini_db, tmp_path, monkeypatch, request)
        return
    if "--distill_from" in argv:
        from scl_deepfake_audio_detection_tpu.cli import main as jax_main
        from scl_deepfake_audio_detection_torch.models import convert
        from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
        from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
        from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt

        import seeded_params

        root, cfg, _ = mini_db
        monkeypatch.chdir(tmp_path)  # the teacher's relative path
        tree = seeded_params.seeded_tree(LinearNLL(ssl=XLSRConfig.tiny(), device="meta"), 1)
        convert.save_reference_checkpoint(tree, "t.pth")
        pckpt.save("t.ckpt", {"params": tree})
        aasist = tmp_path / "aasist.yaml"
        with open(os.path.join(REPO, "configs", "conf-aasist.yaml")) as f:
            model = f.read().split("\ndata:", 1)[0]
        with open(cfg) as f:
            aasist.write_text(model + "\ndata:" + f.read().split("\ndata:", 1)[1])
        run = argv + ["--ssl_preset", "tiny", "--teacher_preset", "tiny", "--config",
                      str(aasist), "--database_path", str(root), "--out_dir", "out"]
        capsys.readouterr()
        rc = jax_main(run)
        want = capsys.readouterr().err
        assert port_main(run + ["--device", "cpu"]) == rc == 2
        err = capsys.readouterr().err
        assert err == want and "carries BN buffers" in err
        return
    if where == "Slice G":
        root, cfg, utts = mini_db
        conf5 = tmp_path / "conf5.yaml"
        with open(argv[-1]) as f:
            model = f.read().split("\ndata:", 1)[0]
        with open(cfg) as f:
            conf5.write_text(model + "\ndata:" + f.read().split("\ndata:", 1)[1])
        run = argv[:-1] + [str(conf5), "--database_path", str(root),
                           "--compute_dtype", "float32"]
        if "--eval" in argv:
            out = tmp_path / "pred.txt"
            assert port_main(run + flags + ["--eval_output", str(out)]) == 0
            assert sorted(ln.split()[0] for ln in open(out)) == sorted(utts)
        elif "--serve" in argv:
            monkeypatch.setattr("sys.stdin", io.StringIO(f"a\t{root}/eval/{utts[0]}\n"))
            assert port_main(run + flags) == 0
            reply = capsys.readouterr().out.strip().split("\t")
            assert reply[0] == "a" and np.isfinite(float(reply[1]))
        else:
            assert port_main(run + flags + ["--num_epochs", "1", "--batch_size", "2",
                                            "--out_dir", str(tmp_path / "out")]) == 0
            assert list((tmp_path / "out").glob("*/last.ckpt"))
        assert "not ported yet" not in capsys.readouterr().err
        return
    assert port_main(argv + flags) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and where in err


@pytest.fixture(scope="module")
def plain_train(mini_db, tmp_path_factory):
    """One plain training run's ``last.ckpt`` parameters."""
    root, cfg, _ = mini_db
    out = tmp_path_factory.mktemp("plain_train")
    rc, _ = _run(["--config", cfg, "--database_path", str(root), "--out_dir", str(out), *TRAIN])
    assert rc == 0
    (path,) = out.glob("*/last.ckpt")
    return _ckpt_params(path)


def _ckpt_params(path):
    from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt
    from scl_deepfake_audio_detection_torch.utils.tree import flatten

    return flatten(pckpt.load(str(path))[0]["params"])


def _run_on_one_host(argv, flags, capsys, mini_db, tmp_path, monkeypatch, request):
    root, cfg, utts = mini_db
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    base = ["--config", cfg, "--database_path", str(root), "--compute_dtype", "float32"]
    if "--eval" in argv:
        plain, multi = tmp_path / "plain.txt", tmp_path / "multi.txt"
        assert port_main(base + flags + ["--eval", "--eval_output", str(plain)]) == 0
        capsys.readouterr()
        assert port_main(base + flags + argv + ["--eval_output", str(multi)]) == 0
        assert "--multihost: no cluster detected" in capsys.readouterr().err
        assert open(multi).read() == open(plain).read()
        return
    if "--serve" in argv:
        lines = "".join(f"{u}\t{root}/eval/{u}\n" for u in utts[:2])
        replies = []
        for extra in ([], argv[1:]):
            monkeypatch.setattr("sys.stdin", io.StringIO(lines))
            capsys.readouterr()
            assert port_main(base + flags + ["--serve", "--serve_batch", "2"] + extra) == 0
            replies.append([ln.split("\t") for ln in capsys.readouterr().out.splitlines()
                            if "\t" in ln])
        assert [r[0] for r in replies[1]] == [r[0] for r in replies[0]] == utts[:2]
        np.testing.assert_allclose([float(r[1]) for r in replies[1]],
                                   [float(r[1]) for r in replies[0]], rtol=0, atol=1e-6)
        return
    want = request.getfixturevalue("plain_train")
    out = tmp_path / "out"
    capsys.readouterr()
    rc, _ = _run(["--config", cfg, "--database_path", str(root), "--out_dir", str(out),
                  *TRAIN, *argv])
    assert rc == 0
    if "--multihost" in argv:
        assert "--multihost: no cluster detected" in capsys.readouterr().err
    (path,) = out.glob("*/last.ckpt")
    got = _ckpt_params(path)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_cli_without_a_card_exits_nonzero_and_says_so(mini_db, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root, cfg, _ = mini_db
    assert port_main(["--config", cfg, "--database_path", str(root),
                      "--ssl_preset", "tiny"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_refuses_to_train_from_a_jax_train_state(mini_db, tmp_path):
    """(The name is from when the port refused.)  The port's CLI resumes a
    train state the JAX package wrote, optimizer leaves included: it starts
    at the next epoch with the saved watermark, and the JAX package resumes
    the port's ``last.ckpt`` in turn, with its ``rng`` leaf carried through."""
    import jax

    from scl_deepfake_audio_detection_tpu.models.xlsr import XLSRConfig as JXLSRConfig
    from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
    from scl_deepfake_audio_detection_tpu.train.engine import Engine as JEngine
    from scl_deepfake_audio_detection_tpu.train.optim import set_learning_rate
    from scl_deepfake_audio_detection_tpu.utils.config import TrainConfig as JTrainConfig
    from scl_deepfake_audio_detection_tpu.utils.config import load_config as jload_config
    from scl_deepfake_audio_detection_tpu.utils.registry import MODELS as JMODELS

    root, cfg, _ = mini_db
    jcfg = jload_config(cfg)
    jmodel = JMODELS.get(jcfg.model.name).from_config(
        jcfg.model, ssl=JXLSRConfig.tiny(compute_dtype="float32", remat=True))
    jeng = JEngine(jmodel, JTrainConfig())
    params, _, opt = jeng.init_state(jax.random.key(3))
    opt = set_learning_rate(opt, 1e-6)
    key = jax.random.key(11)
    path = str(tmp_path / "jax_last.ckpt")
    jckpt.save_train_state(path, params, opt, 0, key, 12.5, es_counter=1, es_metric="eer")
    out = tmp_path / "out"
    rc, log = _run(["--config", cfg, "--database_path", str(root), "--model_path", path,
                    "--out_dir", str(out), *TRAIN])
    assert rc == 0, log
    assert "resuming full train state at epoch 1 (best so far 12.5000)" in log, log
    assert "epoch 1: lr=" in log and "epoch 0:" not in log
    last = str(out / os.listdir(out)[0] / "last.ckpt")
    tmpl = jeng.init_state(jax.random.key(0))[2]
    _, _, jopt, epoch, rng, best = jckpt.load_train_state(last, tmpl)
    assert epoch == 1 and best == 12.5
    assert np.array_equal(jax.random.key_data(rng), jax.random.key_data(key))
    assert int(jopt.count) == 2  # two steps after the JAX state's none
