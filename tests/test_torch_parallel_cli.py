"""The port's CLI over ranks, on a mini SCL database at the tiny preset,
fp32, on the CPU (gloo):

- ``--mesh 2,1`` training: two ranks (``tests/torch_parallel_ranks.cli_rank``,
  the LinearNLL head's dropout 0, since the packages draw other masks)
  against the JAX CLI's ``--mesh 2,1`` on two of the conftest's virtual
  devices: ``last.ckpt``'s parameters within 1e-5 and AdamW's moments
  within 5e-4 of each leaf's largest (the attention key bias, whose true
  gradient is 0, held to its bound);
- ``--mesh 2,1`` started by the CLI itself, with the head's dropout on,
  against one process: the masks do not depend on the split;
- ``--multihost`` over two ranks: each rank's loaders take its shard, the
  ranks print the same epoch lines, and rank 0 alone writes;
- ``--multihost --eval`` over two ranks: ``<out>.part0`` and ``.part1``
  (and a decode cache per part) whose rows together are the one-process
  rows to 6 decimals;
- ``--multihost`` with no cluster: the JAX CLI's notice, then the
  one-process rows; an incomplete cluster environment exits 2."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax

from scl_deepfake_audio_detection_tpu.cli import main as jax_main
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.utils.audio_io import save_wav
from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.parallel import mesh as M
from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt
from scl_deepfake_audio_detection_torch.utils.tree import flatten

import torch_parallel_ranks as R

torch.set_num_threads(2)
SR = 16000
TRAIN = ["--ssl_preset", "tiny", "--compute_dtype", "float32", "--batch_size", "2",
         "--num_epochs", "1", "--seed", "7", "--num_workers", "1"]


@pytest.fixture(scope="module")
def mini_db(tmp_path_factory):
    """Six anchors (four train, two dev) with one vocoded copy each, eval
    audio, noise and RIR files, and a conf-3 config cut to 4000 samples."""
    root = tmp_path_factory.mktemp("par_cli_db")
    rng = np.random.default_rng(0)
    utts = [f"u{i}.wav" for i in range(6)]
    for u in utts:
        n = int(rng.integers(3000, 6000))
        save_wav(str(root / "bonafide" / u), rng.normal(size=n).astype(np.float32) * 0.2, SR)
        save_wav(str(root / "vocoded" / f"hifigan_{u}"),
                 rng.normal(size=n).astype(np.float32) * 0.2, SR)
        save_wav(str(root / "eval" / u), rng.normal(size=n).astype(np.float32) * 0.2, SR)
    save_wav(str(root / "musan" / "n.wav"), rng.normal(size=SR).astype(np.float32) * 0.1, SR)
    save_wav(str(root / "rirs" / "r.wav"), np.exp(-np.arange(800) / 120.0).astype(np.float32),
             SR)
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


def _train_argv(mini_db, out):
    root, cfg, _ = mini_db
    return ["--config", cfg, "--database_path", str(root), "--out_dir", str(out), *TRAIN]


def _eval_argv(mini_db, out):
    root, cfg, _ = mini_db
    return ["--eval", "--config", cfg, "--database_path", str(root), "--eval_output", str(out),
            "--ssl_preset", "tiny", "--compute_dtype", "float32", "--batch_size", "2",
            "--num_workers", "1", "--seed", "3", "--device", "cpu"]


def _last(out):
    (run,) = os.listdir(out)
    return os.path.join(out, run), pckpt.load(os.path.join(out, run, "last.ckpt"))[0]


def _beside_ranks(args, work):
    """``R.cli_rank(*args)`` on two spawned ranks while ``work()`` runs in
    this process (the ranks' processes take their own cores); both must
    succeed."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(M.launch, R.cli_rank, 2, args=args, threads=1, timeout=240)
        try:
            work()
        finally:
            codes = ranks.result()
    assert codes == [0, 0]


def _rows(path):
    with open(path) as f:
        return sorted(ln.split() for ln in f if ln.strip())


def test_mesh_training_matches_the_jax_cli(mini_db, tmp_path, monkeypatch):
    """Both CLIs start from one parameter checkpoint (their seeded inits
    differ)."""
    from scl_deepfake_audio_detection_torch.models import xlsr as PX
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.params import to_jax

    init = str(tmp_path / "init.ckpt")
    pckpt.save(init, {"params": to_jax(LinearNLL(ssl=PX.XLSRConfig.tiny(), device="cpu",
                                                 seed=11))})
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    argv = _train_argv(mini_db, port_out) + ["--device", "cpu", "--mesh", "2,1",
                                             "--model_path", init]
    os.makedirs(tmp_path / "logs")
    devices = jax.devices()
    build = JLinearNLL.from_config.__func__

    def no_dropout(cls, model_cfg, ssl=None):
        import dataclasses

        return dataclasses.replace(build(cls, model_cfg, ssl=ssl), dropout=0.0)

    def jax_cli():
        monkeypatch.setattr(jax, "devices", lambda *a: devices[:2])
        monkeypatch.setattr(JLinearNLL, "from_config", classmethod(no_dropout))
        with contextlib.redirect_stdout(io.StringIO()):
            assert jax_main(_train_argv(mini_db, jax_out) + ["--mesh", "2,1", "--model_path",
                                                             init]) == 0
        monkeypatch.undo()

    _beside_ranks((argv, str(tmp_path / "logs"), 0.0), jax_cli)
    _, got = _last(str(port_out))
    _, want = _last(str(jax_out))
    gp, wp = flatten(got["params"]), flatten(want["params"])
    for k, w in wp.items():
        if k.endswith("attn//k//b"):  # a noise gradient: each side moves it by rounding
            continue
        np.testing.assert_allclose(gp[k], w, rtol=1e-5, atol=1e-5, err_msg=k)
    go, wo = _leaves(got["opt_state_leaves"]), _leaves(want["opt_state_leaves"])
    assert len(go) == len(wo)
    key_bias = _key_bias_leaves()
    for i, (a, b) in enumerate(zip(go, wo)):
        if i in key_bias:
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-4 * np.abs(b).max() + 1e-30,
                                   err_msg=str(i))
    rank1 = open(tmp_path / "logs" / "rank1.out").read()
    assert "epoch 0:" in rank1  # every rank trains and prints


def _leaves(leaves):
    return leaves if isinstance(leaves, list) else [leaves[str(i)] for i in range(len(leaves))]


def _key_bias_leaves():
    """The optax leaves of the key bias's two moments (after the 8 leading
    leaves, ``train/checkpoint``'s layout)."""
    from scl_deepfake_audio_detection_torch.models import xlsr as PX
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.params import jax_leaf_map

    model = LinearNLL(ssl=PX.XLSRConfig.tiny(), device="meta")
    paths = [p for p, _ in jax_leaf_map(model)]
    i = paths.index("ssl//encoder//layers//attn//k//b")
    n = len(paths)
    return {8 + i, 8 + n + i}


def test_mesh_started_by_the_cli_equals_one_process(mini_db, tmp_path):
    """The CLI starts its two ranks itself; with the head's dropout on, the
    run equals the one-process run (each rank keeps its rows of the whole
    batch's masks)."""
    one, two = tmp_path / "one", tmp_path / "two"
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_main(_train_argv(mini_db, one) + ["--device", "cpu"]) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_main(_train_argv(mini_db, two) + ["--device", "cpu", "--mesh", "2,1"]) == 0
    _, a = _last(str(one))
    run_two, b = _last(str(two))
    for k, w in flatten(a["params"]).items():
        if k.endswith("attn//k//b"):
            continue
        np.testing.assert_allclose(flatten(b["params"])[k], w, rtol=1e-5, atol=1e-5, err_msg=k)
    assert len(open(os.path.join(run_two, "metrics.jsonl")).readlines()) == 1


def test_multihost_ranks_train_alike_and_rank0_writes(mini_db, tmp_path):
    out = tmp_path / "out"
    argv = _train_argv(mini_db, out) + ["--device", "cpu", "--multihost"]
    os.makedirs(tmp_path / "logs")
    assert M.launch(R.cli_rank, 2, args=(argv, str(tmp_path / "logs")), threads=1,
                    timeout=240) == [0, 0]
    logs = [open(tmp_path / "logs" / f"rank{r}.out").read() for r in range(2)]
    epochs = [[ln.rsplit("(", 1)[0] for ln in log.splitlines() if ln.startswith("epoch ")]
              for log in logs]
    assert epochs[0] and epochs[0] == epochs[1]
    assert "no. of training trials 4" in logs[0]
    (run,) = os.listdir(out)
    files = sorted(os.listdir(out / run))
    assert "last.ckpt" in files and "metrics.jsonl" in files
    assert len(open(out / run / "metrics.jsonl").readlines()) == 1
    assert not any(".tmp" in f or f.startswith("tmp") for f in files)


def test_multihost_eval_writes_a_part_per_rank(mini_db, tmp_path):
    root, _, utts = mini_db
    whole = tmp_path / "whole.txt"
    cache = tmp_path / "cache"
    argv = _eval_argv(mini_db, tmp_path / "scores.txt") + ["--multihost", "--decode_cache",
                                                           str(cache)]
    os.makedirs(tmp_path / "logs")

    def one_process():
        with contextlib.redirect_stdout(io.StringIO()):
            assert port_main(_eval_argv(mini_db, whole)) == 0

    _beside_ranks((argv, str(tmp_path / "logs")), one_process)
    parts = [_rows(tmp_path / f"scores.txt.part{r}") for r in range(2)]
    assert [len(p) for p in parts] == [3, 3]
    assert sorted(r[0] for r in parts[0]) == sorted(utts[0::2])
    got, want = sorted(parts[0] + parts[1]), _rows(whole)
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got], float),
                               np.array([r[1:] for r in want], float), rtol=0, atol=1e-6)
    assert sorted(os.listdir(cache)) == ["part0", "part1"]


def test_multihost_without_a_cluster_runs_as_one_process(mini_db, tmp_path, monkeypatch, capsys):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "SCL_DIST_INIT"):
        monkeypatch.delenv(k, raising=False)
    plain, multi = tmp_path / "plain.txt", tmp_path / "multi.txt"
    assert port_main(_eval_argv(mini_db, plain)) == 0
    capsys.readouterr()
    assert port_main(_eval_argv(mini_db, multi) + ["--multihost"]) == 0
    assert "--multihost: no cluster detected" in capsys.readouterr().err
    assert _rows(multi) == _rows(plain)
    monkeypatch.setenv("RANK", "0")  # a cluster asked for, but incomplete: fatal
    assert port_main(_train_argv(mini_db, tmp_path / "o") + ["--device", "cpu",
                                                            "--multihost"]) == 2
    assert "WORLD_SIZE" in capsys.readouterr().err
