"""The port's eval path vs the JAX package, on the CPU at the tiny config.

- ``LinearNLL.apply`` against JAX from one parameter set (``from_jax``);
- the gate: the port's EvalDataset -> EvalLoader -> score_step ->
  produce_evaluation_file reproduces ``tests/golden/expected_scores.txt``
  within ATOL 1e-4, with the setup of ``tests/test_golden_pipeline.py``;
- the port's CLI ``--eval --device cpu`` writes the JAX CLI's rows;
- the host pieces (padding, dataset, loader, file lists, config, checkpoint
  reader, writer) give what their JAX twins give.

Tolerances: fp32 log-probs agree to 1e-5 (summation order).  bf16 log-probs
to 1e-3: the rounding points of ``tests/test_torch_xlsr.py`` reach the head
only through the mean-pooled embedding."""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_torch.models import base as B
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.params import from_jax, load_jax_params
from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
ATOL_GOLDEN = 1e-4  # as tests/test_golden_pipeline.py


def _jax_params(dtype="float32", emb_dim=16, seed=0):
    jm = JLinearNLL(ssl=JX.XLSRConfig.tiny(compute_dtype=dtype), emb_dim=emb_dim)
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))


def _port(params, dtype="float32", emb_dim=16, **kw):
    m = LinearNLL(ssl=XLSRConfig.tiny(compute_dtype=dtype, **kw), emb_dim=emb_dim,
                  device="cpu")
    return load_jax_params(m, params).eval()


def _golden_wavs(t=16000):
    rng = np.random.default_rng(20240817)
    tt = np.arange(t) / 16000.0
    return [
        (0.3 * np.sin(2 * np.pi * 440.0 * tt)).astype(np.float32),
        (0.2 * rng.normal(size=t)).astype(np.float32),
        (0.3 * np.sin(2 * np.pi * (200 + 800 * tt) * tt)).astype(np.float32),
        (0.25 * np.sin(2 * np.pi * 333.0 * tt[: t // 3])).astype(np.float32),
    ]


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f]


# ----------------------------------------------------------------- the model


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_linear_nll_apply_matches_jax(dtype, tol):
    jm, params = _jax_params(dtype)
    model = _port(params, dtype)
    wav = (0.1 * np.random.default_rng(3).normal(size=(3, 8000))).astype(np.float32)
    want = jm.apply(params, jnp.asarray(wav))
    with torch.inference_mode():
        got = model.apply(torch.from_numpy(wav))
    for name in ("log_probs", "logits", "emb"):
        np.testing.assert_allclose(getattr(got, name).float().numpy(),
                                   np.asarray(getattr(want, name), np.float32),
                                   atol=tol, rtol=0, err_msg=name)
    assert got.feats.shape == want.feats.shape and got.log_probs.dtype == torch.float32


def test_from_jax_unstacks_and_transposes():
    _, params = _jax_params()
    model = _port(params)
    sd = from_jax(params, model)
    assert len(sd) == len(model.state_dict())
    w = params["ssl"]["encoder"]["layers"]["fc1"]["w"]  # [L, in, out]
    assert torch.equal(sd["ssl.encoder.layers.1.fc1.weight"], torch.from_numpy(w[1].T.copy()))
    cw = params["ssl"]["pos_conv"]["w"]  # [K, Cin/g, Cout]
    assert torch.equal(sd["ssl.pos_conv.weight"],
                       torch.from_numpy(cw.transpose(2, 1, 0).copy()))
    assert torch.equal(sd["ssl.post_extract_ln.weight"],
                       torch.from_numpy(np.array(params["ssl"]["post_extract_ln"]["scale"])))


def test_from_jax_raises_on_missing_key():
    _, params = _jax_params()
    model = _port(params)
    del params["backend"]["out"]["b"]
    with pytest.raises(KeyError, match="missing"):
        from_jax(params, model)


def test_from_jax_raises_on_left_over_key():
    _, params = _jax_params()
    model = _port(params)
    params["backend"]["extra"] = {"w": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="left over"):
        from_jax(params, model)


def test_from_jax_raises_on_shape_mismatch():
    _, params = _jax_params(emb_dim=16)
    model = LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=8, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        from_jax(params, model)


def test_cast_matmul_params_casts_only_matmul_weights():
    _, params = _jax_params()
    model = B.cast_matmul_params(_port(params), torch.bfloat16)
    for name, p in model.named_parameters():
        is_w = name.endswith(".weight") and "ln" not in name.split(".")[-2]
        assert p.dtype == (torch.bfloat16 if is_w else torch.float32), name
    assert model.ssl.pos_conv.weight.dtype == torch.bfloat16
    assert model.ssl.encoder.final_ln.weight.dtype == torch.float32


def test_model_contract_helpers():
    _, params = _jax_params()
    model = _port(params)
    assert B.model_buffers(model) == {}
    lp = torch.log_softmax(torch.randn(4, 2), -1)
    out = B.ModelOutput(log_probs=lp, feats=torch.zeros(4, 3, 2), emb=torch.zeros(4, 2))
    assert B.eval_scores(model, out) is lp
    assert torch.equal(B.scores_from_log_probs(lp), lp[:, 1])


def test_seeded_init_is_reproducible_and_seed_dependent():
    a = LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=16, device="cpu", seed=5)
    b = LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=16, device="cpu", seed=5)
    c = LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=16, device="cpu", seed=6)
    for (n, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), n
    assert not torch.equal(a.ll.weight, c.ll.weight)
    assert torch.equal(a.ssl.post_extract_ln.weight, torch.ones(16))


def test_training_entry_raises_not_ported():
    """(The name is from before Slice G2.)  Training is ported, every XLS-R
    option with it, and a BTSE model (Slice G2) trains too."""
    from scl_deepfake_audio_detection_torch.models.btse import XLSRBtse
    from scl_deepfake_audio_detection_torch.utils.registry import MODELS

    cls = MODELS.get("wav2vec2_btse")
    assert cls is XLSRBtse
    btse = cls(ssl=XLSRConfig.tiny(), device="cpu")
    assert btse.apply(torch.zeros(1, 4000), train=True).log_probs.requires_grad
    model = LinearNLL(ssl=XLSRConfig.tiny(fuse_qkv=True, conv_impl="gemm"), emb_dim=16,
                      device="cpu")
    assert model.apply(torch.zeros(1, 4000), train=True).log_probs.requires_grad


# ------------------------------------------------------------------ the gate


@pytest.mark.parametrize("wire_dtype", ["float32", "int16"])
def test_golden_eval_pipeline_on_the_port(tmp_path, wire_dtype):
    from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
    from scl_deepfake_audio_detection_torch.data.loader import EvalLoader
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train import scoring
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

    utts = []
    for i, w in enumerate(_golden_wavs()):
        save_wav(str(tmp_path / "eval" / f"g{i}.wav"), w, 16000)
        utts.append(f"g{i}.wav")
    tree, _ = ckpt.load(os.path.join(GOLDEN, "mini_linear_nll.ckpt"))
    model = LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=16, device="cpu")
    load_jax_params(model, tree["params"]).eval()
    ds = EvalDataset(utts, str(tmp_path), padding_type="repeat", cut=16000)
    loader = EvalLoader(ds, batch_size=2, num_workers=1, wire_dtype=wire_dtype)
    out = str(tmp_path / "scores.txt")
    scoring.produce_evaluation_file(loader, lambda wav: score_step(model, wav), out)
    got, want = _rows(out), _rows(os.path.join(GOLDEN, "expected_scores.txt"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert float(g[1]) == pytest.approx(float(w[1]), abs=ATOL_GOLDEN), (g, w)
        assert float(g[2]) == pytest.approx(float(w[2]), abs=ATOL_GOLDEN), (g, w)


# ------------------------------------------------------------------- the CLI


def _db(root, n=3, layout="scl"):
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

    rng = np.random.default_rng(7)
    utts = [f"u{i}.wav" for i in range(n)]
    audio_dir = root / "eval" if layout == "scl" else root
    for i, u in enumerate(utts):
        save_wav(str(audio_dir / u), (0.1 * rng.normal(size=9000 + 4000 * i)).astype(np.float32))
    if layout == "scl":
        (root / "scp").mkdir(parents=True, exist_ok=True)
        (root / "scp" / "test.lst").write_text("\n".join(utts) + "\n")
        (root / "protocol.txt").write_text(
            "".join(f"LA_0001 {u[:-4]} - A07 spoof\n" for u in utts))
    else:
        (root / "protocol.txt").write_text("".join(f"{u} eval spoof\n" for u in utts))
    return utts


def test_port_cli_eval_writes_the_jax_cli_rows(tmp_path):
    from scl_deepfake_audio_detection_tpu.cli import main as jax_main
    from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
    from scl_deepfake_audio_detection_torch.cli import main as port_main

    _, params = _jax_params(emb_dim=128, seed=3)
    ckpt_path = str(tmp_path / "m.ckpt")
    jckpt.save(ckpt_path, {"params": params})
    db = tmp_path / "db"
    utts = _db(db, layout="scl")
    common = ["--eval", "--config", os.path.join(REPO, "configs", "conf-3-linear.yaml"),
              "--database_path", str(db), "--model_path", ckpt_path,
              "--ssl_preset", "tiny", "--compute_dtype", "float32",
              "--batch_size", "2", "--num_workers", "1", "--padding_type", "repeat"]
    jout, pout = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    assert jax_main(common + ["--eval_output", jout]) == 0
    assert port_main(common + ["--eval_output", pout, "--device", "cpu"]) == 0
    want, got = _rows(jout), _rows(pout)
    assert [r[0] for r in got] == [r[0] for r in want] == utts
    np.testing.assert_allclose(np.array([r[1:] for r in got], float),
                               np.array([r[1:] for r in want], float), atol=1e-5, rtol=0)

    # the same files in the eval-only layout score the same
    db2 = tmp_path / "db2"
    _db(db2, layout="eval_only")
    pout2 = str(tmp_path / "port2.txt")
    common2 = [a if a != str(db) else str(db2) for a in common]
    common2[common2.index(os.path.join(REPO, "configs", "conf-3-linear.yaml"))] = \
        os.path.join(REPO, "configs", "conf-eval-only.yaml")
    assert port_main(common2 + ["--eval_output", pout2, "--device", "cpu"]) == 0
    assert _rows(pout2) == got


@pytest.mark.parametrize("argv", [["--train"], ["--eval", "--distill_from", "t.ckpt"],
                                  ["--eval", "--mesh", "1,1"],
                                  ["--serve", "--zero1"]])
def test_port_cli_refuses_unported_modes(argv, capsys, tmp_path):
    """Flags of later slices exit 2.  ``--distill_from`` is ported (Slice
    H1): beside ``--eval`` it is ignored as by the JAX CLI, which scores
    without reading the teacher; the rows equal the JAX CLI's."""
    from scl_deepfake_audio_detection_torch.cli import main as port_main

    if "--distill_from" in argv:
        from scl_deepfake_audio_detection_tpu.cli import main as jax_main
        from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt

        _, params = _jax_params(emb_dim=128, seed=4)
        jckpt.save(str(tmp_path / "m.ckpt"), {"params": params})
        db = tmp_path / "db"
        utts = _db(db, n=2, layout="eval_only")
        run = argv + ["--config", os.path.join(REPO, "configs", "conf-eval-only.yaml"),
                      "--database_path", str(db), "--model_path", str(tmp_path / "m.ckpt"),
                      "--ssl_preset", "tiny", "--compute_dtype", "float32",
                      "--batch_size", "2", "--num_workers", "1"]
        jout, pout = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
        assert jax_main(run + ["--eval_output", jout]) == 0
        assert port_main(run + ["--eval_output", pout, "--device", "cpu"]) == 0
        want, got = _rows(jout), _rows(pout)
        assert sorted(r[0] for r in got) == sorted(r[0] for r in want) == sorted(utts)
        np.testing.assert_allclose(np.array([r[1:] for r in got], float),
                                   np.array([r[1:] for r in want], float), atol=1e-5, rtol=0)
        return
    assert port_main(argv) == 2
    assert "not ported yet" in capsys.readouterr().err


def _train_db(root):
    """Four anchors (two train, two dev) with one vocoded copy each, and a
    conf-3 config cut to 4000 samples with RawBoost alone."""
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

    rng = np.random.default_rng(8)
    utts = [f"a{i}.wav" for i in range(4)]
    for u in utts:
        save_wav(str(root / "bonafide" / u), (0.2 * rng.normal(size=5000)).astype(np.float32))
        save_wav(str(root / "vocoded" / f"hifigan_{u}"),
                 (0.2 * rng.normal(size=5000)).astype(np.float32))
    (root / "scp").mkdir()
    (root / "scp" / "train_bonafide.lst").write_text("a0.wav\na1.wav\n")
    (root / "scp" / "dev_bonafide.lst").write_text("a2.wav\na3.wav\n")
    cfg = root / "conf3.yaml"
    cfg.write_text(f"""model:
  name: wav2vec2_linear_nll
data:
  name: 'asvspoof_2019_augall_3'
  kwargs:
    vocoders: ['hifigan']
    augmentation_methods: ["RawBoost12"]
    num_additional_real: 1
    trim_length: 4000
    online_aug: true
    aug_dir: '{root}/aug'
""")
    return str(cfg)


def test_port_cli_refuses_reference_pth(tmp_path, capsys):
    """A reference ``epoch_N.pth`` loads as ``--model_path``, and since
    Slice H1 as a distillation teacher (``--distill_from``): the port's CLI
    distils the tiny student from it and writes ``student_last.ckpt``
    (``tests/test_torch_distill_cli.py`` holds the student to the JAX
    package's)."""
    from scl_deepfake_audio_detection_torch.cli import main as port_main
    from scl_deepfake_audio_detection_torch.models import convert
    from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt

    _, params = _jax_params(emb_dim=128, seed=5)
    convert.save_reference_checkpoint(params, str(tmp_path / "epoch_1.pth"))
    db = tmp_path / "db"
    cfg = _train_db(db)
    rc = port_main(["--config", cfg, "--database_path", str(db),
                    "--distill_from", str(tmp_path / "epoch_1.pth"), "--teacher_preset", "tiny",
                    "--ssl_preset", "tiny", "--compute_dtype", "float32", "--batch_size", "2",
                    "--num_epochs", "1", "--num_workers", "1", "--out_dir",
                    str(tmp_path / "out"), "--device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == 0 and "not ported yet" not in err, err
    (path,) = glob.glob(str(tmp_path / "out" / "*" / "student_last.ckpt"))
    _, extra = pckpt.load(path)
    assert extra["epoch"] == 0 and 0.0 <= extra["teacher_agreement"] <= 1.0
    assert all(np.isfinite(v) for v in extra.values())
    assert "epoch 0: accuracy=" in out


def test_entry_points_need_a_card_unless_the_cpu_is_asked_for():
    from scl_deepfake_audio_detection_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LinearNLL(ssl=XLSRConfig.tiny())  # the model's default device is the card


# ------------------------------------------------------------ host pieces


@pytest.mark.parametrize("n,padding_type", [(100, "zero"), (100, "repeat"), (300, "zero"),
                                            (37, "repeat"), (250, "repeat")])
def test_pad_eval_matches_jax(n, padding_type):
    from scl_deepfake_audio_detection_tpu.dsp.pad import pad_eval as jpad
    from scl_deepfake_audio_detection_torch.dsp.pad import pad_eval

    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    np.testing.assert_array_equal(pad_eval(x, padding_type, 250), jpad(x, padding_type, 250))


def test_pad_eval_rejects_unknown_padding():
    from scl_deepfake_audio_detection_torch.dsp.pad import pad_eval

    with pytest.raises(ValueError):
        pad_eval(np.zeros(3, np.float32), "reflect", 10)


@pytest.mark.parametrize("wire_dtype", ["float32", "int16"])
def test_eval_dataset_and_loader_match_jax(tmp_path, wire_dtype):
    from scl_deepfake_audio_detection_tpu.data.datasets import EvalDataset as JDS
    from scl_deepfake_audio_detection_tpu.data.loader import EvalLoader as JLoader
    from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
    from scl_deepfake_audio_detection_torch.data.loader import EvalLoader

    utts = _db(tmp_path, n=5, layout="scl")
    mine = EvalLoader(EvalDataset(utts, str(tmp_path), "repeat", cut=12000), batch_size=2,
                      num_workers=2, wire_dtype=wire_dtype)
    ref = JLoader(JDS(utts, str(tmp_path), "repeat", cut=12000), batch_size=2,
                  num_workers=2, wire_dtype=wire_dtype)
    got, want = list(mine), list(ref)
    assert len(mine) == len(ref) == 3 and len(got) == 3
    for (gw, gu), (ww, wu) in zip(got, want):
        assert gu == wu and gw.dtype == ww.dtype and gw.shape == (2, 12000)
        np.testing.assert_array_equal(gw, ww)


def test_eval_loader_rejects_unknown_wire():
    from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
    from scl_deepfake_audio_detection_torch.data.loader import EvalLoader

    with pytest.raises(ValueError):
        EvalLoader(EvalDataset([], "/nonexistent"), wire_dtype="float16")


def test_eval_loader_surfaces_worker_errors(tmp_path):
    from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
    from scl_deepfake_audio_detection_torch.data.loader import EvalLoader

    loader = EvalLoader(EvalDataset(["missing.wav"], str(tmp_path)), batch_size=1,
                        num_workers=1)
    with pytest.raises(FileNotFoundError):
        list(loader)


@pytest.mark.parametrize("layout", ["scl", "eval_only"])
def test_file_lists_match_jax(tmp_path, layout):
    from scl_deepfake_audio_detection_tpu.data import protocols as JP
    from scl_deepfake_audio_detection_torch.data import protocols as P

    _db(tmp_path, n=4, layout=layout)
    if layout == "scl":
        scp = tmp_path / "scp"
        (scp / "train_bonafide.lst").write_text("t1.wav\nt2.wav extra\n\nt3.wav\n")
        (scp / "dev_bonafide.lst").write_text("d1.wav\n")
        (scp / "dev_spoof.lst").write_text("s1.wav\ns2.wav\n")
        for split in ("train", "dev", "eval"):
            assert P.gen_list_scl(str(tmp_path), split) == JP.gen_list_scl(str(tmp_path), split)
            assert (P.gen_list_spoof_dirs(str(tmp_path), split)
                    == JP.gen_list_spoof_dirs(str(tmp_path), split))
        assert P.gen_list_spoof_dirs(str(tmp_path), "dev")[0] == {"s1.wav": 0, "s2.wav": 0}
        with pytest.raises(ValueError):
            P.gen_list_scl(str(tmp_path), "test")
    else:
        assert P.gen_list_eval_only(str(tmp_path)) == JP.gen_list_eval_only(str(tmp_path))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_load_config_reads_what_eval_needs_like_jax(path):
    from scl_deepfake_audio_detection_tpu.utils.config import load_config as jload
    from scl_deepfake_audio_detection_torch.utils.config import load_config
    from scl_deepfake_audio_detection_torch.utils.registry import DATASETS

    mine, ref = load_config(path), jload(path)
    assert (mine.model.name, mine.model.flag_fix_ssl, mine.model.contra_mode,
            mine.model.loss_type) == (ref.model.name, ref.model.flag_fix_ssl,
                                       ref.model.contra_mode, ref.model.loss_type)
    assert (mine.data.name, mine.data.kwargs) == (ref.data.name, ref.data.kwargs)
    assert DATASETS.get(mine.data.name)["eval_subdir"] == (mine.data.name != "eval_only")


def test_checkpoint_reader_matches_jax():
    from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt

    path = os.path.join(GOLDEN, "mini_linear_nll.ckpt")
    (tree, extra), (jtree, jextra) = ckpt.load(path), jckpt.load(path)
    assert extra == jextra
    a = jax.tree_util.tree_leaves_with_path(tree)
    b = jax.tree_util.tree_leaves_with_path(jtree)
    assert [p for p, _ in a] == [p for p, _ in b] and len(a) == 46
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_writer_is_byte_compatible_with_jax(tmp_path):
    from scl_deepfake_audio_detection_tpu.train import scoring as jscoring
    from scl_deepfake_audio_detection_torch.train import scoring

    rng = np.random.default_rng(9)
    lps = [np.log(np.array([[0.3, 0.7], [0.9, 0.1], [0.5, 0.5]], np.float32)),
           rng.normal(size=(3, 2)).astype(np.float32)]
    batches = [(None, ["a", "b", "c"]), (None, ["d"])]  # second batch padded: one row kept
    fns = iter(lps * 2)
    mine, ref = tmp_path / "mine.txt", tmp_path / "ref.txt"
    scoring.produce_evaluation_file(batches, lambda _: torch.from_numpy(next(fns)), str(mine))
    jscoring.produce_evaluation_file(batches, lambda _: next(fns), str(ref))
    assert mine.read_bytes() == ref.read_bytes()
    assert mine.read_text().count("\n") == 4


def test_score_step_accepts_the_int16_wire():
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.audio_io import pcm16_encode

    _, params = _jax_params()
    model = _port(params)
    pcm = pcm16_encode((0.1 * np.random.default_rng(4).normal(size=(2, 4000))).astype(np.float32))
    a = score_step(model, pcm)
    b = score_step(model, pcm.astype(np.float32) / 32768.0)
    assert a.shape == (2, 2) and torch.equal(a, b)


def test_audio_io_round_trips_pcm16(tmp_path):
    from scl_deepfake_audio_detection_tpu.utils import audio_io as jio
    from scl_deepfake_audio_detection_torch.utils import audio_io

    x = (0.3 * np.random.default_rng(5).normal(size=800)).clip(-1, 1).astype(np.float32)
    audio_io.save_wav(str(tmp_path / "a.wav"), x, 16000)
    got = audio_io.load_audio(str(tmp_path / "a.wav"))
    np.testing.assert_array_equal(got, jio.load_audio(str(tmp_path / "a.wav")))
    np.testing.assert_array_equal(audio_io.pcm16_encode(x), jio.pcm16_encode(x))
    np.testing.assert_allclose(got, x, atol=1 / 32768)
    half = audio_io.load_audio(str(tmp_path / "a.wav"), sr=8000)
    assert half.dtype == np.float32 and abs(len(half) - 400) <= 1
    # a missing .flac: the JAX package's exception type and message prefix
    with pytest.raises(RuntimeError, match="cannot decode") as got:
        audio_io.load_audio(str(tmp_path / "a.flac"))
    with pytest.raises(RuntimeError, match="cannot decode") as want:
        jio.load_audio(str(tmp_path / "a.flac"))
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0] == "cannot decode '.flac'"
