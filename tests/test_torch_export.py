"""The port's scoring artifacts (``export.py``, ``cli/export.py``) on the
CPU, against direct scoring and against the JAX package's artifact.

- An artifact's scores equal ``score_step``'s within 5e-4 (the JAX test's
  bound), at any batch size (the batch is symbolic).
- ``weights.npz`` holds the JAX artifact's leaves under its keys, bit for
  bit, bf16 and int8 (the scales and the dequantized leaves too);
  ``meta.json`` has the JAX artifact's keys (``torch_version`` in place of
  ``jax_version``).
- The loader imports no model code and refuses a JAX artifact.
- The program calls the flash forward as the op ``scl_port::flash_attn_fwd``
  once per encoder layer and holds no weight.
- The CLI: ``--export_model`` (also int8), ``--verify_export`` (pass and
  fail), ``--eval`` and ``--serve`` ``--from_export`` (the artifact's
  calibration), and the JAX CLI's refusals."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from scl_deepfake_audio_detection_tpu import export as jexport
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.models.xlsr import XLSRConfig as JXLSRConfig
from scl_deepfake_audio_detection_torch import export as pexport
from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.params import load_jax_params
from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
from scl_deepfake_audio_detection_torch.ops import _kernels
from scl_deepfake_audio_detection_torch.train.engine import score_step
from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = 16000  # the artifacts here; the CLI's are the reference's 64600
ATOL = 5e-4  # as tests/test_export.py
SR = 16000


def _params():
    jm = JLinearNLL(ssl=JXLSRConfig.tiny(), emb_dim=16)
    return jax.tree.map(np.asarray, jm.init(jax.random.key(0)))


def _model(params, dtype="bfloat16"):
    m = LinearNLL(ssl=XLSRConfig.tiny(compute_dtype=dtype), emb_dim=16, device="cpu")
    return load_jax_params(m, params).eval()


def _wav(b, seed=0):
    return (0.1 * np.random.default_rng(seed).normal(size=(b, CUT))).astype(np.float32)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The same parameters exported by both packages, plain and int8."""
    root = tmp_path_factory.mktemp("export")
    params = _params()
    jm = JLinearNLL(ssl=JXLSRConfig.tiny(), emb_dim=16)
    out = {"params": params}
    for quant in (None, "int8"):
        tag = quant or "fp"
        out[tag] = str(root / f"port_{tag}")
        out[f"meta_{tag}"] = pexport.export_scorer(
            _model(params), out[tag], cut=CUT, calibration=(1.5, -0.25), model_tag="tiny_nll",
            quantize=quant)
        out[f"jax_{tag}"] = str(root / f"jax_{tag}")
        out[f"jax_meta_{tag}"] = jexport.export_scorer(
            jm, params, {}, out[f"jax_{tag}"], cut=CUT, calibration=(1.5, -0.25),
            model_tag="tiny_nll", quantize=quant)
    return out


def _direct(params, wav):
    model = cast_matmul_params(_model(params), torch.bfloat16)
    return score_step(model, wav).float().numpy()


def test_export_round_trip_matches_direct_scoring(artifacts):
    scorer = pexport.load_scorer(artifacts["fp"], device="cpu")
    wav = _wav(3)
    got = scorer.score(wav)
    assert got.shape == (3, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, _direct(artifacts["params"], wav), atol=ATOL, rtol=0)


def test_export_symbolic_batch_dimension(artifacts):
    """One program for every batch size; each row as scored alone."""
    scorer = pexport.load_scorer(artifacts["fp"], device="cpu")
    wav = _wav(5, seed=1)
    full = scorer.score(wav)
    for b in (1, 2, 5):
        np.testing.assert_allclose(scorer.score(wav[:b]), full[:b], atol=ATOL, rtol=0)


def test_export_input_validation(artifacts):
    scorer = pexport.load_scorer(artifacts["fp"], device="cpu")
    with pytest.raises(ValueError, match="expected"):
        scorer.score(np.zeros((2, CUT + 1), np.float32))
    with pytest.raises(ValueError, match="expected"):
        scorer.score(np.zeros(CUT, np.float32))


@pytest.mark.parametrize("tag", ["fp", "int8"])
def test_export_metadata_matches_the_jax_artifact(artifacts, tag):
    got, want = artifacts[f"meta_{tag}"], artifacts[f"jax_meta_{tag}"]
    assert set(got) == set(want) - {"jax_version"} | {"torch_version"}
    assert got["torch_version"] == torch.__version__
    assert got["platforms"] == ["cpu", "cuda"]
    for k in sorted(set(want) - {"jax_version", "platforms"}):
        assert got[k] == want[k], k
    with open(os.path.join(artifacts[tag], "meta.json")) as f:
        assert json.load(f) == got


@pytest.mark.parametrize("tag", ["fp", "int8"])
def test_export_weights_are_the_jax_artifacts_bit_for_bit(artifacts, tag):
    """The stored arrays (bf16 bits, int8 values, fp32 scales) and the
    leaves the loaders restore (int8 dequantized to bf16) are equal."""
    with np.load(os.path.join(artifacts[tag], "weights.npz")) as z:
        got = {k: z[k] for k in z.files}
    with np.load(os.path.join(artifacts[f"jax_{tag}"], "weights.npz")) as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    if tag == "int8":
        assert any(k.startswith("qs") for k in got)
    mine = pexport.load_scorer(artifacts[tag], device="cpu")._p
    theirs = jexport.load_scorer(artifacts[f"jax_{tag}"])._p
    assert len(mine) == len(theirs)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            assert b.dtype.name == "bfloat16", i
            assert np.array_equal(a.view(torch.int16).numpy(), b.view(np.int16)), i
        else:
            assert np.array_equal(a.numpy(), b), i


def test_int8_artifact_scores_within_the_weight_rounding(artifacts):
    wav = _wav(2, seed=2)
    q = pexport.load_scorer(artifacts["int8"], device="cpu").score(wav)
    fp = pexport.load_scorer(artifacts["fp"], device="cpu").score(wav)
    assert np.isfinite(q).all() and np.abs(q - fp).max() < 5e-2
    assert artifacts["meta_int8"]["stored_bytes"] < artifacts["meta_fp"]["stored_bytes"]


def test_export_program_calls_the_flash_op_per_layer_and_holds_no_weight(artifacts):
    program = torch.export.load(os.path.join(artifacts["fp"], "scorer.pt2"))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("scl_port.flash_attn_fwd.default") == XLSRConfig.tiny().encoder_layers
    assert not [t for t in targets if "softmax" in t and "log_softmax" not in t]
    assert not program.state_dict and not program.constants
    import zipfile

    with zipfile.ZipFile(os.path.join(artifacts["fp"], "scorer.pt2")) as z:
        held = sum(i.file_size for i in z.infolist()
                   if "/data/" in i.filename)  # weights, constants, sample inputs
    assert held < 1024, held
    # the registered op is the plain version on CPU tensors, the kernel on
    # CUDA tensors (which raise here: no launch without a card)
    q = torch.randn(1, 2, 9, 8)
    o, lse = torch.ops.scl_port.flash_attn_fwd(q, q, q, 7)
    from scl_deepfake_audio_detection_torch.ops.attention import (
        flash_attention_forward_reference,
    )

    want_o, want_lse = flash_attention_forward_reference(q, q, q, 7)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert sum(_kernels.LAUNCHES.values()) == 0


def test_export_records_the_device_dependent_products_as_ops(artifacts):
    """In the program every product is an scl_port op (no aten mm or
    convolution is left to bake in the exporting device's formulation);
    eager scoring calls none of them, only the flash forward's op."""
    from torch.utils._python_dispatch import TorchDispatchMode

    program = torch.export.load(os.path.join(artifacts["fp"], "scorer.pt2"))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("scl_port.mm_f32.default") > 0
    assert targets.count("scl_port.conv1d.default") > 0
    assert not [t for t in targets if t.startswith("aten.") and ("mm" in t or "conv" in t)]

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "scl_port":
                self.seen.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    model = cast_matmul_params(_model(artifacts["params"]), torch.bfloat16)
    with Ops() as ops:
        score_step(model, _wav(2))
    assert ops.seen == {"flash_attn_fwd"}


def test_loader_needs_no_model_code(artifacts):
    """In a process where the model, training, data and CLI modules cannot
    be imported, the artifact loads and scores as here."""
    code = (
        "import sys, numpy as np\n"
        "for m in ['models', 'models.xlsr', 'models.linear_nll', 'models.base', 'models.params',"
        " 'train', 'cli', 'data', 'dsp']:\n"
        "    sys.modules['scl_deepfake_audio_detection_torch.' + m] = None\n"
        "from scl_deepfake_audio_detection_torch.export import load_scorer\n"
        f"s = load_scorer({artifacts['fp']!r}, device='cpu')\n"
        f"wav = (0.1 * np.random.default_rng(0).normal(size=(3, {CUT}))).astype(np.float32)\n"
        "print(repr(s.score(wav).tolist()))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    got = np.array(eval(r.stdout.strip().splitlines()[-1]), np.float32)
    want = pexport.load_scorer(artifacts["fp"], device="cpu").score(_wav(3))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_loader_defaults_to_the_card(artifacts):
    """As the port's other entry points: the card unless the caller asks
    for the CPU, and with no card an error that says how to ask."""
    if torch.cuda.is_available():
        assert pexport.load_scorer(artifacts["fp"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pexport.load_scorer(artifacts["fp"])


def test_loader_refuses_a_jax_artifact_and_a_newer_format(artifacts, tmp_path):
    with pytest.raises(ValueError, match="JAX artifact"):
        pexport.load_scorer(artifacts["jax_fp"], device="cpu")
    newer = tmp_path / "newer"
    newer.mkdir()
    for name in ("scorer.pt2", "weights.npz"):
        (newer / name).write_bytes(open(os.path.join(artifacts["fp"], name), "rb").read())
    meta = dict(artifacts["meta_fp"], format_version=pexport.FORMAT_VERSION + 1)
    (newer / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="newer"):
        pexport.load_scorer(str(newer), device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        pexport.export_scorer(_model(artifacts["params"]), str(tmp_path / "x"), cut=CUT,
                              quantize="int4")


# --------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def cli_db(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_db")
    rng = np.random.default_rng(3)
    lines = []
    for i in range(4):
        save_wav(str(root / f"e{i}.wav"),
                 (0.2 * rng.normal(size=int(rng.integers(5000, 9000)))).astype(np.float32), SR)
        lines.append(f"e{i}.wav eval {'bonafide' if i % 2 else 'spoof'}")
    (root / "protocol.txt").write_text("\n".join(lines) + "\n")
    art = str(root / "art")
    argv = _cli(root, "--export_model", art, "--calibrate", "2,0.5", "--compute_dtype",
                "float32")
    assert port_main(argv) == 0
    return root, art


def _cli(root, *argv):
    return ["--config", os.path.join(REPO, "configs", "conf-eval-only.yaml"),
            "--database_path", str(root), "--ssl_preset", "tiny", "--device", "cpu",
            "--num_workers", "1", *argv]


def _rows(path):
    return [ln.split() for ln in open(path)]


def test_cli_eval_from_export_matches_model_eval(cli_db, tmp_path, capsys):
    root, art = cli_db
    a, b = str(tmp_path / "model.txt"), str(tmp_path / "art.txt")
    assert port_main(_cli(root, "--eval", "--eval_output", a, "--compute_dtype",
                          "float32")) == 0
    assert port_main(_cli(root, "--eval", "--from_export", art, "--eval_output", b,
                          "--wire_dtype", "int16")) == 0
    assert "ignoring --wire_dtype int16" in capsys.readouterr().err
    ra, rb = _rows(a), _rows(b)
    assert [r[0] for r in ra] == [r[0] for r in rb]
    np.testing.assert_allclose(np.array([r[1:] for r in rb], float),
                               np.array([r[1:] for r in ra], float), atol=ATOL, rtol=0)


def test_cli_serve_from_export_applies_the_artifacts_calibration(cli_db, tmp_path,
                                                                 monkeypatch, capsys):
    root, art = cli_db
    lines = [f"k{i}\t{root}/e{i}.wav" for i in range(4)] + [f"bad\t{root}/missing.wav"]

    def serve(argv):
        monkeypatch.setattr(sys, "stdin", io.StringIO("".join(ln + "\n" for ln in lines)))
        assert port_main(argv) == 0
        cap = capsys.readouterr()
        return [ln.split("\t") for ln in cap.out.splitlines()], cap.err

    want, _ = serve(_cli(root, "--serve", "--serve_batch", "2", "--compute_dtype", "float32"))
    got, err = serve(_cli(root, "--serve", "--serve_batch", "2", "--from_export", art))
    assert "applying the artifact's calibration a=2.000000 b=0.500000" in err
    assert [g[0] for g in got] == [w[0] for w in want] == [f"k{i}" for i in range(4)] + ["bad"]
    assert got[-1][1].startswith("ERROR")
    np.testing.assert_allclose([float(g[1]) for g in got[:4]],
                               [2.0 * float(w[1]) + 0.5 for w in want[:4]], atol=ATOL * 2,
                               rtol=0)


def test_cli_verify_export_passes_then_catches_drift(cli_db, tmp_path, capsys):
    root, art = cli_db
    assert port_main(_cli(root, "--verify_export", art, "--compute_dtype", "float32")) == 0
    assert "(OK, tol 0.01)" in capsys.readouterr().out
    bad = tmp_path / "bad"
    bad.mkdir()
    for name in ("scorer.pt2", "meta.json"):
        (bad / name).write_bytes(open(os.path.join(art, name), "rb").read())
    with np.load(os.path.join(art, "weights.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    # p00006 is the logits' bias (backend/out/b, fp32): the bonafide logit + 1
    arrays["p00006"] = arrays["p00006"] + np.float32([0.0, 1.0])
    np.savez(str(bad / "weights.npz"), **arrays)
    assert port_main(_cli(root, "--verify_export", str(bad), "--compute_dtype",
                          "float32")) == 1
    assert "FAIL" in capsys.readouterr().out


def test_cli_export_int8(cli_db, tmp_path, capsys):
    root, _ = cli_db
    art = str(tmp_path / "art8")
    assert port_main(_cli(root, "--export_model", art, "--export_quant", "int8")) == 0
    out = capsys.readouterr().out
    assert "as int8" in out and "platforms ['cpu', 'cuda']" in out
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    assert meta["quantization"] == "int8" and meta["quantized_leaf_scales"]
    assert port_main(_cli(root, "--verify_export", art)) == 0


@pytest.mark.parametrize("argv,msg", [
    (["--from_export", "ART"], "works with --serve or --eval"),
    (["--eval", "--emb", "--from_export", "ART"], "--emb needs the model"),
    (["--eval", "--from_export", "ART", "--model_path", "x.ckpt"], "drop --model_path"),
    (["--eval", "--from_export", "ART", "--export_reference_ckpt", "o.pth"],
     "cannot reverse-migrate"),
])
def test_cli_from_export_refusals_exit_2(cli_db, argv, msg, capsys):
    root, art = cli_db
    assert port_main(_cli(root, *[art if a == "ART" else a for a in argv])) == 2
    assert msg in capsys.readouterr().err
