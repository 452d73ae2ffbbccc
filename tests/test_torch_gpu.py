"""Tests of the port that need an NVIDIA GPU: the hand-written kernels
against their plain versions, and the eval and training paths on the card.  Marked ``gpu``;
each decides in its body whether a card is present and skips without one.
Run them on a machine with a card: ``python -m pytest -m gpu tests/test_torch_*.py``.

Tolerances as in ``chip_smoke.py``: fp32 differs by summation order (O 2e-5,
LSE 1e-5; TF32 off); in bf16 P is rounded at the kernel's running max and
O is rounded to bf16, so O is held to 3e-2 and LSE to 1e-4.  D = rowsum(dO *
O), which the dq kernel computes, is the same fp32 sum in another order: a
sum of n terms is off by at most about n 2^-24 times the sum of their
magnitudes, so D is held to 1e-5 of the largest row's sum of |dO * O| (n up
to 128 here)."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from scl_deepfake_audio_detection_torch.ops import _kernels
from scl_deepfake_audio_detection_torch.ops import attention as PA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (3e-2, 1e-4)}
# (T, kv_len): the main path's lengths, one and a long one, and the seams of
# the bf16 kernels' design: a 64-row TMA box edge (63, 64, 65), the
# forward's switch from one block per head to two (128, 129), and its
# switch from K/V held whole (T <= 256) to K/V streamed (257)
SEQS = [(1, None), (63, None), (64, None), (65, 60), (128, None), (129, 120),
        (199, None), (201, 188), (256, None), (257, 250), (1024, 1011)]


def _tol_delta(o, do):
    return 1e-5 * (do.float() * o.float()).abs().sum(-1).max().item()


def _bwd_inputs(t, d, dtype, seed, b=2, h=4, kv_len=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, h, t, d)
    q = (torch.randn(shape, device="cuda", generator=g) * d ** -0.5).to(dtype)
    k, v, do = (torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(3))
    o, lse = PA.flash_attention_forward(q, k, v, kv_len)
    return q, k, v, o, do, lse


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (Hopper, sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [8, 64, 80, 96, 120, 128])
@pytest.mark.parametrize("t,kv_len", SEQS)
def test_flash_kernel_matches_plain_version(dtype, d, t, kv_len):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(t * 1000 + d)
    shape = (2, 4, t, d)
    q = (torch.randn(shape, device="cuda", generator=g) * d ** -0.5).to(dtype)
    k = torch.randn(shape, device="cuda", generator=g).to(dtype)
    v = torch.randn(shape, device="cuda", generator=g).to(dtype)
    before = _kernels.LAUNCHES["flash_attn_fwd"]
    o, lse = PA.flash_attention_forward(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["flash_attn_fwd"] == before + 1
    ro, rlse = PA.flash_attention_forward_reference(q, k, v, kv_len)
    assert o.dtype == dtype and lse.dtype == torch.float32
    tol_o, tol_lse = TOL[dtype]
    assert (o.float() - ro.float()).abs().max().item() <= tol_o
    assert (lse - rlse).abs().max().item() <= tol_lse


@pytest.mark.gpu
def test_flash_kernel_refuses_misaligned_inputs():
    _need_card()
    flat = torch.zeros(2 * 8 * 64 + 4, device="cuda", dtype=torch.bfloat16)
    x = flat[4:].view(2, 1, 8, 64)  # 8 bytes past an aligned start
    before = _kernels.LAUNCHES["flash_attn_fwd"]
    with pytest.raises(ValueError, match="16-byte"):
        _kernels.flash_attn_fwd(x, x, x)
    assert _kernels.LAUNCHES["flash_attn_fwd"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [8, 64, 80, 96, 120, 128])
@pytest.mark.parametrize("t,kv_len", SEQS)
def test_backward_kernels_match_plain_versions(dtype, d, t, kv_len):
    """dq and D from the dq kernel, dk and dv from the dk/dv kernel fed that
    D, against the plain versions.  fp32 to 2e-5 (summation order); bf16 to
    one bf16 ulp of the largest |gradient| (2^-7 of max) plus 2e-5 for
    gradients that are zero up to rounding (T = 1), as chip_smoke.TOL_BWD;
    D to ``_tol_delta``."""
    _need_card()
    q, k, v, o, do, lse = _bwd_inputs(t, d, dtype, t * 1000 + d, kv_len=kv_len)
    before = dict(_kernels.LAUNCHES)
    dq, delta = _kernels.flash_attn_bwd_dq(q, k, v, o, do, lse, kv_len)
    got = (dq, *_kernels.flash_attn_bwd_dkv(q, k, v, do, lse, delta, kv_len))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["flash_attn_bwd_dq"] == before["flash_attn_bwd_dq"] + 1
    assert _kernels.LAUNCHES["flash_attn_bwd_dkv"] == before["flash_attn_bwd_dkv"] + 1
    want_dq, want_delta = PA.flash_bwd_dq_delta_reference(q, k, v, o, do, lse, kv_len)
    want = (want_dq, *PA.flash_bwd_dkv_reference(q, k, v, do, lse, want_delta, kv_len))
    assert delta.dtype == torch.float32 and delta.shape == (2, 4, t)
    assert (delta - want_delta).abs().max().item() <= _tol_delta(o, do)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        tol = 2e-5 + (0.0 if dtype == torch.float32
                      else 2.0 ** -7 * b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol
    if kv_len is not None:
        assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("t,kv_len", [(199, None), (257, 250)])
def test_dkv_kernel_is_deterministic(t, kv_len):
    """dk/dv uses no atomics: two launches on the same inputs agree bit for bit."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(t)
    shape = (2, 16, t, 64)
    q = (torch.randn(shape, device="cuda", generator=g) / 8).bfloat16()
    k, v, do = (torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(3))
    o, lse = PA.flash_attention_forward(q, k, v, kv_len)
    delta = (do.float() * o.float()).sum(-1)
    first = _kernels.flash_attn_bwd_dkv(q, k, v, do, lse, delta, kv_len)
    second = _kernels.flash_attn_bwd_dkv(q, k, v, do, lse, delta, kv_len)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t,kv_len", [(199, None), (257, 250)])
def test_dq_kernel_is_deterministic(dtype, t, kv_len):
    """dq and D use no atomics: two launches on the same inputs agree bit for bit."""
    _need_card()
    q, k, v, o, do, lse = _bwd_inputs(t, 64, dtype, t, h=16, kv_len=kv_len)
    first = _kernels.flash_attn_bwd_dq(q, k, v, o, do, lse, kv_len)
    second = _kernels.flash_attn_bwd_dq(q, k, v, o, do, lse, kv_len)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("t,kv_len", [(199, None), (201, 188), (1024, 1011)])
def test_dkv_fed_the_kernel_delta_matches_dkv_fed_torch_delta(t, kv_len):
    """The D the dq kernel writes against torch's rowsum(dO * O) as the
    dk/dv kernel's input: the two differ by fp32 summation order, which can
    flip a bf16 rounding of dS, so dk and dv agree within one bf16 step of
    their largest magnitude."""
    _need_card()
    q, k, v, o, do, lse = _bwd_inputs(t, 64, torch.bfloat16, t + 7, h=16, kv_len=kv_len)
    _, delta = _kernels.flash_attn_bwd_dq(q, k, v, o, do, lse, kv_len)
    got = _kernels.flash_attn_bwd_dkv(q, k, v, do, lse, delta, kv_len)
    want = _kernels.flash_attn_bwd_dkv(q, k, v, do, lse, PA._delta(o, do), kv_len)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        tol = 2.0 ** -7 * b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_autograd_on_the_card_runs_dq_then_dkv_and_no_torch_delta(dtype, monkeypatch):
    """The backward on CUDA tensors is the two kernels alone: D comes from
    the dq kernel, never from ``_delta``'s torch reduction."""
    _need_card()

    def no_delta(*args):
        raise AssertionError("_delta ran on the card")

    monkeypatch.setattr(PA, "_delta", no_delta)
    x = [a.requires_grad_() for a in _bwd_inputs(201, 64, dtype, 11, kv_len=188)[:3]]
    out = PA.self_attention(*x, kv_len=188)
    _kernels.reset_launches()
    grads = torch.autograd.grad(out, x, torch.randn_like(out))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES == {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 1,
                                 "flash_attn_bwd_dkv": 1}
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"])
def test_kernels_launch_as_the_first_cuda_work_of_a_thread(kernel):
    """A new thread has no current CUDA context until something makes one
    current, and the tensor-map encoder needs one; PyTorch's autograd worker
    meets the dq kernel in that state.  Each bf16 kernel launches from a
    fresh thread all the same."""
    _need_card()
    q, k, v, o, do, lse = _bwd_inputs(199, 64, torch.bfloat16, 5, h=16)
    delta = PA._delta(o, do)
    calls = {"flash_attn_fwd": lambda: _kernels.flash_attn_fwd(q, k, v),
             "flash_attn_bwd_dq": lambda: _kernels.flash_attn_bwd_dq(q, k, v, o, do, lse),
             "flash_attn_bwd_dkv": lambda: _kernels.flash_attn_bwd_dkv(q, k, v, do, lse, delta)}
    want = calls[kernel]()
    got = {}

    def run():
        try:
            got["out"] = calls[kernel]()
            torch.cuda.synchronize()
        except Exception as e:  # handed to the test's thread
            got["error"] = e

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    assert "error" not in got, got.get("error")
    assert all(torch.equal(a, b) for a, b in zip(got["out"], want))


@pytest.mark.gpu
def test_dq_kernel_refuses_an_output_that_is_not_contiguous():
    """The saved O reaches the kernel as it is: a strided O raises, and is
    never copied on the way."""
    _need_card()
    q, k, v, o, do, lse = _bwd_inputs(64, 64, torch.bfloat16, 3)
    strided = o.transpose(1, 2).contiguous().transpose(1, 2)
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError, match="O must be contiguous"):
        _kernels.flash_attn_bwd_dq(q, k, v, strided, do, lse)
    assert _kernels.LAUNCHES == before


@pytest.mark.gpu
def test_autograd_on_the_card_goes_through_the_three_kernels():
    _need_card()
    q = torch.randn(1, 2, 40, 64, device="cuda", requires_grad=True)
    _kernels.reset_launches()
    out = PA.self_attention(q, q, q, kv_len=33)
    out.sum().backward()
    torch.cuda.synchronize()
    assert all(n == 1 for n in _kernels.LAUNCHES.values()), _kernels.LAUNCHES
    x = q.detach().clone().requires_grad_()
    PA.attention_reference(x, x, x, 33).sum().backward()
    assert (q.grad - x.grad).abs().max().item() < 1e-4


@pytest.mark.gpu
def test_train_steps_on_the_card_launch_every_kernel():
    _need_card()
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.engine import Engine
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

    ssl = XLSRConfig.tiny(compute_dtype="bfloat16", remat=True, remat_policy="attn")
    eng = Engine(LinearNLL(ssl=ssl, emb_dim=16, device="cuda"), TrainConfig())
    eng.init_state()
    rng = np.random.default_rng(0)
    labels = np.tile(np.array([1.0] * 5 + [0.0] * 6, np.float32), (2, 1))
    batches = [{"wav": (0.1 * rng.normal(size=(2, 11, 8000))).astype(np.float32),
                "labels": labels} for _ in range(2)]
    _kernels.reset_launches()
    metrics = eng.run_epoch(batches)
    assert all(np.isfinite(v) for v in metrics.values())
    assert _kernels.LAUNCHES == {"flash_attn_fwd": 8, "flash_attn_bwd_dq": 4,
                                 "flash_attn_bwd_dkv": 4}


@pytest.mark.gpu
def test_golden_scores_on_the_card(tmp_path):
    _need_card()
    from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
    from scl_deepfake_audio_detection_torch.data.loader import EvalLoader
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.params import load_jax_params
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train import scoring
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

    rng = np.random.default_rng(20240817)
    tt = np.arange(16000) / 16000.0
    wavs = [0.3 * np.sin(2 * np.pi * 440.0 * tt), 0.2 * rng.normal(size=16000),
            0.3 * np.sin(2 * np.pi * (200 + 800 * tt) * tt),
            0.25 * np.sin(2 * np.pi * 333.0 * tt[:5333])]
    utts = []
    for i, w in enumerate(wavs):
        save_wav(str(tmp_path / "eval" / f"g{i}.wav"), w.astype(np.float32))
        utts.append(f"g{i}.wav")
    tree, _ = ckpt.load(os.path.join(REPO, "tests", "golden", "mini_linear_nll.ckpt"))
    model = LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=16, device="cuda")
    load_jax_params(model, tree["params"]).eval()
    loader = EvalLoader(EvalDataset(utts, str(tmp_path), "repeat", cut=16000),
                        batch_size=2, num_workers=1)
    out = tmp_path / "scores.txt"
    _kernels.reset_launches()
    scoring.produce_evaluation_file(loader, lambda w: score_step(model, w), str(out))
    assert _kernels.LAUNCHES["flash_attn_fwd"] == 2 * 2  # layers x batches
    want = [ln.split() for ln in open(os.path.join(REPO, "tests", "golden",
                                                   "expected_scores.txt"))]
    got = [ln.split() for ln in out.read_text().splitlines()]
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got], float),
                               np.array([r[1:] for r in want], float), atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["tiny", "xlsr_300m"])
def test_bf16_eval_forward_on_the_card_goes_through_the_kernel(preset):
    _need_card()
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.engine import score_step

    wav = np.random.default_rng(0).normal(size=(4, 64600)).astype(np.float32) * 0.1
    scores = {}
    for impl in ("auto", "reference"):
        ssl = getattr(XLSRConfig, preset)(compute_dtype="bfloat16", attention_impl=impl)
        model = LinearNLL(ssl=ssl, device="cuda", seed=1)
        cast_matmul_params(model.eval(), torch.bfloat16)
        _kernels.reset_launches()
        scores[impl] = score_step(model, wav).cpu().numpy()
        n = _kernels.LAUNCHES["flash_attn_fwd"]
        assert n == (ssl.encoder_layers if impl == "auto" else 0)
    lp = scores["auto"]
    assert lp.shape == (4, 2) and np.isfinite(lp).all()
    assert np.abs(np.logaddexp(lp[:, 0], lp[:, 1])).max() < 1e-5
    assert np.abs(lp - scores["reference"]).max() < 5e-2


@pytest.mark.gpu
def test_cli_trains_the_tiny_preset_on_the_card(tmp_path):
    """The port's CLI, no mode flag, --device cuda: one epoch of two steps
    and one dev batch.  remat 'attn' recomputes the attention block in the
    backward, so each train step launches the forward twice per layer and
    dq and dk/dv once; the dev step launches the forward once per layer."""
    _need_card()
    from scl_deepfake_audio_detection_torch.cli import main
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

    rng = np.random.default_rng(0)
    utts = [f"u{i}.wav" for i in range(6)]
    for u in utts:
        n = int(rng.integers(6000, 10000))
        save_wav(str(tmp_path / "bonafide" / u), (0.2 * rng.normal(size=n)).astype(np.float32))
        save_wav(str(tmp_path / "vocoded" / f"hifigan_{u}"),
                 (0.2 * rng.normal(size=n)).astype(np.float32))
    save_wav(str(tmp_path / "musan" / "n.wav"), (0.1 * rng.normal(size=16000)).astype(np.float32))
    save_wav(str(tmp_path / "rirs" / "r.wav"), np.exp(-np.arange(800) / 120.0).astype(np.float32))
    os.makedirs(tmp_path / "scp")
    (tmp_path / "scp" / "train_bonafide.lst").write_text("\n".join(utts[:4]) + "\n")
    (tmp_path / "scp" / "dev_bonafide.lst").write_text("\n".join(utts[4:]) + "\n")
    cfg = tmp_path / "conf3_tiny.yaml"
    cfg.write_text(
        "model: {name: wav2vec2_linear_nll, loss_type: 1}\n"
        "data:\n  name: asvspoof_2019_augall_3\n  kwargs:\n"
        "    vocoders: ['hifigan']\n"
        "    augmentation_methods: [RawBoost12, background_noise_wrapper, reverb_wrapper]\n"
        "    num_additional_real: 1\n    trim_length: 8000\n"
        f"    noise_path: {tmp_path / 'musan'}\n    rir_path: {tmp_path / 'rirs'}\n")
    _kernels.reset_launches()
    rc = main(["--config", str(cfg), "--database_path", str(tmp_path), "--ssl_preset", "tiny",
               "--compute_dtype", "bfloat16", "--batch_size", "2", "--num_epochs", "1",
               "--num_workers", "2", "--out_dir", str(tmp_path / "out"), "--device", "cuda"])
    torch.cuda.synchronize()
    assert rc == 0
    layers, steps, dev = 2, 2, 1
    assert _kernels.LAUNCHES == {"flash_attn_fwd": 2 * layers * steps + layers * dev,
                                 "flash_attn_bwd_dq": layers * steps,
                                 "flash_attn_bwd_dkv": layers * steps}
    run_dir = tmp_path / "out" / os.listdir(tmp_path / "out")[0]
    rec = json.loads((run_dir / "metrics.jsonl").read_text().splitlines()[0])
    assert all(np.isfinite(v) for v in rec.values() if isinstance(v, float)), rec
    assert (run_dir / "last.ckpt").exists()


@pytest.mark.gpu
def test_the_serving_batcher_launches_the_forward_from_its_worker_thread():
    """``serving.MicroBatcher`` in front of ``score_step`` on the card: the
    worker thread, the only one that touches the device, launches the
    forward kernel once per layer per batch it counts, and every reply
    equals the same rows scored in one call on the main thread."""
    _need_card()
    from scl_deepfake_audio_detection_torch import serving
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.engine import score_step

    ssl = XLSRConfig.tiny(compute_dtype="bfloat16")
    model = cast_matmul_params(LinearNLL(ssl=ssl, device="cuda", seed=1).eval(),
                               torch.bfloat16)
    rows = np.random.default_rng(3).normal(size=(4, 64600)).astype(np.float32) * 0.1
    threads = set()

    def scorer(block):
        threads.add(threading.get_ident())
        return score_step(model, block)

    b = serving.MicroBatcher(scorer, cut=64600, batch_size=4, max_wait_ms=60e3)
    _kernels.reset_launches()
    try:
        got = [h.wait() for h in [b.submit_async(r) for r in rows]]
    finally:
        b.close()
    assert threads == {b._worker.ident} and b.batches == 1
    assert _kernels.LAUNCHES["flash_attn_fwd"] == ssl.encoder_layers * b.batches
    want = score_step(model, rows).float().cpu().numpy()
    np.testing.assert_array_equal(np.stack(got), want)


@pytest.mark.gpu
def test_exported_scorer_launches_the_flash_kernel_on_the_card(tmp_path):
    """An artifact exported on the CPU scores on the card through the Hopper
    flash forward, one launch per encoder layer and forward, within bf16
    rounding of its scores on the CPU."""
    _need_card()
    from scl_deepfake_audio_detection_torch.export import export_scorer, load_scorer
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig

    cfg = XLSRConfig.tiny(compute_dtype="bfloat16")
    export_scorer(LinearNLL(ssl=cfg, emb_dim=16, device="cpu", seed=0), str(tmp_path), cut=16000)
    wav = (0.1 * np.random.default_rng(0).normal(size=(3, 16000))).astype(np.float32)
    scorer = load_scorer(str(tmp_path), device="cuda")
    _kernels.reset_launches()
    got = scorer.score(wav)
    assert _kernels.LAUNCHES["flash_attn_fwd"] == cfg.encoder_layers
    want = load_scorer(str(tmp_path), device="cpu").score(wav)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["aasist", "resnet"])
def test_zoo_goldens_on_the_card(kind):
    """The committed tiny AASIST and ResNet goldens through the kernel, fp32:
    within 1e-4 of the JAX package's scores, 2 launches (layers) a forward."""
    _need_card()
    from scl_deepfake_audio_detection_torch.models.params import load_jax_params
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.registry import MODELS
    from seeded_params import seeded_tree

    golden = os.path.join(REPO, "tests", "golden")
    tree, meta = ckpt.load(os.path.join(golden, f"mini_{kind}.ckpt"))
    want = np.array([[float(v) for v in ln.split()[1:]]
                     for ln in open(os.path.join(golden, f"mini_{kind}_scores.txt"))])
    rng = np.random.default_rng(meta["wav_seed"])
    wav = [(0.1 * rng.normal(size=tuple(meta["wav_shape"]))).astype(np.float32)
           for _ in range(meta["train_forwards"] + 1)][-1]
    model = MODELS.get(meta["model"])(ssl=XLSRConfig.tiny(), device="cuda")
    load_jax_params(model, seeded_tree(model, meta["param_seed"]), tree["buffers"])
    _kernels.reset_launches()
    got = score_step(model, wav).double().cpu().numpy()
    assert _kernels.LAUNCHES["flash_attn_fwd"] == 2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["aasist", "resnet"])
def test_zoo_train_steps_on_the_card_move_the_statistics_once(kind):
    """bf16 train steps of the tiny zoo models under every remat policy:
    every kernel launched, the same running statistics under each policy
    (the head is outside the recomputed layers), eval leaves them."""
    _need_card()
    from scl_deepfake_audio_detection_torch.models.params import buffers_to_jax
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.engine import Engine
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig
    from scl_deepfake_audio_detection_torch.utils.registry import MODELS

    rng = np.random.default_rng(0)
    labels = np.tile(np.array([1.0] * 5 + [0.0] * 6, np.float32), (2, 1))
    batch = {"wav": (0.1 * rng.normal(size=(2, 11, 8000))).astype(np.float32),
             "labels": labels}
    stats = {}
    for policy in ("attn", "attn_ffn", "dots", "full"):
        ssl = XLSRConfig.tiny(compute_dtype="bfloat16", remat=True, remat_policy=policy)
        eng = Engine(MODELS.get(f"xlsr_{kind}")(ssl=ssl, device="cuda", seed=3), TrainConfig())
        eng.init_state()
        _kernels.reset_launches()
        metrics = eng.train_step(eng.place_batch(batch), eng.step_generator(0, 0))
        assert all(np.isfinite(float(v)) for v in metrics.values())
        assert _kernels.LAUNCHES == {"flash_attn_fwd": 4, "flash_attn_bwd_dq": 2,
                                     "flash_attn_bwd_dkv": 2}, policy
        stats[policy] = buffers_to_jax(eng.model)
        eng.eval_step(eng.place_batch(batch))
        after = buffers_to_jax(eng.model)
        for a, b in zip(_leaves(after), _leaves(stats[policy])):
            np.testing.assert_array_equal(a, b)
    for policy in ("attn_ffn", "dots", "full"):
        for a, b in zip(_leaves(stats[policy]), _leaves(stats["attn"])):
            np.testing.assert_array_equal(a, b, err_msg=policy)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["transformer", "gru", "conv", "light"])
def test_btse_forward_and_train_step_on_the_card_match_the_cpu(kind):
    """The tiny BTSE model, fp32 with TF32 off: the card's forward (tokens
    included) and one train step (the same dropout masks on both sides)
    against the CPU's plain path, every kernel launched (once a layer a
    step each, without remat); for the transformer, the committed BTSE golden through the
    kernel within 1e-4, its tokens equal to the golden's."""
    _need_card()
    from scl_deepfake_audio_detection_torch.dsp.biosegment import wav2bio
    from scl_deepfake_audio_detection_torch.models.btse import XLSRBtse
    from scl_deepfake_audio_detection_torch.models.params import load_jax_params, to_jax
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train.engine import Engine, score_step
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig
    from seeded_params import seeded_tree

    rng = np.random.default_rng(1)
    wav = (0.1 * rng.normal(size=(2, 4, 6400))).astype(np.float32)
    wav[:, :, 1600:3200] *= 0.01
    wav[:, 1:, 4800:5600] = 0.0
    batch = {"wav": wav, "labels": np.tile([1.0, 1.0, 0.0, 0.0], (2, 1)).astype(np.float32)}
    cpu = XLSRBtse(ssl=XLSRConfig.tiny(), bio_encoder_type=kind, device="cpu", seed=4)
    card = load_jax_params(XLSRBtse(ssl=XLSRConfig.tiny(), bio_encoder_type=kind,
                                    device="cuda"), to_jax(cpu))
    flat = wav.reshape(8, -1)
    assert torch.equal(wav2bio(torch.from_numpy(flat)), wav2bio(torch.from_numpy(flat).cuda()).cpu())
    _kernels.reset_launches()
    got = score_step(card, flat).cpu().numpy()
    assert _kernels.LAUNCHES["flash_attn_fwd"] == 2
    np.testing.assert_allclose(got, score_step(cpu, flat).numpy(), atol=1e-4, rtol=0)
    masks = [torch.from_numpy(rng.random(shape) < 1.0 - rate)
             for rate, shape in cpu.dropout_sites(8, 6400)]
    engines = [Engine(m, TrainConfig()) for m in (cpu, card)]
    metrics = []
    for eng in engines:
        eng.init_state()
        _kernels.reset_launches()
        metrics.append(eng.train_step(eng.place_batch(batch), eng.step_generator(0, 0),
                                      dropout_masks=masks))
    assert _kernels.LAUNCHES == {"flash_attn_fwd": 2, "flash_attn_bwd_dq": 2,
                                 "flash_attn_bwd_dkv": 2}
    for k, v in metrics[0].items():
        np.testing.assert_allclose(float(metrics[1][k]), float(v), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for (name, a), b in zip(cpu.named_parameters(), card.parameters()):
        np.testing.assert_allclose(b.detach().cpu().numpy(), a.detach().numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    if kind == "transformer":
        golden = os.path.join(REPO, "tests", "golden")
        _, meta = ckpt.load(os.path.join(golden, "mini_btse.ckpt"))
        want = np.array([[float(v) for v in ln.split()[1:]]
                         for ln in open(os.path.join(golden, "mini_btse_scores.txt"))])
        g = np.random.default_rng(meta["wav_seed"])
        x = (0.1 * g.normal(size=tuple(meta["wav_shape"]))).astype(np.float32)
        for row, start, end, factor in meta["stretches"]:
            x[row, start:end] *= np.float32(factor)
        model = XLSRBtse(ssl=XLSRConfig.tiny(), device="cuda")
        load_jax_params(model, seeded_tree(model, meta["param_seed"]))
        assert wav2bio(torch.from_numpy(x).cuda()).tolist() == meta["tokens"]
        np.testing.assert_allclose(score_step(model, x).double().cpu().numpy(), want,
                                   atol=1e-4, rtol=0)


def _assert_grads_close(got, want):
    """``got`` within rtol 1e-5 plus 5e-4 of each leaf's largest entry of
    ``want`` (``tests/zoo_pins.py``'s rule, which imports JAX and so is not
    imported here); a leaf whose largest entry is at most 5e-5 of its part's
    (the SSL encoder or the head) is zero by structure and held to 5e-5 of
    the part."""
    part = lambda n: "ssl" if n.startswith("ssl.") else "head"  # noqa: E731
    top = {}
    for n, w in want.items():
        top[part(n)] = max(top.get(part(n), 0.0), w.abs().max().item())
    for n, w in want.items():
        w = w.double()
        s = w.abs().max().item()
        floor = 5e-5 * top[part(n)]
        tol = torch.full_like(w, floor) if s <= floor else 1e-5 * w.abs() + 5e-4 * s
        diff = (got[n].double() - w).abs()
        assert not bool((diff > tol).any()), (n, diff.max().item(), s)


@pytest.mark.gpu
def test_distillation_step_on_the_card_matches_the_plain_versions():
    """One distillation step of the tiny teacher and the one-layer student of
    head dim 96 (``tests/test_torch_distill.py``'s) on the card, fp32 with
    TF32 off, against the same step on the CPU (the plain versions): the
    metrics within 1e-5, the gradient of every student leaf as the update
    consumes it (so the dq and dk/dv kernels at d = 96 are held, not only
    the forward) within rtol 1e-5 plus 5e-4 of the leaf's largest entry
    (fp32, summation order), the student's parameters after the update
    within 1e-5, the teacher unchanged, and each kernel launched once a
    layer (2 teacher and 1 student forward, 1 dq, 1 dk/dv)."""
    _need_card()
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import distill as D
    from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
    from seeded_params import seeded_tree

    rng = np.random.default_rng(5)
    batch = {"wav": (0.2 * rng.normal(size=(2, 4, 4000))).astype(np.float32),
             "labels": np.tile([1.0, 1.0, 0.0, 0.0], (2, 1)).astype(np.float32)}
    runs = {}
    for device in ("cuda", "cpu"):
        teacher = LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=16, device=device)
        student = LinearNLL(ssl=XLSRConfig.tiny(encoder_dim=192, num_heads=2,
                                                encoder_layers=1),
                            emb_dim=16, dropout=0.0, device=device)
        assert student.ssl.cfg.head_dim == 96
        eng = D.DistillEngine(teacher, student, D.DistillConfig(emb_loss_weight=0.1))
        eng.init_state(seeded_tree(teacher, 3), seeded_tree(student, 5))
        set_learning_rate(eng.optimizer, 1e-6)
        grads, real_step = {}, eng.optimizer.step

        def spy(grads=grads, opt=eng.optimizer, real_step=real_step):
            grads.update({n: p.grad.detach().cpu().clone()
                          for n, p in zip(opt.names, opt.params)})
            return real_step()

        eng.optimizer.step = spy
        t_before = {n: p.detach().clone() for n, p in teacher.named_parameters()}
        _kernels.reset_launches()
        metrics = eng.run_epoch([batch])
        torch.cuda.synchronize()
        assert all(torch.equal(p, t_before[n]) for n, p in teacher.named_parameters())
        runs[device] = (metrics, grads,
                        {n: p.detach().cpu() for n, p in student.named_parameters()},
                        dict(_kernels.LAUNCHES))
    (m, g, p, launches), (m_ref, g_ref, p_ref, launches_ref) = runs["cuda"], runs["cpu"]
    assert launches == {"flash_attn_fwd": 3, "flash_attn_bwd_dq": 1, "flash_attn_bwd_dkv": 1}
    assert not any(launches_ref.values())
    assert sorted(m) == sorted(m_ref)
    for k in m_ref:
        assert m[k] == pytest.approx(m_ref[k], rel=1e-5, abs=1e-5), k
    assert sorted(g) == sorted(g_ref) == sorted(p_ref)
    _assert_grads_close(g, g_ref)
    for n in p_ref:
        assert (p[n] - p_ref[n]).abs().max().item() <= 1e-5, n


@pytest.mark.gpu
def test_nccl_group_of_one_zero1_step_equals_the_plain_step():
    """A process group of one over NCCL, the mesh (1, 1) and ZeRO-1 (which
    splits nothing over one data rank): the train step is the plain one."""
    _need_card()
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.parallel import mesh as M
    from scl_deepfake_audio_detection_torch.train.engine import Engine
    from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

    rng = np.random.default_rng(0)
    batch = {"wav": (0.2 * rng.normal(size=(2, 4, 8000))).astype(np.float32),
             "labels": np.tile(np.array([1, 1, 0, 0], np.float32), (2, 1))}
    params = {}
    for label in ("plain", "nccl"):
        if label == "nccl":
            M.init_process_group("cuda")
            assert torch.distributed.get_backend() == "nccl"
        try:
            cfg = TrainConfig(seed=7) if label == "plain" else \
                TrainConfig(seed=7, mesh_shape=[1, 1], zero1=True, zero1_min_size=1)
            eng = Engine(LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=16, device="cuda", seed=3),
                         cfg)
            eng.init_state()
            set_learning_rate(eng.optimizer, 1e-4)
            for i in range(2):
                eng.train_step(eng.place_batch(batch), eng.step_generator(0, i))
            assert (eng.mesh is None) == (label == "plain")
            params[label] = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
        finally:
            M.leave()
    for n, p in params["plain"].items():
        assert torch.equal(p, params["nccl"][n]), n


@pytest.mark.gpu
def test_tensor_parallel_layer_at_8_heads_a_rank_matches_the_full_layer(tmp_path, monkeypatch):
    """An XLS-R 300M encoder layer split over two ranks on one card (gloo,
    which lets two ranks share a card): each rank runs 8 heads of 64
    through the three kernels (one launch each), and its output and input
    gradient are the whole layer's within the bf16 bound of the smoke's
    autograd check (2^-5 of the largest)."""
    _need_card()
    import torch_parallel_ranks as R
    from scl_deepfake_audio_detection_torch.parallel import mesh as M

    layer, x = R._seeded_layer("cuda")
    x.requires_grad_(True)
    y = layer(x)
    y.float().square().sum().backward()
    want_y, want_dx = y.detach().float().cpu(), x.grad.float().cpu()
    monkeypatch.setenv("SCL_DIST_BACKEND", "gloo")
    assert M.launch(R.tp_layer_rank, 2, args=(str(tmp_path),), timeout=600) == [0, 0]
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert got["heads"] == 8
        assert got["launches"] == {"flash_attn_fwd": 1, "flash_attn_bwd_dq": 1,
                                   "flash_attn_bwd_dkv": 1}, got["launches"]
        for a, w in ((got["y"], want_y), (got["dx"], want_dx)):
            assert float((a - w).abs().max()) <= 2.0 ** -5 * float(w.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["gan", "wgan", "aux"])
def test_gan_steps_on_the_card_match_the_cpu(mode, tmp_path):
    """``train/gan.GANEngine`` with the JAX package's test MLPs: 3 steps on the
    card within 1e-5 of the same steps on the CPU (fp32, TF32 off), and the
    card's ``gan_last.ckpt`` loads into fresh nets on the card unchanged."""
    _need_card()
    import copy

    import torch_parallel_ranks as R
    from scl_deepfake_audio_detection_torch.models.base import init_parameters
    from scl_deepfake_audio_detection_torch.models.params import to_jax
    from scl_deepfake_audio_detection_torch.train import gan as GAN
    from scl_deepfake_audio_detection_torch.utils.tree import flatten

    kw = {"gan": {}, "wgan": {"mode": "wgan", "n_critic": 3},
          "aux": {"aux_loss_fn": GAN.mse_aux}}[mode]
    sg, sd = R.GAN_SIZES
    gen0, disc0 = R.MLP(sg), R.MLP(sd, True)
    init_parameters(gen0, torch.Generator().manual_seed(1))
    init_parameters(disc0, torch.Generator().manual_seed(2))
    engs = {}
    for dev in ("cuda", "cpu"):
        engs[dev] = GAN.GANEngine(copy.deepcopy(gen0).to(dev), copy.deepcopy(disc0).to(dev),
                                  sg[0], lr_g=1e-3, lr_d=1e-3, **kw)
        engs[dev].fit(R.gan_batches, 1, save_dir=str(tmp_path / dev))
    for net in ("gen", "disc"):
        got = flatten(to_jax(getattr(engs["cuda"], net)))
        want = flatten(to_jax(getattr(engs["cpu"], net)))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    back = GAN.GANEngine(R.MLP(sg).cuda(), R.MLP(sd, True).cuda(), sg[0], **kw)
    assert back.load(str(tmp_path / "cuda" / "gan_last.ckpt")) == {"epoch": 0}
    for a, b in zip(back.gen.state_dict().values(), engs["cuda"].gen.state_dict().values()):
        assert torch.equal(a, b)


def _card_vs_cpu(model, fn, x, atol, grad_rtol):
    """``fn(model, x)`` -> a tensor or a tuple of them, run on a copy of
    ``model`` on the card and on the CPU: outputs and buffers within
    ``atol`` of their largest entry (or of 1), and the parameter and input
    gradients of a seeded weighting of the outputs within ``grad_rtol`` of
    each leaf's largest, a leaf below ``grad_rtol`` of the largest of all
    (zero up to rounding, such as the key bias ahead of the softmax) within
    ``grad_rtol`` of that."""
    import copy

    runs = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        xd = x.detach().clone().to(dev).requires_grad_(True)
        out = fn(m, xd)
        out = out if isinstance(out, tuple) else (out,)
        gen = torch.Generator().manual_seed(3)
        sum((o.float() * torch.randn(o.shape, generator=gen).to(dev)).sum() for o in out).backward()
        grads = {n: p.grad for n, p in m.named_parameters()}
        grads["x"] = xd.grad
        runs[dev] = ([o.detach().cpu() for o in out], {k: g.cpu() for k, g in grads.items()},
                     {k: b.cpu() for k, b in m.named_buffers()})
    (out_c, g_c, b_c), (out_p, g_p, b_p) = runs["cuda"], runs["cpu"]
    for a, w in zip(out_c, out_p):
        assert float((a - w).abs().max()) <= atol * max(float(w.abs().max()), 1.0)
    top = max(float(g.abs().max()) for g in g_p.values())
    for k in g_p:
        scale = max(float(g_p[k].abs().max()), grad_rtol * top)
        err = float((g_c[k] - g_p[k]).abs().max()) / scale
        assert err <= grad_rtol, (k, err)
    for k in b_p:
        assert float((b_c[k] - b_p[k]).abs().max()) <= atol * max(float(b_p[k].abs().max()), 1.0), k


@pytest.mark.gpu
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_conformer_on_the_card_matches_the_cpu(train):
    """``models/conformer`` at tiny width on the card against the CPU on the
    same weights (fp32, TF32 off): output and running statistics within
    1e-5, gradients within 1e-3 of each leaf's largest (``phase_g3``'s
    rule; the card's sums run in another order)."""
    _need_card()
    from scl_deepfake_audio_detection_torch.models.base import init_parameters
    from scl_deepfake_audio_detection_torch.models.conformer import Conformer, ConformerConfig

    model = init_parameters(Conformer(ConformerConfig(dim=32, depth=2, dim_head=8, heads=4,
                                                      conv_kernel=7, max_pos_emb=8)),
                            torch.Generator().manual_seed(0))
    x = torch.randn(2, 21, 32, generator=torch.Generator().manual_seed(1))
    _card_vs_cpu(model, lambda m, xx: m(xx, train=train), x, 1e-5, 1e-3)


@pytest.mark.gpu
def test_conv_flow_on_the_card_matches_the_cpu_and_inverts():
    """``ops/flows.ConvFlow`` at tiny width (its projection seeded, not zero)
    with a ragged mask on the card against the CPU: output, log-det and
    gradients as above, and its reverse undoes its forward within 1e-4."""
    _need_card()
    from scl_deepfake_audio_detection_torch.models.base import init_parameters
    from scl_deepfake_audio_detection_torch.ops.flows import ConvFlow

    g = torch.Generator().manual_seed(2)
    model = init_parameters(ConvFlow(4, 16, 3, 3, num_bins=10, tail_bound=5.0), g)
    with torch.no_grad():
        model.proj.weight.normal_(0.0, 0.05, generator=g)
    x = 2.0 * torch.randn(2, 17, 4, generator=g)
    mask = (torch.arange(17)[None, :] < torch.tensor([17, 11])[:, None]).float()[..., None]
    _card_vs_cpu(model, lambda m, xx: m(xx, mask.to(xx.device)), x, 1e-5, 1e-3)
    m = model.cuda()
    y, _ = m(x.cuda(), mask.cuda())
    back = m(y, mask.cuda(), reverse=True)
    assert float((back.cpu() - x * mask).abs().max()) <= 1e-4
