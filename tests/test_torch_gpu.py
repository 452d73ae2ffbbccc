"""Tests of the port that need an NVIDIA GPU: the hand-written kernel
against its plain version, and the eval path on the card.  Marked ``gpu``;
each decides in its body whether a card is present and skips without one.
Run them on a machine with a card: ``python -m pytest -m gpu tests/test_torch_*.py``.

Tolerances as in ``chip_smoke.py``: fp32 differs by summation order (O 2e-5,
LSE 1e-5; TF32 off); in bf16 P is rounded at the kernel's running max and
O is rounded to bf16, so O is held to 3e-2 and LSE to 1e-4."""

import os

import numpy as np
import pytest
import torch

from scl_deepfake_audio_detection_torch.ops import _kernels
from scl_deepfake_audio_detection_torch.ops import attention as PA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (3e-2, 1e-4)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (Hopper, sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [8, 64, 80, 96, 120, 128])
@pytest.mark.parametrize("t,kv_len", [(1, None), (199, None), (201, 188), (1024, 1011)])
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
def test_flash_forward_refuses_autograd_on_the_card():
    _need_card()
    q = torch.zeros(1, 1, 8, 8, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward not ported"):
        PA.flash_attention_forward(q, q, q)
    with torch.no_grad():
        PA.flash_attention_forward(q, q, q)


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
