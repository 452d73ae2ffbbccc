"""The port's ``utils/flops`` against the JAX package's: the analytic counts
are exact integers and must be equal, preset for preset, at the eval crop
(64600 samples) and the training crop (64000).  The port's MFU denominator
is the H100's published bf16 peak, and no TPU rate appears in the port."""

import os
import re

import pytest

from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.utils import flops as JF
from scl_deepfake_audio_detection_torch.models import xlsr as PX
from scl_deepfake_audio_detection_torch.utils import flops as PF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ["tiny", "xlsr_300m", "student_base", "xlsr_1b", "xlsr_2b"]
SAMPLES = [64000, 64600]


def _cfgs(preset):
    return getattr(JX.XLSRConfig, preset)(), getattr(PX.XLSRConfig, preset)()


@pytest.mark.parametrize("samples", SAMPLES)
@pytest.mark.parametrize("preset", PRESETS)
def test_counts_equal_the_jax_package(preset, samples):
    jc, pc = _cfgs(preset)
    frames = pc.num_frames(samples)
    assert frames == jc.num_frames(samples)
    pairs = [
        (PF.conv_encoder_flops(pc, samples), JF.conv_encoder_flops(jc, samples)),
        (PF.encoder_flops(pc, frames), JF.encoder_flops(jc, frames)),
        (PF.linear_nll_head_flops(pc, frames), JF.linear_nll_head_flops(jc, frames)),
        (PF.forward_flops(pc, samples), JF.forward_flops(jc, samples)),
        (PF.forward_flops(pc, samples, batch=16, include_head=False),
         JF.forward_flops(jc, samples, batch=16, include_head=False)),
        (PF.train_step_flops(pc, samples, 22), JF.train_step_flops(jc, samples, 22)),
    ]
    for got, want in pairs:
        assert isinstance(got, int) and got == want


@pytest.mark.parametrize("preset", PRESETS)
def test_train_step_is_three_forwards(preset):
    _, pc = _cfgs(preset)
    assert PF.train_step_flops(pc, 64000, 22) == 3 * PF.forward_flops(pc, 64000, batch=22)


def test_mfu_divides_by_the_h100_peak():
    assert PF.PUBLISHED_H100_BF16_PEAK_FLOPS == 989.4e12
    assert PF.mfu(989.4e12, 1.0) == pytest.approx(1.0, rel=1e-12)
    assert PF.mfu(2e12, 0.5, peak=8e12) == pytest.approx(0.5, rel=1e-12)
    rate = PF.MEASURED_ATTAINABLE_H100_BF16_FLOPS
    assert 0 < rate <= PF.PUBLISHED_H100_BF16_PEAK_FLOPS


def test_no_tpu_rate_in_the_port():
    """The v5e's published peak (197e12) and its measured GEMM rate (190e12)
    belong to the JAX package; no file of the port carries either."""
    pat = re.compile(r"\b(197|190)(\.0)?e12\b|\b19[07]\s*TFLOP", re.I)
    root = os.path.join(REPO, "scl_deepfake_audio_detection_torch")
    hits = []
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(d, f), errors="replace") as fh:
                    hits += [f"{f}: {ln.strip()}" for ln in fh if pat.search(ln)]
    assert not hits, hits
