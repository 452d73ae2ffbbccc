"""The frozen arithmetic: FLOPs of the conf-3 forward and step, the
attention kernels' bytes, and agreement with the port's ``utils/flops``
where both count the same thing."""

import json

import pytest

from portbench.harness import flops
from portbench.tests.tiny import REPO


def _cfg(name):
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())


def test_conf3_forward_and_step_flops():
    cfg = _cfg("xlsr300m-linearnll")
    assert flops.forward_flops(cfg, 64600, 16) / 1e12 == pytest.approx(2.381, abs=5e-4)
    assert flops.train_step_flops(cfg, 64000, 22) / 1e12 == pytest.approx(9.724, abs=5e-4)
    assert flops.num_frames(cfg["ssl"], 64600) == 201
    assert flops.num_frames(cfg["ssl"], 64000) == 199


def test_attention_bytes_and_flops():
    fwd_bytes, fwd_flops = flops.flash_fwd_work(16, 16, 201, 64)
    assert fwd_bytes / 1e6 == pytest.approx(26.55, abs=5e-3)
    assert fwd_flops / 1e9 == pytest.approx(2.648, abs=5e-4)
    bwd_bytes, bwd_flops = flops.flash_bwd_work(22, 16, 199, 64)
    assert bwd_bytes / 2 / 1e6 == pytest.approx(54.36, abs=5e-3)  # dq, and dk/dv, each
    assert bwd_flops / 1e9 == pytest.approx(5.353 + 7.137, abs=1e-3)
    assert flops.bound_seconds(fwd_bytes, fwd_flops) == pytest.approx(fwd_bytes / 3.35e12)


@pytest.mark.parametrize("samples,batch", [(64600, 16), (64000, 22), (100000, 3)])
def test_frozen_copy_matches_the_port(samples, batch):
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.utils import flops as port

    cfg = _cfg("xlsr300m-linearnll")
    assert flops.forward_flops(cfg, samples, batch) == port.forward_flops(
        XLSRConfig.xlsr_300m(), samples, batch)
    assert flops.PEAK_BF16_FLOPS == port.PUBLISHED_H100_BF16_PEAK_FLOPS


def test_aasist_head_counts_its_convs():
    lin, aa = _cfg("xlsr300m-linearnll"), _cfg("xlsr300m-aasist")
    extra = flops.forward_flops(aa, 64600, 1) - flops.forward_flops(lin, 64600, 1)
    assert 1.0e9 < extra < 2.0e9  # ~1.37 GFLOP a clip over LinearNLL's ~0.06
