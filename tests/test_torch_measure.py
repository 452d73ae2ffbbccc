"""The port's ``utils/measure`` on the tiny LinearNLL on the CPU: the
eval helper's arithmetic (utt/s x ms/iter = batch x 1000), its call count
(warmup + iters forwards), its chained outputs (each within 1e-6 of a plain
``score_step`` on the same input: the feed is 1e-30 of a log-prob); the
train helper's step count (2 k1 + k2 steps: a warm run, then k1 and k2)
and the engine's state after it, bit-equal to before; and the device rule
of the port's entry points (no card and no ``device``: they raise)."""

import numpy as np
import pytest
import torch

from scl_deepfake_audio_detection_torch.models import xlsr as PX
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.train import engine as PE
from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
from scl_deepfake_audio_detection_torch.utils import measure
from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    return LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, device="cpu", seed=3).eval()


def _wav(b=3, t=4000, seed=0):
    return (0.2 * np.random.default_rng(seed).standard_normal((b, t))).astype(np.float32)


@pytest.mark.parametrize("warmup,iters", [(1, 1), (1, 3), (3, 2)])
def test_chained_eval_counts_chains_and_times(model, monkeypatch, warmup, iters):
    wav = _wav()
    seen = []

    def spy(m, x):
        out = PE.score_step(m, x)
        seen.append((x.clone(), out.clone()))
        return out

    monkeypatch.setattr(measure, "score_step", spy)
    ups, ms = measure.chained_eval_throughput(model, wav, iters, warmup, device="cpu")
    assert len(seen) == warmup + iters
    assert ups * ms == pytest.approx(wav.shape[0] * 1000, rel=1e-9)
    plain = PE.score_step(model, wav)
    for i, (x, out) in enumerate(seen):
        np.testing.assert_allclose(x.numpy(), wav, rtol=0, atol=1e-20)
        np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)
        if i:  # each input carries the previous output's feed
            assert torch.equal(x, torch.as_tensor(wav) + seen[i - 1][1][0, 0] * 1e-30)


def test_chained_eval_takes_int16_wire(model):
    wav = np.round(_wav() * 32767).astype(np.int16)
    ups, ms = measure.chained_eval_throughput(model, wav, 1, 1, device="cpu")
    assert ups > 0 and ms > 0


def _engine(steps_before):
    batch = {"wav": _wav(4, 4000, 1).reshape(1, 4, 4000),
             "labels": np.array([[1, 1, 0, 0]], np.float32)}
    eng = PE.Engine(LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, device="cpu", seed=5),
                    TrainConfig())
    eng.init_state()
    set_learning_rate(eng.optimizer, 1e-3)
    for i in range(steps_before):
        eng.train_step(eng.place_batch(batch), eng.step_generator(9, i))
    return eng, batch


def _state(eng):
    opt = eng.optimizer
    adam = [{k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in st.items()}
            for st in (opt.adamw.state.get(t, {}) for t in opt.targets)]
    return ({k: v.clone() for k, v in eng.model.state_dict().items()}, adam,
            opt.mini_step, opt.lr)


def _bit_equal(a, b):
    (ma, aa, sa, la), (mb, ab, sb, lb) = a, b
    assert ma.keys() == mb.keys() and sa == sb and la == lb
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert len(aa) == len(ab)
    for x, y in zip(aa, ab):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(torch.as_tensor(x[k]), torch.as_tensor(y[k])), k


@pytest.mark.parametrize("steps_before", [0, 2])
def test_train_ms_per_step_leaves_the_engine_bit_equal(monkeypatch, steps_before):
    eng, batch = _engine(steps_before)
    before = _state(eng)
    calls = []
    real = eng.train_step

    def counted(b, g):
        calls.append(g.initial_seed())
        return real(b, g)

    monkeypatch.setattr(eng, "train_step", counted)
    ms = measure.train_ms_per_step(eng, batch, k1=1, k2=3, device="cpu")
    assert np.isfinite(ms)
    assert len(calls) == 2 * 1 + 3
    # every run starts again from step 0 of the same generators
    assert calls == [eng.step_generator(0, i).initial_seed() for i in (0, 0, 0, 1, 2)]
    _bit_equal(_state(eng), before)
    # and the engine trains on from there exactly as an unmeasured twin does
    twin, _ = _engine(steps_before)
    for e in (eng, twin):
        real_step = e.train_step if e is twin else real
        real_step(e.place_batch(batch), e.step_generator(1, 0))
    _bit_equal(_state(eng), _state(twin))


def test_measures_need_the_card_unless_asked_for_the_cpu(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.chained_eval_throughput(model, _wav(), 1)
    eng, batch = _engine(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.train_ms_per_step(eng, batch, 1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.train_ms_per_step(eng, batch, 1, 2, device="cuda")
