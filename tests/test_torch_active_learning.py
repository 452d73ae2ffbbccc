"""The port's ``train/active_learning`` against the JAX package's: the same
pool scores give the same selections, training sets, selection-cache files
(byte for byte) and resumes; each package resumes from the other's cache.
One loop scores its pool with the port's tiny LinearNLL through
``train/engine.score_step`` against the JAX model on the same parameters
(log-probabilities within 1e-5, selections exact)."""

import json

import numpy as np
import pytest
import torch

import jax

from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.train import active_learning as JA
from scl_deepfake_audio_detection_torch.models import xlsr as PX
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.params import load_jax_params
from scl_deepfake_audio_detection_torch.train import active_learning as PA
from scl_deepfake_audio_detection_torch.train.engine import score_step

torch.set_num_threads(2)
POOL = list(range(10, 34))


def _synthetic_scores(idx):
    """Log-probs whose certainty falls with the index, with a few ties."""
    p1 = np.array([0.5 + 0.45 * ((i * 7) % 13) / 13.0 for i in idx])
    return np.log(np.stack([1 - p1, p1], axis=1))


def _run(mod, cfg_kw, train=(0, 1), pool=POOL, score=_synthetic_scores):
    trained, logged = [], []
    state = mod.al_loop(mod.ALConfig(**cfg_kw), list(train), list(pool),
                        lambda idx, n: trained.append((list(idx), n)), score,
                        lambda c, m: logged.append((c, m)))
    return state, trained, logged


def _same_state(p, j):
    assert (p.train_idx, p.pool_idx, p.history) == (j.train_idx, j.pool_idx, j.history)


@pytest.mark.parametrize("criterion", ["entropy", "margin", "random"])
@pytest.mark.parametrize("replace,new_only,pre", [(False, False, 0), (True, True, 2),
                                                  (False, True, 1)])
def test_selections_and_cache_equal_the_jax_loop(tmp_path, criterion, replace, new_only, pre):
    out = {}
    for tag, mod in (("jax", JA), ("port", PA)):
        kw = dict(cycles=3, samples_per_cycle=5, epochs_per_cycle=2, criterion=criterion,
                  with_replacement=replace, use_new_data_only=new_only,
                  pre_train_epochs=pre, seed=11, cache_path=str(tmp_path / f"{tag}.json"))
        out[tag] = _run(mod, kw)
    (ps, pt, pl), (js, jt, jl) = out["port"], out["jax"]
    _same_state(ps, js)
    assert pt == jt and pl == jl
    with open(tmp_path / "port.json", "rb") as f, open(tmp_path / "jax.json", "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("criterion", ["entropy", "random"])
def test_resume_from_either_cache_equals_the_uninterrupted_jax_run(tmp_path, criterion):
    kw = dict(samples_per_cycle=4, criterion=criterion, seed=3)
    full, _, _ = _run(JA, dict(cycles=3, cache_path=str(tmp_path / "full.json"), **kw))
    for k, (first, then) in enumerate(((PA, JA), (JA, PA), (PA, PA))):
        cache = str(tmp_path / f"resume{k}.json")
        _run(first, dict(cycles=1, cache_path=cache, **kw))
        resumed, trained, _ = _run(then, dict(cycles=3, cache_path=cache,
                                              pre_train_epochs=4, **kw), train=[99])
        _same_state(resumed, full)
        assert len(trained) == 2  # cycles 1 and 2 only; no pre-training on resume


def test_criteria_and_state_equal_the_jax_ones(tmp_path):
    with np.errstate(divide="ignore"):  # a saturated row: log(0) = -inf
        lp = np.log(np.array([[0.5, 0.5], [1.0, 0.0], [0.9, 0.1], [0.2, 0.8]]))
    for name in ("entropy", "margin", "random"):
        got = PA.CRITERIA[name](lp, np.random.default_rng(1))
        want = JA.CRITERIA[name](lp, np.random.default_rng(1))
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(PA.criterion_entropy(lp, None)).all()
    assert PA.select_from_pool([0.1, 0.9, 0.9, 0.3], [5, 6, 7, 8], 3) == \
        JA.select_from_pool([0.1, 0.9, 0.9, 0.3], [5, 6, 7, 8], 3) == [6, 7, 8]
    path = str(tmp_path / "s.json")
    PA.ALState([1, 2], [3], [[2]]).save(path)
    back = JA.ALState.load(path)
    assert (back.train_idx, back.pool_idx, back.history) == ([1, 2], [3], [[2]])
    with open(path) as f:
        assert json.load(f) == {"train": [1, 2], "pool": [3], "history": [[2]]}


@pytest.fixture(scope="module")
def scored_pool():
    """24 clips scored by the port's tiny LinearNLL and by the JAX model on
    the same parameters."""
    rng = np.random.default_rng(8)
    wav = (rng.standard_normal((24, 4000)) * np.linspace(0.05, 0.6, 24)[:, None]).astype(
        np.float32)
    jm = JLinearNLL(ssl=JX.XLSRConfig.tiny(), emb_dim=16)
    params = jm.init(jax.random.key(2))
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    model.eval()
    japply = jax.jit(lambda p, x: jm.apply(p, x, train=False).log_probs)
    return (wav, lambda idx: score_step(model, wav[np.asarray(idx)]).numpy(),
            lambda idx: np.asarray(japply(params, wav[np.asarray(idx)])))


@pytest.mark.parametrize("criterion", ["entropy", "margin"])
def test_pool_scored_by_the_port_model_selects_as_the_jax_model(tmp_path, scored_pool,
                                                                 criterion):
    wav, port_score, jax_score = scored_pool
    pool = list(range(24))
    np.testing.assert_allclose(port_score(pool), jax_score(pool), rtol=1e-5, atol=1e-5)
    kw = dict(cycles=3, samples_per_cycle=6, criterion=criterion, seed=4)
    ps, pt, _ = _run(PA, dict(cache_path=str(tmp_path / "p.json"), **kw), train=[],
                     pool=pool, score=port_score)
    js, jt, _ = _run(JA, dict(cache_path=str(tmp_path / "j.json"), **kw), train=[],
                     pool=pool, score=jax_score)
    _same_state(ps, js)
    assert pt == jt
