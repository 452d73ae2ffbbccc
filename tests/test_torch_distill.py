"""The port's distillation trainer (``train/distill``) against the JAX
package's, on the CPU: a tiny teacher (XLS-R tiny, head dim 8) and a
one-layer student 192 wide with 2 heads, so that the student's attention
runs at head dim 96 (``student_base``'s) through the plain versions.

- one step's loss terms and metrics, and the gradient of every student
  leaf, for alpha in {0, 0.5, 1} with the cosine embedding term off and on,
  on [G, V, T] view batches, with the JAX package's own head-dropout draws
  handed to the port;
- the student's parameters and AdamW's first moment after two steps, the
  same learning rate set on both;
- ``DistillEngine``'s guards (alpha out of [0, 1], a batch-norm student);
- the committed golden ``tests/golden/mini_distill*`` (two steps' metrics
  and the student's scores afterwards), rebuilt by the JAX package and
  reproduced by the port.

The JAX step is ``train/distill._distill_step`` written out so that it also
returns its gradients, jitted once for each embedding weight with alpha an
argument; the JAX model takes the port's ReLU and LeakyReLU signs
(``tests/zoo_pins.py``: an input within a rounding error of 0 can fall on
either side and move every gradient before it), passed as arguments of the
jitted step.

Tolerances, with their reasons:
- loss terms and metrics: rtol 1e-5 / atol 1e-5 (fp32, another summation
  order);
- gradients and AdamW's first moment (linear in the gradients): leaf by
  leaf, rtol 1e-5 plus 5e-4 of the leaf's largest entry
  (``zoo_pins.assert_grads_close``, as ``tests/test_torch_zoo_grads.py``);
- parameters: rtol 1e-5 / atol 1e-5, except entries whose first moment is
  zero up to rounding (the attention key bias: a softmax removes it), which
  AdamW moves by up to a step either way and which are held within two
  steps (2 x LR), as ``tests/test_torch_zoo.py``;
- the golden: the JAX rebuild equal to the committed files within 1e-6, the
  port within 1e-5 (1e-4 on the card, ``chip_smoke.py``)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.dsp.pad import pad_eval as jpad_eval
from scl_deepfake_audio_detection_tpu.models.aasist import XLSRAasist as JAasist
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.models.xlsr import XLSRConfig as JXC
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_tpu.train import distill as JD
from scl_deepfake_audio_detection_tpu.train.optim import make_optimizer as jmake_optimizer
from scl_deepfake_audio_detection_tpu.train.optim import set_learning_rate as jset_lr
from scl_deepfake_audio_detection_torch.dsp.pad import pad_eval
from scl_deepfake_audio_detection_torch.models.aasist import XLSRAasist
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.params import from_jax
from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt
from scl_deepfake_audio_detection_torch.train import distill as PD
from scl_deepfake_audio_detection_torch.train.engine import score_step
from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate

import zoo_pins
from seeded_params import seeded_tree

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_cli_eval.py
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
# one encoder layer, 192 wide, 2 heads: head dim 96, as student_base's 768 / 8
STUDENT_SSL = dict(encoder_dim=192, num_heads=2, encoder_layers=1)
EMB, LR, EMB_W = 16, 1e-4, 0.5
TOL = dict(rtol=1e-5, atol=1e-5)


def _models(dropout=0.5):
    """(port teacher, port student, JAX teacher, JAX student) on the CPU, fp32."""
    pt = LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=EMB, device="cpu")
    ps = LinearNLL(ssl=XLSRConfig.tiny(**STUDENT_SSL), emb_dim=EMB, dropout=dropout,
                   device="cpu")
    jt = JLinearNLL(ssl=JXC.tiny(), emb_dim=EMB)
    js = JLinearNLL(ssl=JXC.tiny(**STUDENT_SSL), emb_dim=EMB, dropout=dropout)
    return pt, ps, jt, js


def _batches(n=2, t=4000, seed=11):
    rng = np.random.default_rng(seed)
    labels = np.tile([1.0, 1.0, 0.0, 0.0], (2, 1)).astype(np.float32)
    return [{"wav": (0.2 * rng.normal(size=(2, 4, t))).astype(np.float32), "labels": labels}
            for _ in range(n)]


def _head_masks(key, n, t):
    """The student's head-dropout masks in a JAX distillation step: the step
    key -> split -> fold_in(head_rng, i) -> bernoulli(0.5)."""
    _, head_rng = jax.random.split(key)
    return [torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(head_rng, i), 0.5, (n, t, EMB)))) for i in range(3)]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _adam_mu(opt_state):
    found = [s.mu for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
             if hasattr(s, "mu")]
    assert len(found) == 1, len(found)
    return found[0]


# ---------------------------------------------------------------- one step


@pytest.fixture(scope="module")
def setup():
    pt, ps, jt, js = _models()
    t_tree, s_tree = seeded_tree(pt, 3), seeded_tree(ps, 5)
    return pt, ps, jt, js, t_tree, s_tree


def _jax_step(jt, js, t_params, emb_w, kinds):
    """The JAX package's ``_distill_step`` (its loss, gradient and optax
    update), jitted, returning its gradients too; alpha and the pinned
    choices are arguments, so one trace serves every alpha and step."""
    optimizer = jmake_optimizer(1e-4)

    def step(s_params, opt_state, pins, batch, rng, alpha):
        cfg = JD.DistillConfig(alpha=alpha, emb_loss_weight=emb_w)
        with zoo_pins.pin_jax(list(zip(kinds, pins)), linear_nll=True):
            (_, metrics), grads = jax.value_and_grad(JD._distill_loss, has_aux=True)(
                s_params, t_params, {}, batch, rng, student=js, teacher=jt, cfg=cfg)
        updates, opt_state = optimizer.update(grads, opt_state, s_params)
        s_params = jax.tree.map(lambda p, u: (p + u).astype(p.dtype), s_params, updates)
        return s_params, opt_state, metrics, grads

    return jax.jit(step), optimizer


@pytest.fixture(scope="module")
def jax_steps(setup):
    """{emb_w: (jitted step, optimizer)}, built on first use."""
    _, _, jt, js, t_tree, _ = setup
    t_params = jax.tree.map(jnp.asarray, t_tree)
    cache = {}

    def get(emb_w, kinds):
        key = (emb_w, tuple(kinds))
        if key not in cache:
            cache[key] = _jax_step(jt, js, t_params, emb_w, kinds)
        return cache[key]

    return get


@pytest.mark.parametrize("emb_w", [0.0, EMB_W], ids=["emb_off", "emb_on"])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_distill_steps_match_jax(setup, jax_steps, alpha, emb_w):
    """Two steps on [2, 4, 4000] view batches: each step's metrics and
    gradients, then the student's parameters and AdamW's first moment."""
    pt, ps, jt, js, t_tree, s_tree = setup
    cfg = PD.DistillConfig(alpha=alpha, emb_loss_weight=emb_w)
    eng = PD.DistillEngine(pt, ps, cfg)
    eng.init_state(t_tree, s_tree)
    set_learning_rate(eng.optimizer, LR)
    grads, real_step = {}, eng.optimizer.step

    def spy():  # the gradients the update consumes
        grads.update({n: p.grad.clone() for n, p in zip(eng.optimizer.names,
                                                        eng.optimizer.params)})
        return real_step()

    eng.optimizer.step = spy
    s_params, opt_state = jax.tree.map(jnp.asarray, s_tree), None
    for i, batch in enumerate(_batches()):
        key = jax.random.key(100 + i)
        n, t = 8, ps.ssl.cfg.num_frames(batch["wav"].shape[-1])
        with zoo_pins.record_port(linear_nll=True) as choices:
            got = eng.step(eng.place_batch(batch), dropout_masks=_head_masks(key, n, t))
        step, optimizer = jax_steps(emb_w, [c[0] for c in choices])
        if opt_state is None:
            opt_state = jset_lr(optimizer.init(s_params), LR)
        s_params, opt_state, want, jgrads = step(
            s_params, opt_state, [jnp.asarray(c[1]) for c in choices],
            {k: jnp.asarray(v) for k, v in batch.items()}, key, alpha)
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL,
                                       err_msg=f"step {i} {k}")
        zoo_pins.assert_grads_close(grads, from_jax(jax.tree.map(np.asarray, jgrads), ps),
                                    f"step {i} gradients")
    assert eng.teacher.training is False and not any(
        p.requires_grad for p in eng.teacher.parameters())
    opt = eng.optimizer
    mu = {n: opt.adamw.state[p]["exp_avg"] for n, p in zip(opt.names, opt.params)}
    want_mu = from_jax(jax.tree.map(np.asarray, _adam_mu(opt_state)), ps)
    zoo_pins.assert_grads_close(mu, want_mu, "first moment")
    want_p = from_jax(jax.tree.map(np.asarray, s_params), ps)
    tol = zoo_pins.grad_tolerance(want_mu)
    for name, p in ps.named_parameters():
        either_way = want_mu[name].double().abs() <= tol[name]
        diff = (p.detach() - want_p[name]).abs()
        if bool(either_way.any()):
            assert float(diff[either_way].max()) <= 2.0001 * LR, name
        np.testing.assert_allclose(p.detach()[~either_way].numpy(),
                                   want_p[name][~either_way].numpy(), **TOL, err_msg=name)


def test_teacher_is_frozen_and_unchanged(setup):
    pt, ps, _, _, t_tree, s_tree = setup
    eng = PD.DistillEngine(pt, ps, PD.DistillConfig(alpha=0.0))
    eng.init_state(t_tree, s_tree)
    set_learning_rate(eng.optimizer, 1e-3)
    before = {n: p.detach().clone() for n, p in pt.named_parameters()}
    s_before = {n: p.detach().clone() for n, p in ps.named_parameters()}
    m = eng.run_epoch(_batches(1), epoch=0)
    assert all(np.isfinite(v) for v in m.values())
    assert all(torch.equal(p, before[n]) for n, p in pt.named_parameters())
    assert max((p - s_before[n]).abs().max().item() for n, p in ps.named_parameters()) > 0
    assert eng.optimizer.names == [n for n, _ in ps.named_parameters()]


# ------------------------------------------------------------------- guards


@pytest.mark.parametrize("alpha", [-0.1, 1.5])
def test_alpha_out_of_range_raises_as_jax(alpha):
    pt, ps, jt, js = _models()
    with pytest.raises(ValueError) as want:
        JD.DistillEngine(jt, js, JD.DistillConfig(alpha=alpha))
    with pytest.raises(ValueError) as got:
        PD.DistillEngine(pt, ps, PD.DistillConfig(alpha=alpha))
    assert str(got.value) == str(want.value) == f"alpha must be in [0, 1], got {alpha}"


def test_batch_norm_student_raises_as_jax():
    pt, _, jt, _ = _models()
    with pytest.raises(ValueError) as want:
        JD.DistillEngine(jt, JAasist(ssl=JXC.tiny()))
    with pytest.raises(ValueError) as got:
        PD.DistillEngine(pt, XLSRAasist(ssl=XLSRConfig.tiny(), device="meta"))
    assert str(got.value) == str(want.value)
    assert "carries BN buffers" in str(got.value)


# ------------------------------------------------------------------- golden


def golden_wavs(t=16000):
    """The utterances of tests/test_golden_pipeline.py, the short one
    repeat-padded to ``t``."""
    rng = np.random.default_rng(20240817)
    tt = np.arange(t) / 16000.0
    return [
        (0.3 * np.sin(2 * np.pi * 440.0 * tt)).astype(np.float32),
        (0.2 * rng.normal(size=t)).astype(np.float32),
        (0.3 * np.sin(2 * np.pi * (200 + 800 * tt) * tt)).astype(np.float32),
        (0.25 * np.sin(2 * np.pi * 333.0 * tt[: t // 3])).astype(np.float32),
    ]


GOLDEN_META = {"teacher_ssl": "tiny", "student_ssl": STUDENT_SSL, "emb_dim": EMB,
               "student_dropout": 0.0, "teacher_seed": 3, "student_seed": 5,
               "batch_seed": 29, "batch_shape": [2, 4, 4000], "steps": 2, "lr": 1e-3,
               "alpha": 0.5, "temperature": 4.0, "emb_loss_weight": 0.1}


def build_golden():
    """(teacher params, per-step metrics, student scores) of the tiny
    distillation golden, computed by the JAX package's ``DistillEngine``:
    the teacher and the student (head dropout 0, so that any device can
    reproduce it) from ``seeded_tree``, two steps at learning rate 1e-3,
    then the student's eval scores on the golden utterances."""
    m = GOLDEN_META
    pt, ps, jt, _ = _models(dropout=m["student_dropout"])
    js = JLinearNLL(ssl=JXC.tiny(**STUDENT_SSL), emb_dim=EMB, dropout=m["student_dropout"])
    t_tree, s_tree = seeded_tree(pt, m["teacher_seed"]), seeded_tree(ps, m["student_seed"])
    eng = JD.DistillEngine(jt, js, JD.DistillConfig(
        alpha=m["alpha"], temperature=m["temperature"], emb_loss_weight=m["emb_loss_weight"]))
    sp, opt, tp, tb = eng.init_state(jax.random.key(0), jax.tree.map(jnp.asarray, t_tree),
                                     student_params=jax.tree.map(jnp.asarray, s_tree))
    opt = jset_lr(opt, m["lr"])
    metrics = []
    for i, batch in enumerate(_batches(m["steps"], m["batch_shape"][-1], m["batch_seed"])):
        sp, opt, mi = eng.run_epoch(sp, opt, tp, [batch], jax.random.key(i), teacher_buffers=tb)
        metrics.append({k: float(v) for k, v in mi.items()})
    wav = np.stack([jpad_eval(w, "repeat", 16000) for w in golden_wavs()])
    scores = _np(js.apply(sp, jnp.asarray(wav)).log_probs)
    return t_tree, metrics, scores


def write_golden():
    t_tree, metrics, scores = build_golden()
    jckpt.save(os.path.join(GOLDEN, "mini_distill.ckpt"), {"params": t_tree},
               extra={**GOLDEN_META, "metrics": metrics})
    with open(os.path.join(GOLDEN, "mini_distill_scores.txt"), "w") as f:
        f.writelines(f"g{i} {a!r} {b!r}\n" for i, (a, b) in enumerate(scores.tolist()))


def read_golden():
    tree, meta = pckpt.load(os.path.join(GOLDEN, "mini_distill.ckpt"))
    with open(os.path.join(GOLDEN, "mini_distill_scores.txt")) as f:
        scores = np.array([[float(v) for v in ln.split()[1:]] for ln in f], np.float32)
    return tree["params"], meta, scores


def test_golden_is_what_the_jax_package_writes():
    want_t, meta, want_s = read_golden()
    t_tree, metrics, scores = build_golden()
    assert {k: v for k, v in meta.items() if k != "metrics"} == GOLDEN_META
    jax.tree.map(np.testing.assert_array_equal, t_tree, want_t)
    for got, want in zip(metrics, meta["metrics"]):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-6), k
    np.testing.assert_allclose(scores, want_s, rtol=0, atol=1e-6)


def test_port_reproduces_the_golden():
    t_tree, meta, want_s = read_golden()
    pt, ps, _, _ = _models(dropout=meta["student_dropout"])
    eng = PD.DistillEngine(pt, ps, PD.DistillConfig(
        alpha=meta["alpha"], temperature=meta["temperature"],
        emb_loss_weight=meta["emb_loss_weight"]))
    eng.init_state(t_tree, seeded_tree(ps, meta["student_seed"]))
    set_learning_rate(eng.optimizer, meta["lr"])
    batches = _batches(meta["steps"], meta["batch_shape"][-1], meta["batch_seed"])
    for i, (batch, want) in enumerate(zip(batches, meta["metrics"])):
        got = eng.run_epoch([batch], epoch=i)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-5), (i, k)
    wav = np.stack([pad_eval(w, "repeat", 16000) for w in golden_wavs()])
    np.testing.assert_allclose(score_step(ps, wav).numpy(), want_s, rtol=0, atol=1e-5)


if __name__ == "__main__":  # rewrite the golden (deliberate numerics changes only)
    import conftest  # noqa: F401  (the tests' CPU backend and XLA flags, before any JAX op)

    write_golden()
    print(f"wrote {os.path.join(GOLDEN, 'mini_distill.ckpt')}")
