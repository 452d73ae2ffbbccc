"""Port optimizer and LR policy (``train/optim.py``) and the EER copy
(``train/metrics.py``) vs the JAX package and optax, on the CPU.

The parameter trajectories are held to 1e-6 relative plus 2e-7 absolute (a
few fp32 ulps of parameters of magnitude up to ~3):
torch's AdamW and optax's adamw compute the same update with fp32 roundings
in another order (torch decays the weight before the Adam step, optax adds
the decay to the update)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from scl_deepfake_audio_detection_tpu.train import metrics as JM
from scl_deepfake_audio_detection_tpu.train import optim as JO
from scl_deepfake_audio_detection_torch.train import metrics as PM
from scl_deepfake_audio_detection_torch.train import optim as PO


def test_cyclic_exp_lr_matches_jax():
    for epoch in range(31):
        for kw in ({}, dict(base_lr=1e-7, max_lr=1e-4, step_size=2, gamma=0.9)):
            assert PO.cyclic_exp_lr(epoch, **kw) == JO.cyclic_exp_lr(epoch, **kw)


@pytest.mark.parametrize("mode,init,scores", [
    ("max", 90.0, [80, 91, 91.005, 92, 90, 90, 90, 95, 94, 93, 93]),
    ("min", 100.0, [50, 40, 39.995, 45, 30, 31, 31, 31, 29, 35, 35]),
])
def test_early_stop_matches_jax(mode, init, scores):
    a = PO.EarlyStop(patience=3, delta=0.01, init_best=init, mode=mode)
    b = JO.EarlyStop(patience=3, delta=0.01, init_best=init, mode=mode)
    for s in scores:
        assert a(s) == b(s)
        assert (a.best, a.counter, a.early_stop) == (b.best, b.counter, b.early_stop)
    assert a.early_stop
    with pytest.raises(ValueError):
        PO.EarlyStop(mode="up")


def _grads(rng, shapes, steps):
    return [[rng.normal(size=s).astype(np.float32) * 10 ** rng.uniform(-3, 1)
             for s in shapes] for _ in range(steps)]


@pytest.mark.parametrize("clip,accum,steps", [(None, 1, 3), (0.5, 1, 3), (None, 2, 6),
                                              (0.5, 2, 6)])
def test_adamw_trajectory_matches_optax(rng, clip, accum, steps):
    shapes = [(5, 3), (3,), (2, 4, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = _grads(rng, shapes, steps)
    lr, wd = 1e-2, 1e-4

    tx = JO.make_optimizer(wd, grad_clip_norm=clip, grad_accum_steps=accum)
    jp = [jnp.asarray(a) for a in p0]
    state = JO.set_learning_rate(tx.init(jp), lr)
    want = []
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        want.append([np.asarray(a) for a in jp])

    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = PO.set_learning_rate(PO.make_optimizer(
        [(f"p{i}", p) for i, p in enumerate(tp)], wd, grad_clip_norm=clip,
        grad_accum_steps=accum), lr)
    assert opt.lr == lr
    for i, g in enumerate(grads):
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        assert opt.step() == ((i + 1) % accum == 0)
        assert all(p.grad is None for p in tp)
        for p, w in zip(tp, want[i]):
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-6, atol=2e-7)


def test_clip_by_global_norm_matches_optax(rng):
    g = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(7,)).astype(np.float32)]
    for max_norm in (0.1, 1e3):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in g], None)
        got = PO.clip_by_global_norm([torch.from_numpy(a) for a in g], max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_missing_gradient_counts_as_zero_as_in_optax(rng):
    """optax updates every leaf: a parameter with no gradient still decays."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = PO.set_learning_rate(PO.make_optimizer([("p", p)], weight_decay=0.5), 0.1)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.full(3, 0.95, np.float32), rtol=1e-6)


def test_optimizer_state_round_trips(rng):
    tp = [torch.nn.Parameter(torch.randn(3, 2)), torch.nn.Parameter(torch.randn(4))]
    named = [("a.w", tp[0]), ("b", tp[1])]
    opt = PO.set_learning_rate(PO.make_optimizer(named, grad_accum_steps=2), 1e-2)
    for _ in range(3):
        for p in tp:
            p.grad = torch.randn_like(p)
        opt.step()
    arrays = {k: v.clone() for k, v in opt.state_arrays().items()}
    assert int(arrays["step"]) == 1 and int(arrays["mini_step"]) == 1
    other = PO.set_learning_rate(PO.make_optimizer(
        [(n, torch.nn.Parameter(p.detach().clone())) for n, p in named],
        grad_accum_steps=2), 1e-2)
    other.load_state_arrays({k: v.numpy() for k, v in arrays.items()})
    grads = [torch.randn_like(p) for p in tp]
    for o in (opt, other):
        for p, g in zip(o.params, grads):
            p.grad = g.clone()
        assert o.step()
    for a, b in zip(opt.params, other.params):
        assert torch.equal(a, b)


def test_eer_matches_jax(rng):
    tgt, non = rng.normal(1.0, 1.0, 200), rng.normal(-1.0, 1.0, 300)
    assert PM.compute_eer(tgt, non) == JM.compute_eer(tgt, non)
    for a, b in zip(PM.det_curve(tgt, non), JM.det_curve(tgt, non)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        PM.compute_eer([], non)
