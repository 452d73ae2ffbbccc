"""The port's ``train/gan.GANEngine`` against the JAX package's, on the CPU.

Both nets are the small MLPs of ``tests/test_gan_al.py`` (the port's in
``tests/torch_parallel_ranks.py``) with the JAX package's seeded
parameters; the batches are dicts with ``"z"`` (the latents, so that
neither side draws them) and ``"real"``, 16 rows, which the JAX engine's
default mesh splits over the conftest's 8 virtual devices.  After 3
steps in each mode (non-saturating; WGAN with ``n_critic=3`` and the 0.01
clamp; the aux-loss flavor) both nets' parameters, AdamW's state and the
epoch's metrics are within 1e-5 (fp32 sums in another order).
``gan_last.ckpt`` of each package loads in the other, and a step from it
agrees within 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.ops.layers import init_linear, linear
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_tpu.train import gan as JG
from scl_deepfake_audio_detection_torch.models.params import to_jax
from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt
from scl_deepfake_audio_detection_torch.train import gan as PG

from torch_parallel_ranks import MLP as PMLP

torch.set_num_threads(2)
TOL = 1e-5
Z_DIM = 3
W_AUX = np.array([[1.0, -2.0], [0.5, 1.5], [2.0, 0.0]], np.float32)


class JMLP:
    """The JAX package's test MLP (``tests/test_gan_al.py``)."""

    def __init__(self, sizes, out_squeeze=False):
        self.sizes, self.out_squeeze = sizes, out_squeeze

    def init(self, key):
        ks = jax.random.split(key, len(self.sizes) - 1)
        return [init_linear(k, i, o) for k, i, o in zip(ks, self.sizes[:-1], self.sizes[1:])]

    def apply(self, params, x, train=False, rng=None):
        for i, p in enumerate(params):
            x = linear(p, x)
            if i < len(params) - 1:
                x = jax.nn.relu(x)
        return x[..., 0] if self.out_squeeze else x


CASES = {
    "gan": {},
    "wgan": {"mode": "wgan", "n_critic": 3},
    "aux": {"aux_loss_fn": "mse"},
}
SIZES_G, SIZES_D = [Z_DIM, 8, 2], [2, 8, 1]


def _kw(case, pkg):
    kw = dict(CASES[case])
    if "aux_loss_fn" in kw:
        kw["aux_loss_fn"] = pkg.mse_aux
    return dict(z_dim=Z_DIM, lr_g=1e-2, lr_d=5e-3, **kw)


def _batches(n=3, seed=0, rows=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        z = rng.standard_normal((rows, Z_DIM)).astype(np.float32)
        out.append({"z": z, "real": (z @ W_AUX + 0.1 * rng.standard_normal((rows, 2)))
                    .astype(np.float32)})
    return out


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _engines(case, seed=0):
    jeng = JG.GANEngine(JMLP(SIZES_G), JMLP(SIZES_D, True), **_kw(case, JG))
    state = jeng.init_state(jax.random.key(seed))
    peng = PG.GANEngine(PMLP(SIZES_G), PMLP(SIZES_D, True), **_kw(case, PG))
    peng.init_state(params_g=_np(state[0]), params_d=_np(state[1]))
    return jeng, state, peng


def _leaves_close(got, want, tol=TOL, what=""):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   rtol=tol, atol=tol, err_msg=f"{what} leaf {i}")


def _opt_leaves(net, opt):
    leaves = pckpt.pack_opt_leaves(net, opt)
    return [leaves[str(i)] for i in range(len(leaves))]


def _same_state(peng, state):
    pg, pd, og, od = state
    _leaves_close(to_jax(peng.gen), _np(pg), what="generator")
    _leaves_close(to_jax(peng.disc), _np(pd), what="discriminator")
    _leaves_close(_opt_leaves(peng.gen, peng.opt_g), jax.tree.leaves(og), what="opt_g")
    _leaves_close(_opt_leaves(peng.disc, peng.opt_d), jax.tree.leaves(od), what="opt_d")


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_the_jax_engine(case):
    jeng, state, peng = _engines(case)
    g0 = [p.detach().clone() for p in peng.gen.parameters()]
    batches = _batches()
    *state, jm = jeng.run_epoch(*state, batches, jax.random.key(7))
    pm = peng.run_epoch(batches, 0)
    assert set(pm) == set(jm) == {"d_loss", "g_loss", "g_aux"}
    for k in jm:
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=TOL, atol=TOL, err_msg=k)
    _same_state(peng, state)
    if case == "wgan":
        # the clamp holds; G moved at step 0 only (steps 1 and 2 skip it)
        assert max(p.abs().max().item() for p in peng.disc.parameters()) <= 0.01
        assert int(_opt_leaves(peng.gen, peng.opt_g)[0]) == 1
        assert int(_opt_leaves(peng.disc, peng.opt_d)[0]) == 3
        assert any(not torch.equal(a, b) for a, b in zip(g0, peng.gen.parameters()))
    if case == "aux":
        assert pm["g_aux"] > 0


def test_losses_equal_the_jax_ones(rng):
    real = rng.standard_normal(12).astype(np.float32) * 4
    fake = rng.standard_normal((12, 1)).astype(np.float32) * 4
    pairs = [
        (PG.d_loss_nonsaturating, JG.d_loss_nonsaturating, (real, fake)),
        (PG.g_loss_nonsaturating, JG.g_loss_nonsaturating, (fake,)),
        (PG.d_loss_wasserstein, JG.d_loss_wasserstein, (real, fake)),
        (PG.g_loss_wasserstein, JG.g_loss_wasserstein, (fake,)),
        (PG.mse_aux, JG.mse_aux, (fake[:, 0], real)),
        (lambda x: PG.bce_logits(x, 0.0), lambda x: JG.bce_logits(x, 0.0), (real * 30,)),
    ]
    for pf, jf, args in pairs:
        got = pf(*(torch.from_numpy(a) for a in args)).item()
        want = float(jf(*(jnp.asarray(a) for a in args)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        PG.GANEngine(PMLP(SIZES_G), PMLP(SIZES_D, True), Z_DIM, mode="lsgan")


def test_jax_checkpoint_loads_in_the_port_and_steps_alike(tmp_path):
    jeng, _, peng = _engines("gan", seed=3)
    state = jeng.fit(lambda: _batches(2, seed=1), 1, jax.random.key(3),
                     save_dir=str(tmp_path))
    fresh = PG.GANEngine(PMLP(SIZES_G), PMLP(SIZES_D, True), **_kw("gan", PG))
    assert fresh.load(str(tmp_path / "gan_last.ckpt")) == {"epoch": 0}
    _same_state(fresh, state)
    nxt = _batches(1, seed=2)
    *state, _ = jeng.run_epoch(*state, nxt, jax.random.key(4))
    fresh.run_epoch(nxt, 1)
    _same_state(fresh, state)


def test_port_checkpoint_loads_in_the_jax_package_and_steps_alike(tmp_path):
    jeng, jstate, peng = _engines("wgan", seed=5)
    peng.fit(lambda: _batches(2, seed=6), 2, save_dir=str(tmp_path))
    tree, extra = jckpt.load(str(tmp_path / "gan_last.ckpt"))
    assert extra == {"epoch": 1}
    _leaves_close(tree["params_g"], to_jax(peng.gen), tol=0)
    _leaves_close(tree["params_d"], to_jax(peng.disc), tol=0)
    # the JAX engine takes the leaves back into its own optimizer states
    og = jax.tree.unflatten(jax.tree.structure(jstate[2]), tree["opt_g_leaves"])
    od = jax.tree.unflatten(jax.tree.structure(jstate[3]), tree["opt_d_leaves"])
    state = [tree["params_g"], tree["params_d"], og, od]
    jeng._global_step = peng.global_step
    nxt = _batches(2, seed=7)
    *state, jm = jeng.run_epoch(*state, nxt, jax.random.key(8))
    pm = peng.run_epoch(nxt, 2)
    _same_state(peng, state)
    for k in jm:
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=TOL, atol=TOL, err_msg=k)


def test_the_port_engine_learns_a_shifted_gaussian():
    """``tests/test_gan_al.py``'s run, on the port alone, with latents the
    engine draws itself (array batches)."""
    torch.manual_seed(0)
    target = np.array([2.0, -1.0], np.float32)
    rng = np.random.default_rng(0)
    gen, disc = PMLP([4, 32, 2]), PMLP([2, 32, 1], True)
    from scl_deepfake_audio_detection_torch.models.base import init_parameters

    init_parameters(gen, torch.Generator().manual_seed(1))
    init_parameters(disc, torch.Generator().manual_seed(2))
    eng = PG.GANEngine(gen, disc, z_dim=4, lr_g=2e-3, lr_d=2e-3, seed=9)
    logs = []
    eng.fit(lambda: [(rng.normal(size=(64, 2)) * 0.3 + target).astype(np.float32)
                     for _ in range(40)], 6, log_fn=lambda e, m: logs.append(m))
    assert all(np.isfinite(m["d_loss"]) and np.isfinite(m["g_loss"]) for m in logs)
    fake = gen.apply(torch.randn(256, 4, generator=torch.Generator().manual_seed(3)))
    assert np.linalg.norm(fake.detach().numpy().mean(0) - target) < 1.0
