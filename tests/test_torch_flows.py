"""The port's normalizing flows (``ops/flows``) and sequence utilities
(``ops/seq_utils``) against the JAX package's, on the CPU at tiny widths.

Parameter trees have the structure and shapes of the JAX ``init_*``
functions (``jax.eval_shape``) and seeded numpy values (a JAX init op by op
costs seconds; seeded projections keep the couplings from being the
identity), loaded through ``models/params.load_jax_params``.  Inputs come from a numpy seed; masks are ragged.
Tolerances:
- forwards, inverses and log-dets: rtol 1e-5 / atol 1e-5 in fp32 (the same
  operations summed in another order);
- gradients: ``zoo_pins.assert_grads_close`` (rtol 1e-5 and 5e-4 of each
  leaf's largest entry);
- a flow's reverse of its forward: 1e-4 of the input (the spline's
  inverse is a quadratic root in fp32);
- bin indices, masks, paths, the layout round trip and the host helpers:
  exact.
``rand_gumbel`` and ``rand_slice_segments`` draw from a ``torch.Generator``:
their draws are torch's, so they are held to JAX's given JAX's uniforms
(their ``u`` seam), and their own draws to the guards."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.ops import flows as JF
from scl_deepfake_audio_detection_tpu.ops import seq_utils as JS
from scl_deepfake_audio_detection_torch.models.params import from_jax, load_jax_params, to_jax
from scl_deepfake_audio_detection_torch.ops import flows as PF
from scl_deepfake_audio_detection_torch.ops import seq_utils as PS
from scl_deepfake_audio_detection_torch.utils.tree import flatten

import zoo_pins

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_cli_eval.py
torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-5
B, T = 2, 9


def _np(x):
    return np.array(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(_np(x))


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _x(c, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((B, T, c))).astype(np.float32)


def _mask():
    lengths = np.array([T, T - 3])
    return (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)[..., None]


def _tree(tree):
    return jax.tree.map(np.asarray, tree)


def _seeded(tree, seed, scale=0.3):
    """The tree with every leaf replaced by seeded N(0, scale^2) values."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(np.shape(a))).astype(np.float32),
                        _tree(tree))


def _params(init, *args, seed, scale=0.3, **kw):
    """A parameter tree of the JAX ``init`` (its structure and shapes, by
    ``jax.eval_shape``) with seeded N(0, scale^2) leaves: a JAX init op by
    op costs seconds, and a seeded tree is no identity."""
    shapes = jax.eval_shape(lambda k: init(k, *args, **kw), jax.random.key(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
                        shapes)


def _jx(fn, *args, **kw):
    """``fn(*args, **kw)`` under one ``jax.jit`` (op by op costs seconds)."""
    return jax.jit(lambda *a: fn(*a, **kw))(*args)


def _loaded(module, tree):
    load_jax_params(module, _tree(tree))
    return module


# ---------------------------------------------------------------- splines


def _knots(shape, num_bins, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape + (n,)).astype(np.float32)
            for n in (num_bins, num_bins, num_bins - 1)]


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("tails", ["linear", None])
def test_spline_matches_jax(tails, inverse):
    num_bins = 6
    rng = np.random.default_rng(0)
    x = (rng.uniform(-6.5, 6.5, 200) if tails else rng.uniform(0.0, 1.0, 200)).astype(np.float32)
    uw, uh, ud = _knots((200,), num_bins, 1)
    if tails is None:  # the unconstrained spline's derivative tensor is [..., K + 1]
        ud = np.concatenate([ud, ud[:, :2]], axis=-1)
    kw = dict(inverse=inverse, tails=tails, tail_bound=5.0)
    y, ld = _jx(JF.piecewise_rational_quadratic_transform, x, uw, uh, ud, **kw)
    py, pld = PF.piecewise_rational_quadratic_transform(*map(_t, (x, uw, uh, ud)), **kw)
    _close(py, y, "y")
    _close(pld, ld, "logabsdet")


def test_bin_search_keeps_the_mask_sum_tie_rule():
    """On a bin edge the index is the bin that starts there (#(x >= edge) - 1);
    past the last edge + eps it stays in the last bin, below the first in the
    first."""
    locs = np.cumsum(np.random.default_rng(3).uniform(0.1, 1.0, (4, 7)), axis=-1)
    locs = np.concatenate([np.zeros((4, 1)), locs], axis=-1).astype(np.float32)
    x = np.concatenate([locs, locs - 1e-3, locs + 1e-3, locs[:, :1] - 5, locs[:, -1:] + 5],
                       axis=-1)
    want = JF._searchsorted(jnp.asarray(locs)[:, None, :], jnp.asarray(x))
    got = PF._searchsorted(torch.from_numpy(locs)[:, None, :], torch.from_numpy(x))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got[:, :7].numpy(), np.tile(np.arange(7), (4, 1)))


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_spline_gradients_match_jax(inverse):
    num_bins = 5
    x = np.random.default_rng(4).uniform(-3.0, 3.0, 64).astype(np.float32)
    knots = _knots((64,), num_bins, 5)
    ct = np.random.default_rng(6).standard_normal((2, 64)).astype(np.float32)

    def jloss(*args):
        y, ld = JF.piecewise_rational_quadratic_transform(*args, inverse=inverse,
                                                          tail_bound=2.5)
        return jnp.sum(y * ct[0] + ld * ct[1])

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, [x] + knots))
    ts = [_t(a).requires_grad_(True) for a in [x] + knots]
    y, ld = PF.piecewise_rational_quadratic_transform(*ts, inverse=inverse, tail_bound=2.5)
    (y * _t(ct[0]) + ld * _t(ct[1])).sum().backward()
    names = ("x", "widths", "heights", "derivatives")
    zoo_pins.assert_grads_close({n: t.grad for n, t in zip(names, ts)},
                                {n: _t(w) for n, w in zip(names, want)})


# ---------------------------------------------------------------- simple flows


def test_log_flip_and_affine_flows_match_jax():
    x, mask = np.abs(_x(3)) + 0.1, _mask()
    y, ld = JF.log_flow(jnp.asarray(x), jnp.asarray(mask))
    py, pld = PF.log_flow(_t(x), _t(mask))
    _close(py, y), _close(pld, ld)
    _close(PF.log_flow(py, _t(mask), reverse=True), JF.log_flow(y, jnp.asarray(mask), True))
    py, pld = PF.flip_flow(_t(x))
    assert torch.equal(py, _t(np.flip(x, -1))) and not pld.any()
    assert torch.equal(PF.flip_flow(py, reverse=True), _t(x))
    p = _seeded(JF.init_elementwise_affine(3), 7)
    m = _loaded(PF.ElementwiseAffine(3), p)
    y, ld = JF.elementwise_affine(p, jnp.asarray(x), jnp.asarray(mask))
    py, pld = m(_t(x), _t(mask))
    _close(py, y), _close(pld, ld)
    _close(m(py, _t(mask), reverse=True), JF.elementwise_affine(p, y, jnp.asarray(mask), True))


# ---------------------------------------------------------------- conditioners


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("gin", [0, 3])
def test_wn_matches_jax(gin, dilation):
    p = _params(JF.init_wn, hidden=8, kernel=3, n_layers=3, gin=gin, seed=0)
    m = _loaded(PF.WN(8, 3, 3, gin=gin, dilation_rate=dilation), p)
    x, mask = _x(8), _mask()
    g = _x(3, seed=1) if gin else None
    want = _jx(JF.wn, p, x, mask, g=None if g is None else jnp.asarray(g),
               dilation_rate=dilation)
    _close(m(_t(x), _t(mask), g=None if g is None else _t(g)), want)


def test_wn_refuses_conditioning_without_a_cond_layer():
    m = PF.WN(4, 3, 2)
    with pytest.raises(ValueError, match="gin=0"):
        m(torch.zeros(1, 6, 4), torch.ones(1, 6, 1), g=torch.ones(1, 6, 3))
    with pytest.raises(ValueError, match="odd"):
        PF.WN(4, 4, 2)


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "g"])
def test_dds_conv_matches_jax(cond):
    p = _params(JF.init_dds_conv, channels=6, kernel=3, n_layers=3, seed=1)
    m = _loaded(PF.DDSConv(6, 3, 3), p)
    x, mask, g = _x(6), _mask(), _x(6, seed=2)
    want = _jx(JF.dds_conv, p, x, mask, g=jnp.asarray(g) if cond else None)
    _close(m(_t(x), _t(mask), g=_t(g) if cond else None), want)


def test_conv_relu_norm_matches_jax_and_draws_a_mask_a_layer():
    p = _params(JF.init_conv_relu_norm, 6, 8, 6, 3, 3, seed=8)
    m = _loaded(PF.ConvReluNorm(6, 8, 6, 3, 3), p)
    x, mask = _x(6), _mask()
    _close(m(_t(x), _t(mask)), _jx(JF.conv_relu_norm, p, x, mask))
    # training dropout given JAX's keep masks (one key a layer)
    rng = jax.random.key(5)
    keeps = [np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, i), 0.5, (B, T, 8)))
             for i in range(3)]
    want = _jx(JF.conv_relu_norm, p, x, mask, dropout_rate=0.5, rng=rng)
    got = m(_t(x), _t(mask), dropout_rate=0.5, masks=[torch.from_numpy(k.copy()) for k in keeps])
    _close(got, want)
    # the port's own draws: one mask a layer, from the generator in turn
    drawn = []
    orig = PF.dropout
    try:
        PF.dropout = lambda x, *a, **k: (drawn.append(orig(torch.ones_like(x), *a, **k)), x)[1]
        m(_t(x), _t(mask), dropout_rate=0.5, generator=torch.Generator().manual_seed(0))
    finally:
        PF.dropout = orig
    assert len(drawn) == 3 and not torch.equal(drawn[0], drawn[1])


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("block", [1, 2])
def test_res_blocks_match_jax(block, masked):
    init, fn = ((JF.init_res_block1, JF.res_block1) if block == 1
                else (JF.init_res_block2, JF.res_block2))
    p = _params(init, 4, seed=3)
    m = _loaded(PF.ResBlock1(4) if block == 1 else PF.ResBlock2(4), p)
    x, mask = _x(4, seed=3, scale=2.0), _mask()
    want = _jx(fn, p, x, jnp.asarray(mask) if masked else None)
    _close(m(_t(x), _t(mask) if masked else None), want)


# ---------------------------------------------------------------- couplings


def _coupling(mean_only, gin):
    p = _params(JF.init_residual_coupling, 8, 16, 3, 3, gin=gin, mean_only=mean_only, seed=4)
    p["post"] = _seeded(p["post"], 9, 0.1)
    m = _loaded(PF.ResidualCoupling(8, 16, 3, 3, gin=gin, mean_only=mean_only,
                                    dilation_rate=2), p)
    return p, m


def _coupled(x, mask):
    """x as an affine coupling leaves it at identity: the first half as it
    is, the second masked."""
    h = x.shape[-1] // 2
    return np.concatenate([x[..., :h], x[..., h:] * mask], axis=-1)


def _conv_flow(num_bins=4):
    """A ConvFlow whose knots vary by element.  The inverse's error is the
    conditioner's rounding over the spline's slope: at 0.1 the slopes stay
    above ~0.3, at 0.5 some fall near the floor of 1e-3 and a 1e-7
    difference in the knots moves the inverse by 1e-3 in both packages."""
    p = _params(JF.init_conv_flow, 4, 8, 3, 2, num_bins=num_bins, seed=5)
    p["proj"] = _seeded(p["proj"], 10, 0.1)
    return p, _loaded(PF.ConvFlow(4, 8, 3, 2, num_bins=num_bins, tail_bound=5.0), p)


@pytest.mark.parametrize("gin", [0, 3])
@pytest.mark.parametrize("mean_only", [False, True], ids=["affine", "mean_only"])
def test_residual_coupling_matches_jax_and_inverts(mean_only, gin):
    p, m = _coupling(mean_only, gin)
    x, mask = _x(8), _mask()
    g = _x(3, seed=1) if gin else None
    jg, tg = (None, None) if g is None else (jnp.asarray(g), _t(g))
    kw = dict(g=jg, dilation_rate=2, mean_only=mean_only)
    y, ld = _jx(JF.residual_coupling, p, x, mask, **kw)
    py, pld = m(_t(x), _t(mask), g=tg)
    _close(py, y, "y"), _close(pld, ld, "logdet")
    _close(m(_t(y), _t(mask), g=tg, reverse=True),
           _jx(JF.residual_coupling, p, y, mask, reverse=True, **kw), "reverse")
    # the first half passes through unmasked, the second comes back masked
    _close(m(py, _t(mask), g=tg, reverse=True), _coupled(x, mask), "round trip", atol=1e-4)


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "g"])
def test_conv_flow_matches_jax_and_inverts(cond):
    p, m = _conv_flow()
    x, mask = _x(4, scale=3.0), _mask()  # some elements past the tail bound
    g = _x(8, seed=2) if cond else None
    jg, tg = (None, None) if g is None else (jnp.asarray(g), _t(g))
    y, ld = _jx(JF.conv_flow, p, x, mask, g=jg, num_bins=4)
    py, pld = m(_t(x), _t(mask), g=tg)
    _close(py, y, "y"), _close(pld, ld, "logdet")
    _close(m(_t(y), _t(mask), g=tg, reverse=True),
           _jx(JF.conv_flow, p, y, mask, g=jg, num_bins=4, reverse=True), "reverse")
    _close(m(py, _t(mask), g=tg, reverse=True), x * mask, "round trip", atol=1e-4)


@pytest.mark.parametrize("flow", ["residual_coupling", "conv_flow"])
def test_coupling_gradients_match_jax(flow):
    if flow == "conv_flow":
        p, m = _conv_flow()
        x = _x(4, scale=3.0)
        apply = lambda pp, xx, mm: JF.conv_flow(pp, xx, mm, num_bins=4)  # noqa: E731
    else:
        p, m = _coupling(False, 0)
        x = _x(8)
        apply = lambda pp, xx, mm: JF.residual_coupling(pp, xx, mm, dilation_rate=2)  # noqa: E731
    mask = _mask()
    ct = np.random.default_rng(11).standard_normal(x.shape).astype(np.float32)

    def loss(pp, xx):
        y, ld = apply(pp, xx, jnp.asarray(mask))
        return jnp.sum(y * ct) + jnp.sum(ld)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y, ld = m(xt, _t(mask))
    ((y * _t(ct)).sum() + ld.sum()).backward()
    zoo_pins.assert_grads_close({n: q.grad for n, q in m.named_parameters()},
                                from_jax(_tree(gp), m), flow)
    zoo_pins.assert_grads_close({"x": xt.grad}, {"x": _t(gx)}, "x")


def test_coupling_projections_start_at_zero():
    """Under ``init_parameters`` too: the affine coupling and ConvReluNorm
    are then the identity (on the masked input), ConvFlow a fixed spline
    that its reverse undoes."""
    from scl_deepfake_audio_detection_torch.models.base import init_parameters

    x, mask = _t(_x(8)), _t(_mask())
    for m in (PF.ResidualCoupling(8, 16, 3, 2), PF.ConvFlow(8, 8, 3, 2),
              PF.ConvReluNorm(8, 8, 8, 3, 2)):
        init_parameters(m, torch.Generator().manual_seed(0))
        proj = m.post if isinstance(m, PF.ResidualCoupling) else m.proj
        assert not proj.weight.any() and not proj.bias.any()
        y = m(x, mask)
        if isinstance(m, PF.ConvFlow):
            _close(m(y[0], mask, reverse=True), x * mask, atol=1e-5)
            continue
        want = _coupled(x.numpy(), mask.numpy()) if isinstance(m, PF.ResidualCoupling) else x * mask
        _close(y[0] if isinstance(y, tuple) else y, want, atol=1e-6)


@pytest.mark.parametrize("name", ["wn", "dds_conv", "conv_relu_norm", "res_block1",
                                  "res_block2", "residual_coupling", "conv_flow",
                                  "elementwise_affine"])
def test_layout_round_trip_is_exact(name):
    """JAX -> port -> JAX gives the JAX tree back, lists (WN's ``in_layers``,
    ``res_skip_layers``, DDSConv's stacks) as ``nn.ModuleList`` paths."""
    made = {
        "wn": lambda: (_params(JF.init_wn, 8, 3, 2, gin=3, seed=6), PF.WN(8, 3, 2, gin=3)),
        "dds_conv": lambda: (_params(JF.init_dds_conv, 6, 3, 2, seed=6), PF.DDSConv(6, 3, 2)),
        "conv_relu_norm": lambda: (_params(JF.init_conv_relu_norm, 4, 8, 4, 3, 2, seed=6),
                                   PF.ConvReluNorm(4, 8, 4, 3, 2)),
        "res_block1": lambda: (_params(JF.init_res_block1, 4, seed=6), PF.ResBlock1(4)),
        "res_block2": lambda: (_params(JF.init_res_block2, 4, seed=6), PF.ResBlock2(4)),
        "residual_coupling": lambda: (
            _params(JF.init_residual_coupling, 8, 16, 3, 2, gin=2, seed=6),
            PF.ResidualCoupling(8, 16, 3, 2, gin=2)),
        "conv_flow": lambda: (_params(JF.init_conv_flow, 4, 8, 3, 2, seed=6),
                              PF.ConvFlow(4, 8, 3, 2)),
        "elementwise_affine": lambda: (_seeded(JF.init_elementwise_affine(5), 6),
                                       PF.ElementwiseAffine(5)),
    }
    tree, m = made[name]()
    load_jax_params(m, tree)
    if name == "wn":
        assert "in_layers.0.weight" in dict(m.named_parameters())
    got, want = flatten(to_jax(m)), flatten(tree)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------- seq_utils


def test_gaussian_kl_and_masks_match_jax():
    a = [_x(3, seed=s) for s in range(4)]
    _close(PS.gaussian_kl(*map(_t, a)), JS.gaussian_kl(*map(jnp.asarray, a)))
    lengths = np.array([5, 0, 9], np.int32)
    assert np.array_equal(PS.sequence_mask(torch.from_numpy(lengths), 9).numpy(),
                          np.asarray(JS.sequence_mask(jnp.asarray(lengths), 9)))
    assert np.array_equal(PS.subsequent_mask(6).numpy(), np.asarray(JS.subsequent_mask(6)))


def test_slice_segments_gathers_each_row_without_a_loop():
    x = _x(3)
    ids = np.array([2, 7], np.int32)  # 7 + 4 > T: clamped, as lax.dynamic_slice
    want = JS.slice_segments(jnp.asarray(x), jnp.asarray(ids), 4)
    got = PS.slice_segments(_t(x), torch.from_numpy(ids), 4)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_random_draws_match_jax_given_its_uniforms_and_keep_their_guards():
    key = jax.random.key(7)
    u = jax.random.uniform(key, (3, 5))
    _close(PS.rand_gumbel((3, 5), u=_t(u)), JS.rand_gumbel(key, (3, 5)))
    edge = PS.rand_gumbel((2,), u=torch.tensor([0.0, 1.0]))
    assert torch.isfinite(edge).all()  # the uniforms are squeezed into [1e-5, 0.99999]
    drawn = PS.rand_gumbel((1000,), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn).all() and abs(float(drawn.mean()) - 0.5772) < 0.1

    x, lengths = _x(3), np.array([T, 6], np.int32)
    want, want_ids = JS.rand_slice_segments(key, jnp.asarray(x), jnp.asarray(lengths), 4)
    got, got_ids = PS.rand_slice_segments(_t(x), torch.from_numpy(lengths), 4,
                                          u=_t(jax.random.uniform(key, (B,))))
    assert np.array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert np.array_equal(got.numpy(), np.asarray(want))
    g = torch.Generator().manual_seed(1)
    for _ in range(50):
        seg, ids = PS.rand_slice_segments(_t(x), torch.from_numpy(lengths), 4, generator=g)
        assert ids.dtype == torch.int32 and seg.shape == (B, 4, 3)
        assert bool(((ids >= 0) & (ids <= torch.from_numpy(lengths) - 4)).all())


@pytest.mark.parametrize("channels", [6, 7])
def test_timing_signals_and_shift_match_jax(channels):
    x = _x(channels)
    _close(PS.get_timing_signal_1d(T, channels), JS.get_timing_signal_1d(T, channels))
    _close(PS.add_timing_signal_1d(_t(x)), JS.add_timing_signal_1d(jnp.asarray(x)))
    _close(PS.cat_timing_signal_1d(_t(x)), JS.cat_timing_signal_1d(jnp.asarray(x)))
    assert np.array_equal(PS.shift_1d(_t(x)).numpy(), np.asarray(JS.shift_1d(jnp.asarray(x))))


def test_generate_path_matches_jax():
    dur = np.array([[2, 0, 3, 1], [1, 4, 0, 0]], np.float32)
    mask = np.ones((2, 7, 4), np.float32)
    mask[1, 5:] = 0
    want = JS.generate_path(jnp.asarray(dur), jnp.asarray(mask))
    assert np.array_equal(PS.generate_path(_t(dur), _t(mask)).numpy(), np.asarray(want))


@pytest.mark.parametrize("clip", [None, 0.3])
@pytest.mark.parametrize("norm_type", [2.0, 1.0])
def test_clip_grad_value_keeps_the_jax_semantics(clip, norm_type):
    """A pure function of a dict or list tree: the clipped tree and the
    pre-clip total norm, accumulated in fp32; the inputs are not touched."""
    rng = np.random.default_rng(8)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32),
                  rng.standard_normal((2, 2)).astype(np.float32)]}
    want, want_norm = JS.clip_grad_value(jax.tree.map(jnp.asarray, tree), clip, norm_type)
    ptree = {"a": _t(tree["a"]), "b": [_t(v) for v in tree["b"]]}
    ptree["b"][0] = ptree["b"][0].to(torch.bfloat16)
    want_b0 = JS.clip_grad_value([jnp.asarray(tree["b"][0], jnp.bfloat16)], clip, norm_type)
    before = {k: v.clone() for k, v in flatten(ptree).items()}
    got, got_norm = PS.clip_grad_value(ptree, clip, norm_type)
    assert got_norm.dtype == torch.float32
    assert all(torch.equal(before[k], v) for k, v in flatten(ptree).items())
    fw, fg = flatten(jax.tree.map(np.asarray, want)), flatten(got)
    for k in ("a", "b//1"):
        _close(fg[k], fw[k], k)
    assert np.array_equal(fg["b//0"].float().numpy(),
                          np.asarray(want_b0[0][0], np.float32))
    bf16_norm = JS.clip_grad_value(
        {"a": jnp.asarray(tree["a"]), "b": [jnp.asarray(tree["b"][0], jnp.bfloat16),
                                            jnp.asarray(tree["b"][1])]}, clip, norm_type)[1]
    _close(got_norm, bf16_norm)
    if clip is not None:
        assert max(float(fg[k].abs().max()) for k in ("a", "b//1")) <= np.float32(clip)


def test_intersperse():
    assert PS.intersperse([3, 4], 0) == JS.intersperse([3, 4], 0) == [0, 3, 0, 4, 0]
    assert PS.intersperse([], 9) == [9]
