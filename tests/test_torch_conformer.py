"""The port's conformer encoder (``models/conformer``) against the JAX
package's, on the CPU at tiny widths: forwards in eval and in training
(with the updated batch-norm statistics), parameter and input gradients,
the relative-position bias, the parameter layout through ``models/params``
(a square relative-position table included) and the config.

Parameters come from the JAX ``init_conformer`` through
``models/params.load_jax_params``; inputs from a numpy seed.  Tolerances:
- forwards, the bias and the batch-norm statistics: rtol 1e-5 / atol 1e-5
  in fp32 (the same operations summed in another order);
- gradients: ``zoo_pins.assert_grads_close`` (rtol 1e-5 and 5e-4 of each
  leaf's largest; a leaf that is zero up to rounding, such as the key bias
  ahead of the softmax or the depthwise bias ahead of a training batch
  norm, to 5e-5 of the model's largest).  The depthwise-conv and swish
  path has no ReLU sign to pin;
- the layout round trip: exact.
Dropout is 0 where a forward is compared (its draws are each package's
own)."""

import dataclasses
import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.models import conformer as JC
from scl_deepfake_audio_detection_torch.models import conformer as PC
from scl_deepfake_audio_detection_torch.models.params import (
    buffers_to_jax,
    from_jax,
    load_jax_params,
    to_jax,
)
from scl_deepfake_audio_detection_torch.utils.tree import flatten

import zoo_pins

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_cli_eval.py
torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-5
# (dim, depth, dim_head, heads, conv_kernel, max_pos_emb): T = 12 > max_pos_emb,
# so offsets clip; the second has a square [9, 9] relative-position table
CONFIGS = {"rect": dict(dim=16, depth=2, dim_head=8, heads=2, conv_kernel=7, max_pos_emb=4),
           "square": dict(dim=16, depth=1, dim_head=9, heads=2, conv_kernel=5,
                          max_pos_emb=4)}


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The JAX ``init_conformer`` pair of a config, under one ``jit`` (op by
    op it costs seconds), as numpy trees."""
    cfg = JC.ConformerConfig(**CONFIGS[name])
    pair = jax.jit(lambda k: JC.init_conformer(k, cfg))(jax.random.key(0))
    return jax.tree.map(np.asarray, pair)


def _pair(name):
    kw = CONFIGS[name]
    params, buffers = _jax_init(name)
    model = PC.Conformer(PC.ConformerConfig(**kw))
    load_jax_params(model, params, buffers)
    return kw, params, buffers, model


def _jax_conformer(params, buffers, x, kw, train):
    """The JAX forward under one ``jit`` (op by op it costs seconds)."""
    fn = jax.jit(JC.conformer, static_argnames=("cfg", "train"))
    return fn(params, buffers, x, cfg=JC.ConformerConfig(**kw), train=train)


def _x(b=2, t=12, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(np.float32)


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def test_config_equals_the_jax_dataclass():
    jf = {f.name: f.default for f in dataclasses.fields(JC.ConformerConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(PC.ConformerConfig)}
    assert pf == jf


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_and_statistics_match_jax(name, train):
    kw, params, buffers, model = _pair(name)
    x = _x()
    want, new_buf = _jax_conformer(params, buffers, jnp.asarray(x), kw, train)
    got = model(torch.from_numpy(x), train=train)
    _close(got, want, "output")
    got_buf, want_buf = flatten(buffers_to_jax(model)), flatten(jax.tree.map(np.asarray, new_buf))
    assert set(got_buf) == set(want_buf)
    for k in want_buf:
        _close(got_buf[k], want_buf[k], k)
    moved = any(not np.array_equal(want_buf[k], flatten(buffers)[k]) for k in want_buf)
    assert moved == train


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_parameter_and_input_gradients_match_jax(train):
    kw, params, buffers, model = _pair("rect")
    cfg = JC.ConformerConfig(**kw)
    x = _x()
    ct = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        y, _ = JC.conformer(p, buffers, xx, cfg, train=train)
        return jnp.sum(y * ct)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (model(xt, train=train) * torch.from_numpy(ct)).sum().backward()
    want = from_jax(jax.tree.map(np.asarray, gp), model)
    got = {n: p.grad for n, p in model.named_parameters()}
    zoo_pins.assert_grads_close(got, want, "params")
    zoo_pins.assert_grads_close({"x": xt.grad}, {"x": torch.from_numpy(np.array(gx))}, "x")


def test_relative_position_bias_matches_jax():
    kw, params, _, model = _pair("rect")
    q = np.random.default_rng(2).standard_normal((2, 2, 12, 8)).astype(np.float32)
    want = JC._rel_pos_bias(params["blocks"][0]["attn"], jnp.asarray(q),
                            JC.ConformerConfig(**kw))
    _close(model.blocks[0].attn.rel_pos_bias(torch.from_numpy(q)), want)


def test_the_clipped_index_is_built_once_per_length():
    a = PC._clipped_offsets(12, 4, torch.device("cpu"))
    assert a is PC._clipped_offsets(12, 4, torch.device("cpu"))
    assert a.shape == (12, 12) and int(a.min()) == 0 and int(a.max()) == 8
    assert PC._clipped_offsets(13, 4, torch.device("cpu")).shape == (13, 13)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layout_round_trip_is_exact_and_the_table_keeps_its_layout(name):
    """``rel_pos`` is a token table [2 * max_pos_emb + 1, dim_head] in both
    packages: ``models/params`` must not transpose it, which a square table
    ([9, 9] in "square") would otherwise let through without an error."""
    _, params, buffers, model = _pair(name)
    table = params["blocks"][0]["attn"]["rel_pos"]["w"]
    assert np.array_equal(model.blocks[0].attn.rel_pos.weight.detach().numpy(), table)
    got, want = flatten(to_jax(model)), flatten(params)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    gb, wb = flatten(buffers_to_jax(model)), flatten(buffers)
    assert set(gb) == set(wb) and all(np.array_equal(gb[k], wb[k]) for k in wb)


def test_training_dropout_draws_from_the_generator():
    kw = dict(CONFIGS["rect"], attn_dropout=0.1, ff_dropout=0.1, conv_dropout=0.1)
    model = PC.Conformer(PC.ConformerConfig(**kw))
    params, buffers = _jax_init("rect")  # the dropout rates are no parameters
    x = torch.from_numpy(_x())

    def run(seed):
        load_jax_params(model, params, buffers)
        return model(x, train=True, generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    load_jax_params(model, params, buffers)
    plain = model(x, train=False)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.allclose(a, plain)


def test_the_models_package_loads_the_conformer_which_registers_no_name():
    import scl_deepfake_audio_detection_torch.models  # noqa: F401
    from scl_deepfake_audio_detection_torch.utils.registry import MODELS

    assert "scl_deepfake_audio_detection_torch.models.conformer" in sys.modules
    assert not [n for n in MODELS.names() if "conformer" in n.lower()]
