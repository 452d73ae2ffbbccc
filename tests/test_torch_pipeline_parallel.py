"""``parallel/pipeline.pipeline_apply`` against the JAX package's at two
stages: the port's two stages run as two gloo ranks on the CPU
(``tests/torch_parallel_ranks.pipeline_ranks``), the JAX pipeline on two of
the conftest's virtual devices; values within 1e-6 and gradients within
1e-5, as ``tests/test_pipeline.py`` holds the JAX pipeline to its
sequential scan.  A rank's gradient is non-zero only at its own layers (and
x's only on stage 0), so the ranks' gradients are summed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.parallel import make_mesh
from scl_deepfake_audio_detection_tpu.parallel.pipeline import pipeline_apply as jpipeline
from scl_deepfake_audio_detection_torch.parallel import mesh as M
from scl_deepfake_audio_detection_torch.parallel.pipeline import pipeline_apply

import torch_parallel_ranks as R

L, D, B = 8, 16, 8


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1234)
    weights = {"w": (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32),
               "b": (rng.normal(size=(L, D)) * 0.1).astype(np.float32)}
    return weights, rng.normal(size=(B, D)).astype(np.float32)


def _layer(x, p):
    return jnp.tanh(x @ p["w"] + p["b"])


@pytest.fixture(scope="module")
def two_stages(case, tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe")
    weights, x = case
    assert M.launch(R.pipeline_ranks, 2, args=(str(out), weights, x, 4), threads=1,
                    timeout=120) == [0, 0]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_two_stage_values_and_gradients_match_jax(case, two_stages):
    weights, x = case
    mesh = make_mesh((2,), axis_names=("pipe",), devices=jax.devices()[:2])
    stacked = jax.tree.map(jnp.asarray, weights)

    def loss(p, xx):
        y = jpipeline(_layer, p, xx, mesh, axis="pipe", microbatches=4)
        return jnp.sum(y * y), y

    (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        stacked, jnp.asarray(x))
    for r in two_stages:  # the output on every stage
        np.testing.assert_allclose(r["y"].numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)
    grads = {k: sum(r[k] if r[k] is not None else 0 for r in two_stages)
             for k in ("dw", "db", "dx")}
    np.testing.assert_allclose(grads["dw"].numpy(), np.asarray(gp["w"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads["db"].numpy(), np.asarray(gp["b"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads["dx"].numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    # each stage's gradient lives at its own half of the stack
    assert float(two_stages[0]["dw"][L // 2:].abs().max()) == 0.0
    assert float(two_stages[1]["dw"][:L // 2].abs().max()) == 0.0
    assert two_stages[1]["dx"] is None


def test_one_rank_is_the_plain_stack(case):
    weights, x = case
    stacked = {k: torch.from_numpy(v) for k, v in weights.items()}
    got = pipeline_apply(lambda h, p: torch.tanh(h @ p["w"] + p["b"]), stacked,
                         torch.from_numpy(x))
    want = x
    for i in range(L):
        want = np.tanh(want @ weights["w"][i] + weights["b"][i])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
