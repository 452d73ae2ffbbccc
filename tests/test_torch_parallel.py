"""The port's parallel path (``parallel/mesh``, tensor-parallel XLS-R layers,
synced batch norm, ``Engine`` and ``train/optim`` over a mesh) against the
JAX ``Engine`` on the conftest's virtual CPU devices, mesh shape for mesh
shape.

The port's ranks run in processes of their own (gloo on the CPU, one torch
thread each), started by ``parallel/mesh.launch`` once per group size:
``tests/torch_parallel_ranks.py`` holds what they run (it imports no JAX).
The same numpy parameters (the JAX model's seeded init) and numpy batches
go to both sides; the head's dropout is 0 (the two packages draw other
masks).

Tolerances (``tests/test_torch_train.py``'s, ``tests/zoo_pins.py``'s):
parameters after the steps and metrics within 1e-5; gradients and AdamW's
moments within 5e-4 of each leaf's largest entry.  The attention key bias
has a true gradient of 0 (the softmax removes it); both sides move it by
rounding noise, so it is held to its bound (lr per step), not to JAX.
The AASIST gradients are taken with the JAX model pinned to the port's
discrete choices (``tests/zoo_pins.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.aasist import XLSRAasist as JAasist
from scl_deepfake_audio_detection_tpu.models.base import model_buffers
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.parallel import make_mesh as jmake_mesh
from scl_deepfake_audio_detection_tpu.parallel import memory as JMem
from scl_deepfake_audio_detection_tpu.parallel import shard_batch as jshard_batch
from scl_deepfake_audio_detection_tpu.parallel import shard_params as jshard_params
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_tpu.train import engine as JE
from scl_deepfake_audio_detection_tpu.train.optim import set_learning_rate as jset_lr
from scl_deepfake_audio_detection_tpu.utils.config import TrainConfig as JTrainConfig
from scl_deepfake_audio_detection_torch.models import xlsr as PX
from scl_deepfake_audio_detection_torch.models.aasist import XLSRAasist
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.params import from_jax, load_jax_params
from scl_deepfake_audio_detection_torch.parallel import memory as PMem
from scl_deepfake_audio_detection_torch.parallel import mesh as M
from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt
from scl_deepfake_audio_detection_torch.train import engine as PE
from scl_deepfake_audio_detection_torch.train.optim import make_optimizer, set_learning_rate
from scl_deepfake_audio_detection_torch.utils.config import TrainConfig
from scl_deepfake_audio_detection_torch.utils.tree import flatten

import torch_parallel_ranks as R
import zoo_pins

torch.set_num_threads(2)
KEY_BIAS = "attn//k//b"


def _launch(fn, world, *args):
    assert M.launch(fn, world, args=args, threads=1, timeout=240) == [0] * world


@pytest.fixture(scope="module")
def tree():
    jm = JLinearNLL(ssl=JX.XLSRConfig.tiny(), emb_dim=16, dropout=0.0)
    return jax.tree.map(np.asarray, jm.init(jax.random.key(0)))


@pytest.fixture(scope="module")
def aasist_case():
    """The narrow AASIST's parameters, buffers, [2, 4, 3200] batch and head
    dropout masks (the JAX model's draws for the step key)."""
    jm = JAasist(ssl=JX.XLSRConfig.tiny())
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0)))
    buffers = jax.tree.map(np.asarray, model_buffers(jm))
    rng = np.random.default_rng(0)
    wav = (0.1 * rng.normal(size=(2, 4, 3200))).astype(np.float32)
    labels = np.tile(np.array([1, 1, 0, 0], np.float32), (2, 1))
    key = jax.random.key(6)
    keys = jax.random.split(key, 24)
    sites = XLSRAasist(ssl=PX.XLSRConfig.tiny(), device="meta").dropout_sites(8, 3200)
    masks = [np.array(jax.random.bernoulli(keys[1 + i], 1.0 - rate, shape))
             for i, (rate, shape) in enumerate(sites)]
    return jm, params, buffers, wav, labels, masks, key


@pytest.fixture(scope="module")
def two(tree, aasist_case, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks2")
    _, params, buffers, wav, labels, masks, _ = aasist_case
    _launch(R.two_ranks, 2, str(out), tree, (params, buffers, wav, labels, masks))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def four(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks4")
    _launch(R.four_ranks, 4, str(out), tree)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)], \
        str(out / "zero1.ckpt")


def _jax_engine(shape, **cfg):
    jm = JLinearNLL(ssl=JX.XLSRConfig.tiny(), emb_dim=16, dropout=0.0)
    mesh = jmake_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    return JE.Engine(jm, JTrainConfig(max_lr=R.LR, **cfg), mesh=mesh)


def _port_moments(opt_state):
    """optax's state -> the port's whole ``exp_avg//`` / ``exp_avg_sq//``
    arrays (through the checkpoint interchange)."""
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, device="cpu")
    opt = make_optimizer(model.named_parameters())
    pckpt.unpack_opt_leaves([np.asarray(x) for x in jax.tree.leaves(opt_state)], model, opt)
    return {k: v.float() for k, v in opt.state_arrays().items()}


_JAX_RUNS = {}


def _jax_run(tree, shape, n=2, **cfg):
    """Steps of the JAX Engine on ``shape``: (metrics, flat params, moments)."""
    key = (shape, n, tuple(sorted(cfg.items())))
    if key not in _JAX_RUNS:
        eng = _jax_engine(shape, **cfg)
        p, b, o = eng.init_state(jax.random.key(0), params=tree)
        o = jset_lr(o, R.LR)
        metrics = []
        for i, batch in enumerate(R.linear_batches()[:n]):
            p, b, o, m = eng.train_step(p, b, o, eng.place_batch(batch), jax.random.key(i))
            metrics.append({k: float(v) for k, v in m.items()})
        _JAX_RUNS[key] = (metrics, flatten(jax.tree.map(np.asarray, p)), _port_moments(o))
    return _JAX_RUNS[key]


def _assert_run(got, want, tree, steps=2):
    jm, jp, jo = want
    for i, (a, b) in enumerate(zip(got["metrics"], jm)):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5, err_msg=f"step {i} {k}")
    start = flatten(tree)
    for k, w in jp.items():
        g = got["params"][k]
        if k.endswith(KEY_BIAS):  # noise gradient: each side moves at most lr a step
            for x in (g, w):
                assert np.abs(x - start[k]).max() <= steps * R.LR * 1.0001, k
            continue
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)
    assert sorted(got["opt"]) == sorted(jo)
    for k, w in jo.items():
        if w.dim() == 0 or ".attn.k.bias" in k:
            if w.dim() == 0:
                assert int(got["opt"][k]) == int(w), k
            continue
        tol = 5e-4 * float(w.abs().max()) + 1e-12
        assert float((got["opt"][k] - w).abs().max()) <= tol, k


def _ranks_agree(results, key):
    for other in results[1:]:
        for k, v in results[0][key]["params"].items():
            np.testing.assert_array_equal(other[key]["params"][k], v, err_msg=k)


# ------------------------------------------------------------- the mesh steps

@pytest.mark.parametrize("case,shape,cfg", [
    ("dp", (2, 1), {}),
    ("tp", (1, 2), {}),
    ("dp_zero1", (2, 1), {}),
    ("tp_clip", (1, 2), {"grad_clip_norm": 1e-3}),
])
def test_two_rank_steps_match_the_jax_engine(two, tree, case, shape, cfg):
    """dp (2, 1), tp (1, 2) and ZeRO-1 at (2, 1) against the JAX Engine's
    replicated optimizer on the same mesh shape, and tp with the gradient
    clipped by its global norm (the split leaves' squares summed over the
    model ranks); every rank ends with the same parameters."""
    _assert_run(two[0][case], _jax_run(tree, shape, **cfg), tree)
    _ranks_agree(two, case)


def _jax_2x2(tree, **cfg):
    """The JAX Engine at (2, 2), whose gradient of the grouped positional
    conv's weight is twice its gradient at (1, 1), (2, 1) and (1, 2) (a
    fault of the JAX package's dp x tp step, ROADMAP.md section 3; AdamW's
    first steps hide it from the parameters, its moments show it): that
    leaf's moments are held to the JAX (1, 1) run's, after checking the
    factor."""
    metrics, params, moments = _jax_run(tree, (2, 2), **cfg)
    one = _jax_run(tree, (1, 1), **cfg)[2]
    moments = dict(moments)
    for k, factor in (("exp_avg//ssl.pos_conv.weight", 2.0),
                      ("exp_avg_sq//ssl.pos_conv.weight", 4.0)):
        np.testing.assert_allclose(moments[k].numpy(), factor * one[k].numpy(), rtol=1e-4,
                                   atol=1e-4 * float(one[k].abs().max()) * factor)
        moments[k] = one[k]
    return metrics, params, moments


def test_dp_tp_steps_match_the_jax_engine(four, tree):
    ranks, _ = four
    _assert_run(ranks[0]["dptp"], _jax_2x2(tree), tree)
    _assert_run(ranks[0]["dptp_zero1"], _jax_2x2(tree), tree)
    _ranks_agree(ranks, "dptp")


def test_zero1_matches_the_jax_zero1_engine(two, four, tree):
    want2 = _jax_run(tree, (2, 1), zero1=True, zero1_min_size=256)
    _assert_run(two[0]["dp_zero1"], want2, tree)
    _assert_run(four[0][0]["dptp_zero1"], _jax_2x2(tree, zero1=True, zero1_min_size=256),
                tree)


def test_tensor_parallel_and_zero1_split_the_state(two, four, tree):
    """Under (1, 2) each rank holds half of q, k, v, fc1 (rows) and o, fc2
    (columns) and the whole of the rest; ZeRO-1 at (2, 1) keeps a half of
    the larger leaves' moments, and at (2, 2) on an axis 'model' leaves
    free."""
    tp = two[0]["tp"]["local_shapes"]
    layer = "ssl.encoder.layers.0."
    assert tp[layer + "attn.q.weight"] == (16, 32) and tp[layer + "attn.q.bias"] == (16,)
    assert tp[layer + "attn.o.weight"] == (32, 16) and tp[layer + "attn.o.bias"] == (32,)
    assert tp[layer + "fc1.weight"] == (32, 32) and tp[layer + "fc2.weight"] == (32, 32)
    assert tp[layer + "ln_attn.weight"] == (32,)
    whole = LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, device="cpu")
    load_jax_params(whole, tree)
    for n, p in whole.named_parameters():  # gather_params: the shards whole again
        assert torch.equal(two[0]["tp_gathered"][n], p.detach()), n
    z = two[0]["dp_zero1"]
    split = [n for n, s in z["moment_shapes"].items() if s != z["local_shapes"][n]]
    assert layer + "fc1.weight" in split
    assert z["moment_shapes"][layer + "fc1.weight"] in ((32, 32), (64, 16))
    z4 = four[0][0]["dptp_zero1"]
    assert z4["local_shapes"][layer + "fc1.weight"] == (32, 32)
    assert z4["moment_shapes"][layer + "fc1.weight"] == (32, 16)  # dim 0 is 'model''s


def test_global_loss_scope_matches_the_jax_engine(two, tree):
    """'global' scope: the loss over every shard's gathered outputs."""
    _assert_run(two[0]["dp_global"], _jax_run(tree, (2, 1), n=1, loss_scope="global"),
                tree, steps=1)


def test_sharded_score_step_rows(two, tree):
    eng = _jax_engine((2, 1))
    p, b, _ = eng.init_state(jax.random.key(0), params=tree)
    wav = np.random.default_rng(3).normal(size=(8, 3200)).astype(np.float32)
    want = np.asarray(eng.score_step(p, b, eng.place_batch({"wav": wav})["wav"]))
    for r in two:
        np.testing.assert_allclose(r["score"].numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["score_ragged"].numpy(), want[:5], rtol=1e-5, atol=1e-5)


def test_synced_batch_norm_matches_jax(two, aasist_case):
    """AASIST at (2, 1): the running statistics after the step and the
    data-mean gradients against the JAX step on the same mesh (its batch
    norm over the whole batch)."""
    jm, params, buffers, wav, labels, masks, key = aasist_case
    model = load_jax_params(XLSRAasist(ssl=PX.XLSRConfig.tiny(), device="cpu"), params,
                            buffers)
    with zoo_pins.record_port() as choices:
        model.apply(torch.from_numpy(wav.reshape(8, -1)), train=True,
                    dropout_masks=[torch.from_numpy(m) for m in masks])
    mesh = jmake_mesh((2, 1), devices=jax.devices()[:2])
    pp, bb = jshard_params(params, mesh), jshard_params(buffers, mesh)
    batch = jshard_batch({"wav": jnp.asarray(wav), "labels": jnp.asarray(labels)}, mesh)

    def total(p):
        return JE._loss_and_metrics(p, bb, jm, batch, key, True, "group")

    with zoo_pins.pin_jax(choices):
        grads, (metrics, new_buffers, _) = jax.jit(jax.grad(total, has_aux=True))(pp)
    want = from_jax(jax.tree.map(np.asarray, grads), model)
    want_buf = from_jax(params, model, jax.tree.map(np.asarray, new_buffers))
    for r in two:
        got = r["aasist"]
        for k in ("L_CE", "L_CF1", "L_CF2"):
            np.testing.assert_allclose(float(got["terms"][k]), float(metrics[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        for n, v in got["buffers"].items():
            np.testing.assert_allclose(v.numpy(), want_buf[n].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=n)
        zoo_pins.assert_grads_close(got["grads"], want, "AASIST (2, 1)")


def test_zero1_checkpoint_resumes_at_one_rank_and_in_jax(four, tree):
    """The (2, 2) ZeRO-1 train state holds the whole moments in the JAX
    layout: the port at (1, 1) and the JAX Engine resume it and take the
    same next step."""
    ranks, path = four
    saved = ranks[0]["dptp_zero1"]
    _, extra = pckpt.load(path)
    assert extra["epoch"] == 0 and extra["best"] == 91.0
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, dropout=0.0, device="cpu")
    eng = PE.Engine(model, TrainConfig(zero1=True, zero1_min_size=256))
    eng.init_state()
    pckpt.load_train_state(path, model, eng.optimizer)
    arrays = eng.optimizer.state_arrays()
    for k, v in saved["opt"].items():
        assert torch.equal(arrays[k].float(), v), k
    batch = R.linear_batches(3)[2]
    got = eng.train_step(eng.place_batch(batch), eng.step_generator(0, 2))

    jeng = _jax_engine((2, 1), zero1=True, zero1_min_size=256)
    _, _, tmpl = jeng.init_state(jax.random.key(0), params=tree)
    p, b, o, epoch, _, best = jckpt.load_train_state(path, tmpl)
    assert epoch == 0 and best == 91.0
    for k, v in flatten(jax.tree.map(np.asarray, p)).items():
        np.testing.assert_array_equal(v, saved["params"][k], err_msg=k)
    p, b, o, want = jeng.train_step(p, b, o, jeng.place_batch(batch), jax.random.key(2))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    start = saved["params"]
    from scl_deepfake_audio_detection_torch.models.params import to_jax
    mine = flatten(to_jax(model))
    for k, w in flatten(jax.tree.map(np.asarray, p)).items():
        if k.endswith(KEY_BIAS):
            assert np.abs(mine[k] - start[k]).max() <= R.LR * 1.0001, k
            continue
        np.testing.assert_allclose(mine[k], w, rtol=1e-5, atol=1e-5, err_msg=k)


def test_distillation_over_dp_and_tp_equals_one_process(four):
    """``DistillEngine`` at (2, 2), teacher and student tensor parallel,
    the student's head dropout on: the one-process run's metrics and
    student (the JAX package's distillation is held to the port's in
    ``tests/test_torch_distill.py``)."""
    got, want = four[0][0]["distill"], R.distill_run()
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in want["params"].items():
        if k.endswith(KEY_BIAS):
            continue
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-5, atol=1e-5, err_msg=k)


# ------------------------------------------------------------- in one process

def test_param_pspecs_follow_the_jax_rules():
    """The JAX rules on [in, out] leaves (q, k, v, fc1 split on 'out'; o and
    fc2 on 'in'; o's and fc2's biases whole) as the port's [out, in] dims;
    the head and the norms stay whole."""
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(fuse_qkv=True), emb_dim=16, device="meta")
    specs = M.param_pspecs(model)
    layer = "ssl.encoder.layers.1."
    want = {"attn.q.weight": 0, "attn.q.bias": 0, "attn.k.weight": 0, "attn.v.bias": 0,
            "attn.o.weight": 1, "attn.o.bias": None, "fc1.weight": 0, "fc1.bias": 0,
            "fc2.weight": 1, "fc2.bias": None, "ln_attn.weight": None}
    for k, v in want.items():
        assert specs[layer + k] == v, k
    assert all(v is None for k, v in specs.items() if not k.startswith("ssl.encoder.layers."))
    jspecs = jax.tree_util.tree_leaves_with_path(
        __import__("scl_deepfake_audio_detection_tpu.parallel", fromlist=["param_pspecs"])
        .param_pspecs(JLinearNLL(ssl=JX.XLSRConfig.tiny(), emb_dim=16).init(jax.random.key(0))),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    split = sorted("/".join(str(getattr(p, "key", p)) for p in path)
                   for path, s in jspecs if "model" in tuple(s))
    assert split == sorted(f"ssl/encoder/layers/{n}" for n in (
        "attn/q/w", "attn/q/b", "attn/k/w", "attn/k/b", "attn/v/w", "attn/v/b", "attn/o/w",
        "fc1/w", "fc1/b", "fc2/w"))


def test_zero1_spec_takes_the_largest_free_axis():
    assert M.zero1_spec((64, 32), 2, min_size=256) == 0
    assert M.zero1_spec((32, 64), 2, taken=1, min_size=256) == 0
    assert M.zero1_spec((64, 32), 2, taken=0, min_size=256) == 1
    assert M.zero1_spec((64, 32), 1, min_size=256) is None
    assert M.zero1_spec((64, 32), 2) is None  # below 1 << 16
    assert M.zero1_spec((63, 33), 2, min_size=256) is None


def test_mesh_and_environment_errors(monkeypatch):
    """A mesh that is not the number of ranks raises as the JAX make_mesh
    does for its devices; an explicit cluster environment that is
    incomplete or malformed raises; none is None."""
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=4, device="cpu")
    with pytest.raises(ValueError, match="mesh shape"):
        PE.Engine(model, TrainConfig(mesh_shape=[2, 1]))
    assert M.parse_mesh("4,2") == (4, 2) and M.parse_mesh(None) is None
    for bad in ("4", "0,1", "a,b"):
        with pytest.raises(ValueError):
            M.parse_mesh(bad)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "SCL_DIST_INIT", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert M.cluster_env() is None
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        M.cluster_env()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "x")
    with pytest.raises(ValueError, match="malformed"):
        M.cluster_env()
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(ValueError, match="malformed"):
        M.cluster_env()
    monkeypatch.setenv("RANK", "1")
    assert M.cluster_env()["rank"] == 1


def test_dropout_masks_do_not_depend_on_the_split():
    """A data shard's dropout draws the whole batch's mask and keeps its
    rows; a tensor-parallel part keeps its columns."""
    from scl_deepfake_audio_detection_torch.ops.layers import dropout

    x = torch.ones(6, 5, 8)
    whole = dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    shard = M.BatchShard(None, 3, 1, 2, 4, 6)
    with M.batch_shard(shard):
        part = dropout(x[2:4], 0.5, True, torch.Generator().manual_seed(3))
        cols = dropout(x[2:4, :, 4:], 0.5, True, torch.Generator().manual_seed(3),
                       part=(2, 1, 2))
    assert torch.equal(part, whole[2:4]) and torch.equal(cols, whole[2:4, :, 4:])


_JAX_PARAM_COUNTS = {}


def _jax_param_count(cfg, count=JMem.param_count):
    """The JAX package's ``param_count`` (a trace of the whole init), once
    per config: ``estimate_train_hbm`` calls it again for the same config."""
    if cfg not in _JAX_PARAM_COUNTS:
        _JAX_PARAM_COUNTS[cfg] = count(cfg)
    return _JAX_PARAM_COUNTS[cfg]


@pytest.mark.parametrize("preset", ["xlsr_300m", "xlsr_1b", "xlsr_2b"])
@pytest.mark.parametrize("layout", [(1, 1, False, "attn"), (4, 2, True, "attn"),
                                    (8, 1, True, "attn_ffn"), (2, 4, False, None)])
def test_memory_sums_match_jax(preset, layout, monkeypatch):
    monkeypatch.setattr(JMem, "param_count", _jax_param_count)
    dp, tp, zero1, policy = layout
    kw = dict(compute_dtype="bfloat16", remat=policy is not None,
              remat_policy=policy or "attn")
    jc, pc = getattr(JX.XLSRConfig, preset)(**kw), getattr(PX.XLSRConfig, preset)(**kw)
    assert PMem.param_count(pc) == JMem.param_count(jc)
    want = JMem.estimate_train_hbm(jc, 22, 64000, dp=dp, tp=tp, zero1=zero1, head_params=1000)
    got = PMem.estimate_train_memory(pc, 22, 64000, dp=dp, tp=tp, zero1=zero1, head_params=1000)
    for f in ("params_gb", "grads_gb", "opt_gb", "saved_acts_gb", "transient_gb",
              "conv_acts_gb", "analytic_gb"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12), f
    assert got.total_gb == pytest.approx(got.analytic_gb * PMem.H100_OVERHEAD)
    assert PMem.fits(got, 80.0) == (got.total_gb <= 80.0)


def test_gan_over_two_data_ranks_matches_the_jax_engine(two):
    """``train/gan.GANEngine`` over a (2, 1) mesh of two gloo ranks (each
    rank steps on its half of the 16 rows; both nets' gradients averaged
    over 'data') against the JAX ``GANEngine`` on a (2, 1) mesh of virtual
    devices, from the same parameters: both nets within 1e-5 after 3 steps,
    the metrics too, and the ranks identical to each other."""
    from scl_deepfake_audio_detection_tpu.ops.layers import init_linear, linear
    from scl_deepfake_audio_detection_tpu.train.gan import GANEngine as JGANEngine

    class JMLP:
        def __init__(self, sizes, squeeze=False):
            self.sizes, self.squeeze = sizes, squeeze

        def init(self, key):
            ks = jax.random.split(key, len(self.sizes) - 1)
            return [init_linear(k, i, o) for k, i, o in zip(ks, self.sizes[:-1], self.sizes[1:])]

        def apply(self, params, x, train=False, rng=None):
            for i, p in enumerate(params):
                x = linear(p, x)
                x = jax.nn.relu(x) if i < len(params) - 1 else x
            return x[..., 0] if self.squeeze else x

    (init_g, init_d), final, metrics = two[0]["gan"]
    sg, sd = R.GAN_SIZES
    jeng = JGANEngine(JMLP(sg), JMLP(sd, True), sg[0], lr_g=1e-2, lr_d=5e-3,
                      mesh=jmake_mesh((2, 1), devices=jax.devices()[:2]))
    _, _, og, od = jeng.init_state(jax.random.key(0))
    *state, jm = jeng.run_epoch(init_g, init_d, og, od, R.gan_batches(), jax.random.key(1))
    for got, want in zip(final, state[:2]):
        got, want = flatten(got), flatten(jax.tree.map(np.asarray, want))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    for k in jm:
        np.testing.assert_allclose(metrics[k], float(jm[k]), rtol=1e-5, atol=1e-5)
    other = flatten(two[1]["gan"][1])
    for k, v in flatten(final).items():
        np.testing.assert_array_equal(v, other[k])


def test_one_rank_optimizer_is_unchanged_by_the_mesh_code(tree):
    """With no mesh the optimizer's state and step are the one-process
    ones: ZeRO-1 over one data rank splits nothing."""
    a = R._linear_engine(tree, (1, 1))
    b = R._linear_engine(tree, (1, 1), zero1=True, zero1_min_size=1)
    assert all(t is p for t, p in zip(b.optimizer.targets, b.optimizer.params))
    for eng in (a, b):
        set_learning_rate(eng.optimizer, R.LR)
        eng.train_step(eng.place_batch(R.linear_batches(1)[0]), eng.step_generator(0, 0))
    for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), n


def test_dryrun_multichip_over_two_ranks(capfd):
    """``parallel/dryrun.dryrun_multichip`` (the counterpart of
    ``__graft_entry__.dryrun_multichip``): one dp x tp step, a batch-norm
    head's step and sharded scoring over two CPU ranks (1 data x 2 model)."""
    from scl_deepfake_audio_detection_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(2)
    out = capfd.readouterr().out
    for r in range(2):
        assert f"rank {r}: dryrun_multichip ok: mesh=(1 data x 2 model)" in out
        assert f"rank {r}: dryrun_multichip bn-head ok" in out
        assert f"rank {r}: dryrun_multichip sharded scoring ok: (2, 2)" in out
