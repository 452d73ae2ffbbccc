"""The rest of the port's training surface vs the JAX package, on the CPU:
``--bf16_grads`` (``grad_stack_dtype='bfloat16'`` under fp32 compute),
remat 'dots' keeping the matmul outputs, the optax train-state interchange
in both directions, ``--average_ckpts`` and ``load_pretrained_partially``.

Tolerances: steps and parameters after a resume within 1e-5 (fp32, as
``tests/test_torch_train.py`` holds three Engine steps); the bf16-rounded
weight gradients within one bf16 step of the leaf's largest value, the
other gradients within 1e-4 of it; checkpoint averages and partial loads
exactly equal.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from scl_deepfake_audio_detection_tpu.cli import main as jax_main
from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_tpu.train import engine as JE
from scl_deepfake_audio_detection_tpu.train.optim import set_learning_rate as jset_lr
from scl_deepfake_audio_detection_tpu.utils.config import TrainConfig as JTrainConfig
from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.models import xlsr as PX
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.params import from_jax, load_jax_params
from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt
from scl_deepfake_audio_detection_torch.train import engine as PE
from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_CKPT = os.path.join(REPO, "tests", "golden", "mini_linear_nll.ckpt")
MATMUL_WEIGHTS = ("attn.q.weight", "attn.k.weight", "attn.v.weight", "attn.o.weight",
                  "fc1.weight", "fc2.weight")


@pytest.fixture(scope="module")
def golden_tree():
    return jckpt.load(GOLDEN_CKPT)[0]["params"]


@pytest.fixture(scope="module")
def ssl_tree():
    return jax.tree.map(np.asarray, JX.init_xlsr(jax.random.key(3), JX.XLSRConfig.tiny()))


def _wav():
    return (0.1 * np.random.default_rng(0).normal(size=(2, 2000))).astype(np.float32)


# ----------------------------------------------------------- --bf16_grads

def test_bf16_grad_stacks_under_fp32_compute_match_jax(ssl_tree):
    cfg = dict(compute_dtype="float32", grad_stack_dtype="bfloat16")
    model = load_jax_params(PX.XLSR(PX.XLSRConfig.tiny(**cfg)), ssl_tree)
    out = model.extract_features(torch.from_numpy(_wav()))
    g = np.random.default_rng(1).normal(size=tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(g)).sum().backward()
    got = {n: p.grad for n, p in model.named_parameters()}

    jcfg = JX.XLSRConfig.tiny(**cfg)

    def jloss(p):
        return jnp.sum(JX.extract_features(p, jcfg, jnp.asarray(_wav())) * g)

    jgrads = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, ssl_tree))
    want = from_jax(jax.tree.map(np.asarray, jgrads), model)
    # the forward runs on bf16-rounded weights: the output differs from fp32
    plain = load_jax_params(PX.XLSR(PX.XLSRConfig.tiny()), ssl_tree)
    assert not torch.equal(plain.extract_features(torch.from_numpy(_wav())), out.detach())
    for n, a in got.items():
        w = want[n].numpy()
        scale = np.abs(w).max()
        if n.endswith(MATMUL_WEIGHTS):
            assert torch.equal(a, a.bfloat16().float()), n  # rounded to bf16, upcast
            np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=2.0 ** -8 * scale, err_msg=n)
        elif n.endswith("attn.k.bias"):  # true gradient 0: rounding noise on both sides
            assert np.abs(a.numpy()).max() <= 1e-4 and np.abs(w).max() <= 1e-4, n
        else:
            np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=1e-4 * max(scale, 1.0),
                                       err_msg=n)
        assert a.dtype == torch.float32


def test_cli_builds_bf16_grad_stacks_from_the_flag():
    from argparse import Namespace

    from scl_deepfake_audio_detection_torch.cli.common import _build_model
    from scl_deepfake_audio_detection_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "conf-3-linear.yaml"))
    for flag, want in ((True, "bfloat16"), (False, None)):
        args = Namespace(ssl_preset="tiny", compute_dtype="float32", seed=1, bf16_grads=flag)
        assert _build_model(args, cfg, "cpu").ssl.cfg.grad_stack_dtype == want


# ------------------------------------------------------------ remat 'dots'

class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.overloadpacket == torch.ops.aten.mm
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dots_remat_keeps_the_matmul_outputs(ssl_tree, dtype):
    """Counted in the backward: 'dots' recomputes no matmul of the forward,
    'full' recomputes all six of each layer."""
    def backward_mms(remat, policy="attn"):
        model = load_jax_params(PX.XLSR(PX.XLSRConfig.tiny(
            compute_dtype=dtype, remat=remat, remat_policy=policy)), ssl_tree)
        out = model.extract_features(torch.from_numpy(_wav()))
        with _CountMM() as count:
            out.float().sum().backward()
        return count.n

    none, dots, full = backward_mms(False), backward_mms(True, "dots"), backward_mms(True, "full")
    layers = PX.XLSRConfig.tiny().encoder_layers
    assert dots == none and full == none + 6 * layers, (none, dots, full)


# ------------------------------------------------------- train-state interchange

def _batches(n=4):
    rng = np.random.default_rng(20240817)
    out = []
    for i in range(n):
        wav = ((0.2 + 0.1 * i) * rng.normal(size=(2, 4, 4000))).astype(np.float32)
        out.append({"wav": wav, "labels": np.tile([1.0, 1.0, 0.0, 0.0], (2, 1))
                    .astype(np.float32)})
    return out


def _assert_params(model, tree, msg):
    want = from_jax(jax.tree.map(np.asarray, tree), model)
    for n, p in model.named_parameters():
        if n.endswith("attn.k.bias"):  # true gradient 0: Adam moves it by noise
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{msg}: {n}")


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("clip", [None, 0.05], ids=["noclip", "clip"])
def test_each_package_resumes_the_others_train_state(golden_tree, tmp_path, clip, accum):
    """JAX: a step, save; the port resumes it, takes two steps, saves; the
    JAX package resumes that and both take the last step.  Every step and
    the parameters after it agree with an uninterrupted JAX run."""
    batches = _batches()
    jeng = JE.Engine(JLinearNLL(ssl=JX.XLSRConfig.tiny(), emb_dim=16, dropout=0.0),
                     JTrainConfig(grad_clip_norm=clip, grad_accum_steps=accum))
    params, buffers, opt = jeng.init_state(jax.random.key(0), params=golden_tree)
    opt = jset_lr(opt, 1e-4)

    def jstep(state, i):
        p, b, o = state
        p, b, o, m = jeng.train_step(p, b, o, jeng.place_batch(batches[i]), jax.random.key(i))
        return (p, b, o), {k: float(v) for k, v in m.items()}

    state, _ = jstep((params, buffers, opt), 0)
    jax_path = str(tmp_path / "jax.ckpt")
    jckpt.save_train_state(jax_path, state[0], state[2], 0, jax.random.key(5), 80.0)
    trail = []  # (host params, metrics) after steps 1-3; the step donates its inputs
    for i in (1, 2, 3):
        state, m = jstep(state, i)
        trail.append((jax.tree.map(np.asarray, state[0]), m))

    eng = PE.Engine(LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, dropout=0.0,
                              device="cpu"),
                    TrainConfig(grad_clip_norm=clip, grad_accum_steps=accum, weight_decay=0.5))
    eng.init_state()
    epoch, best, _ = pckpt.load_train_state(jax_path, eng.model, eng.optimizer)
    assert (epoch, best) == (0, 80.0)
    assert eng.optimizer.lr == pytest.approx(1e-4) and eng.optimizer.weight_decay == \
        pytest.approx(1e-4)  # the checkpoint's, as optax resumes its hyperparameters
    for i in (1, 2):
        m = eng.train_step(eng.place_batch(batches[i]), eng.step_generator(0, i))
        pj, mj = trail[i - 1]
        for k in mj:
            np.testing.assert_allclose(float(m[k]), mj[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"port step {i} {k}")
        _assert_params(eng.model, pj, f"port after step {i}")
    port_path = str(tmp_path / "port.ckpt")
    pckpt.save_train_state(port_path, eng.model, eng.optimizer, 1, 7, 81.0)

    tmpl = jeng.init_state(jax.random.key(1))[2]
    p2, b2, o2, epoch, rng, best = jckpt.load_train_state(port_path, tmpl)
    assert (epoch, best) == (1, 81.0)
    assert np.array_equal(jax.random.key_data(rng), jax.random.key_data(jax.random.key(5)))
    (p2, _, _), m2 = jstep((jax.tree.map(jnp.asarray, p2), b2, o2), 3)
    pj, mj = trail[2]
    for k in mj:
        np.testing.assert_allclose(m2[k], mj[k], rtol=1e-5, atol=1e-5, err_msg=f"jax {k}")
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(p2), jax.tree.leaves(pj)):
        path = jax.tree_util.keystr(path)
        if path.endswith("['attn']['k']['b']"):  # true gradient 0, as above
            continue
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=path)


def test_opt_leaves_round_trip_and_refuse_another_chain(golden_tree):
    def engine(**cfg):
        eng = PE.Engine(LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, device="cpu"),
                        TrainConfig(**cfg))
        eng.init_state(params=golden_tree)
        return eng

    eng = engine(grad_accum_steps=2)
    eng.train_step(eng.place_batch(_batches(1)[0]), eng.step_generator(0, 0))
    leaves = pckpt.pack_opt_leaves(eng.model, eng.optimizer)
    assert len(leaves) == 2 + 8 + 2 * 46 + 46 and int(leaves["0"]) == 1  # mini_step
    other = engine(grad_accum_steps=2)
    pckpt.unpack_opt_leaves(leaves, other.model, other.optimizer)
    again = pckpt.pack_opt_leaves(other.model, other.optimizer)
    assert all(np.array_equal(leaves[k], again[k]) for k in leaves)
    with pytest.raises(ValueError, match="takes 100"):
        pckpt.unpack_opt_leaves(leaves, engine().model, engine().optimizer)
    bad = dict(leaves)
    bad["3"] = np.float32(0.8)  # b1
    with pytest.raises(ValueError, match="b1"):
        pckpt.unpack_opt_leaves(bad, other.model, other.optimizer)


def test_seed_key_data_is_jax_random_key():
    for seed in (0, 7, 1234, 2 ** 33 + 5):
        assert np.array_equal(pckpt.seed_key_data(seed),
                              np.asarray(jax.random.key_data(jax.random.key(seed))))


# ------------------------------------------------------- --average_ckpts

def _port_states(tmp_path, golden_tree, n=3):
    paths = []
    for i in range(n):
        eng = PE.Engine(LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, device="cpu"),
                        TrainConfig())
        eng.init_state(params=jax.tree.map(lambda a: a * (1.0 + 0.25 * i), golden_tree))
        path = str(tmp_path / f"epoch_{i}.ckpt")
        pckpt.save_train_state(path, eng.model, eng.optimizer, i, 7, 90.0)
        paths.append(path)
    return paths


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_average_ckpts_equals_the_jax_cli(golden_tree, tmp_path):
    paths = _port_states(tmp_path, golden_tree)
    paths.append(str(tmp_path / "jax.ckpt"))
    jckpt.save(paths[-1], {"params": golden_tree, "rng_key": np.ones(2, np.uint32),
                           "step": np.int32(3)})
    for group in (paths[:3], paths[:2]):
        outs = [str(tmp_path / f"{who}_{len(group)}.ckpt") for who in ("jax", "port")]
        argv = ["--average_ckpts", ",".join(group)]
        j = _cli(jax_main, argv + ["--avg_out", outs[0]])
        p = _cli(port_main, argv + ["--avg_out", outs[1]])  # no --device cpu: no device
        assert j[0] == p[0] == 0 and p[1] == j[1].replace(outs[0], outs[1])
        (jt, je), (pt, pe) = jckpt.load(outs[0]), pckpt.load(outs[1])
        assert je == pe and pe["averaged_from"] == [os.path.abspath(x) for x in group]
        jf, pf = jckpt._flatten(jt), jckpt._flatten(pt)
        assert sorted(jf) == sorted(pf) and not any(k.startswith("opt_state") for k in pf)
        for k in jf:
            assert jf[k].dtype == pf[k].dtype and np.array_equal(jf[k], pf[k]), k
    for bad in ([paths[0]], [paths[0], paths[3]]):  # one file; another key set
        argv = ["--average_ckpts", ",".join(bad), "--avg_out", str(tmp_path / "x.ckpt")]
        j, p = _cli(jax_main, argv), _cli(port_main, argv)
        assert j[0] == p[0] == 2 and j[2] == p[2] and p[2]


def test_load_pretrained_partially_equals_jax():
    rng = np.random.default_rng(0)
    params = {"ssl": {"a": rng.normal(size=(2, 3)), "l": [rng.normal(size=2)]},
              "head": {"w": rng.normal(size=(3, 1))}}
    pre = {"ssl": {"a": rng.normal(size=(2, 3)), "l": [rng.normal(size=2)]},
           "head": {"w": rng.normal(size=(3, 1))}, "extra": {"z": np.zeros(1)}}
    params, pre = (jax.tree.map(lambda a: a.astype(np.float32), t) for t in (params, pre))
    for subtrees in (None, ["ssl"]):
        got = pckpt.load_pretrained_partially(params, pre, subtrees)
        want = jckpt.load_pretrained_partially(params, pre, subtrees)
        assert sorted(got) == sorted(want)
        for (pg, g), (pw, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                    jax.tree_util.tree_leaves_with_path(want)):
            assert pg == pw and np.array_equal(np.asarray(g), np.asarray(w))
    for bad, err in (({"ssl": {"a": np.zeros((2, 4)), "l": [np.zeros(2)]}}, ValueError),
                     ({"ssl": {"l": [np.zeros(2)]}}, KeyError)):
        with pytest.raises(err) as e_port:
            pckpt.load_pretrained_partially(params, bad, ["ssl"])
        with pytest.raises(err) as e_jax:
            jckpt.load_pretrained_partially(params, bad, ["ssl"])
        assert str(e_port.value) == str(e_jax.value)
