"""The port's training path vs the JAX package, on the CPU at the tiny
config: ``linear``'s two backward rules, XLS-R gradients under each remat
setting, ``LinearNLL`` training, ``Engine`` steps, ``fit`` and the train-state
checkpoints.

Tolerances, with their reasons:
- fp32 gradients and steps: 1e-5 relative and absolute, or 1e-4 through the
  whole tiny encoder; fp32 sums in another order (and the port's flash
  attention against the JAX package's einsum on the CPU);
- bf16 gradients of one op: one bf16 ulp of the largest magnitude (2^-7 of
  max |g|), since both round the same fp32 sums, taken in another order;
- bf16 gradients through the tiny encoder: 5e-2 of max |g| per leaf, since
  the two frameworks round activations at different points (see
  ``tests/test_torch_xlsr.py``) and the backward carries that on;
- the port's three remat settings compute the same operations in the same
  order, so their gradients are held equal bit for bit; these runs take
  one CPU thread, so that the CPU libraries cannot split a reduction
  differently between them;
- the key bias of attention adds one constant to every score of a row,
  which the softmax removes: its true gradient is 0 and both frameworks
  give rounding noise, so it is held small against the key weight's
  gradient instead, and left out of the Adam trajectory (Adam scales noise
  up to full steps);
- the golden train-step pin uses the tolerances of
  ``tests/test_golden_pipeline.py``."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.ops import layers as JLay
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_tpu.train import engine as JE
from scl_deepfake_audio_detection_tpu.train.optim import set_learning_rate as jset_lr
from scl_deepfake_audio_detection_tpu.utils.config import TrainConfig as JTrainConfig
from scl_deepfake_audio_detection_torch.models import xlsr as PX
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.params import from_jax, load_jax_params, to_jax
from scl_deepfake_audio_detection_torch.ops import layers as PLay
from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt
from scl_deepfake_audio_detection_torch.train import engine as PE
from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
from scl_deepfake_audio_detection_torch.utils.config import TrainConfig
from scl_deepfake_audio_detection_torch.utils.tree import flatten

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_CKPT = os.path.join(REPO, "tests", "golden", "mini_linear_nll.ckpt")


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _bf16_close(got, want, err_msg=""):
    want = _f32(want)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max(), err_msg=err_msg)


@pytest.fixture(scope="module")
def golden_tree():
    return jckpt.load(GOLDEN_CKPT)[0]["params"]


def _golden_batch(t=8000):
    rng = np.random.default_rng(20240817)
    wav = (0.2 * rng.normal(size=(2, 4, t))).astype(np.float32)
    labels = np.tile([1.0, 1.0, 0.0, 0.0], (2, 1)).astype(np.float32)
    return {"wav": wav, "labels": labels}


# ------------------------------------------------------------------ linear

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast", [False, True], ids=["plain", "fast"])
def test_linear_gradients_match_jax(rng, dtype, fast):
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    w = rng.normal(size=(8, 6)).astype(np.float32)  # JAX layout [in, out]
    b = rng.normal(size=(6,)).astype(np.float32)
    g = rng.normal(size=(3, 5, 6)).astype(np.float32)
    jd = jnp.dtype(dtype)

    def jloss(x, w, b):
        return jnp.sum(JLay.linear({"w": w, "b": b}, x, jd, fast_bwd=fast) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, w.T, b))
    y = PLay.linear(tx, tw, tb, getattr(torch, dtype), fast_bwd=fast)
    assert y.dtype == torch.float32
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum(), (tx, tw, tb))
    pairs = zip("xwb", got, (want[0], want[1].T, want[2]))
    for name, a, bb in pairs:
        if dtype == "float32" or name == "b":
            np.testing.assert_allclose(a.numpy(), _f32(bb), rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            _bf16_close(a.numpy(), bb, name)


def test_fast_backward_rounds_the_cotangent_once(rng):
    """Under bf16 the fast rule's dX is the bf16 GEMM of bf16(dy); the plain
    rule's differs from it by at most a few bf16 steps."""
    x = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(8, 32)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)) / 3
    dx = {}
    for fast in (False, True):
        xx = x.clone().requires_grad_()
        (PLay.linear(xx, w, fast_bwd=fast) * g).sum().backward()
        dx[fast] = xx.grad.float()
    want = (g.bfloat16().float() @ w.float()).bfloat16().float()
    assert torch.equal(dx[True], want)
    assert (dx[False] - dx[True]).abs().max() <= 2 * 2.0 ** -7 * want.abs().max()


# ----------------------------------------------------------------- dropout

def test_dropout_semantics():
    x = torch.arange(1.0, 9.0).reshape(2, 4)
    mask = torch.tensor([[True, False, True, True], [False, False, True, True]])
    got = PLay.dropout(x, 0.5, True, mask=mask)
    assert torch.equal(got, torch.where(mask, x * 2, torch.zeros_like(x)))
    assert PLay.dropout(x, 0.5, False) is x and PLay.dropout(x, 0.0, True) is x
    big = torch.ones(200_000)
    a = PLay.dropout(big, 0.3, True, torch.Generator().manual_seed(3))
    b = PLay.dropout(big, 0.3, True, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert abs((a > 0).float().mean().item() - 0.7) < 5e-3
    assert torch.allclose(a[a > 0], torch.full_like(a[a > 0], 1 / 0.7))


# ------------------------------------------------------------------- XLS-R

def _xlsr_grads(params, dtype, remat, policy="attn", train=False, seed=None, **kw):
    cfg = PX.XLSRConfig.tiny(compute_dtype=dtype, remat=remat, remat_policy=policy, **kw)
    model = load_jax_params(PX.XLSR(cfg), params)
    wav = torch.from_numpy((0.1 * np.random.default_rng(0).normal(size=(2, 2000)))
                           .astype(np.float32))
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    out = model.extract_features(wav, train=train, generator=gen)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=tuple(out.shape))
                         .astype(np.float32))
    (out.float() * g).sum().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}, g.numpy()


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread: a reduction's order then depends on the program
    alone, not on how the CPU libraries split it across threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ssl_tree():
    return jax.tree.map(np.asarray, JX.init_xlsr(jax.random.key(3), JX.XLSRConfig.tiny()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlsr_gradients_match_jax_and_agree_across_remat(ssl_tree, dtype):
    with _one_thread():
        grads = {r: _xlsr_grads(ssl_tree, dtype, r is not None, r or "attn")[0]
                 for r in (None, *PX.REMAT_POLICIES)}
    for r in PX.REMAT_POLICIES:
        for n, a in grads[None].items():
            assert torch.equal(a, grads[r][n]), (r, n)

    g = _xlsr_grads(ssl_tree, dtype, False)[1]
    jcfg = JX.XLSRConfig.tiny(compute_dtype=dtype)
    wav = (0.1 * np.random.default_rng(0).normal(size=(2, 2000))).astype(np.float32)

    def jloss(p):
        return jnp.sum(JX.extract_features(p, jcfg, jnp.asarray(wav)).astype(jnp.float32) * g)

    jgrads = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, ssl_tree))
    want = from_jax(jax.tree.map(np.asarray, jgrads), PX.XLSR(PX.XLSRConfig.tiny()))
    rel = 1e-4 if dtype == "float32" else 5e-2
    for n, a in grads[None].items():
        w = want[n].numpy()
        if n.endswith("attn.k.bias"):  # true gradient 0: rounding noise on both sides
            small = rel * np.abs(want[n.replace("bias", "weight")].numpy()).max()
            assert np.abs(a.numpy()).max() <= small and np.abs(w).max() <= small, n
            continue
        scale = np.abs(w).max()
        tol = rel * max(scale, 1.0) if dtype == "float32" else rel * scale
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=tol, err_msg=n)


def test_dropout_draws_agree_across_remat(ssl_tree):
    """With nonzero rates each block reseeds from its layer's seed, so a
    recomputed block draws the masks of its first run."""
    kw = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1)
    with _one_thread():
        ref = _xlsr_grads(ssl_tree, "float32", False, train=True, seed=5, **kw)[0]
        for policy in PX.REMAT_POLICIES:
            got = _xlsr_grads(ssl_tree, "float32", True, policy, train=True, seed=5, **kw)[0]
            assert all(torch.equal(ref[n], got[n]) for n in ref), policy
    other = _xlsr_grads(ssl_tree, "float32", False, train=True, seed=6, **kw)[0]
    assert not all(torch.equal(ref[n], other[n]) for n in ref)


@pytest.mark.parametrize("kw,err", [
    ({"mesh_shape": [2, 1]}, NotImplementedError),
    ({"zero1": True}, NotImplementedError),
    ({"remat_policy": "everything"}, ValueError),
    ({"mesh_shape": [1, 2]}, NotImplementedError),
])
def test_unported_training_options_raise(kw, err):
    """Every XLS-R training option is ported (the conv impls and fuse_qkv
    build); multi-device meshes and ZeRO-1 (Slice H) raise in ``Engine``."""
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(conv_impl="phase", fuse_qkv=True), emb_dim=16,
                      device="cpu")
    with pytest.raises(err):
        if "remat_policy" in kw:
            PX.XLSR(PX.XLSRConfig.tiny(**kw))
        else:
            PE.Engine(model, TrainConfig(**kw))
    PX.XLSR(PX.XLSRConfig.tiny(compute_dtype="bfloat16", grad_stack_dtype="bfloat16"))


def test_fast_backward_defaults_follow_jax():
    for dt in ("float32", "bfloat16"):
        for fb in (None, True, False):
            assert (PX.XLSRConfig.tiny(compute_dtype=dt, fast_bwd_matmuls=fb).use_fast_bwd
                    == JX.XLSRConfig.tiny(compute_dtype=dt, fast_bwd_matmuls=fb).use_fast_bwd)


def test_remat_tail_full_gives_the_same_gradients(ssl_tree):
    with _one_thread():
        a = _xlsr_grads(ssl_tree, "float32", True, "attn")[0]
        b = _xlsr_grads(ssl_tree, "float32", True, "attn", remat_tail_full=1)[0]
    assert all(torch.equal(a[n], b[n]) for n in a)


# ----------------------------------------------------------- LinearNLL/Engine

def _port_engine(tree, dropout=0.5, **cfg):
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, dropout=dropout, device="cpu")
    eng = PE.Engine(model, TrainConfig(**cfg))
    eng.init_state(params=tree)
    return eng


def _jax_head_masks(key, n, t):
    """The head-dropout masks the JAX step draws: the step key -> split ->
    fold_in(head_rng, i) -> bernoulli(0.5)."""
    _, head_rng = jax.random.split(key)
    return [torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(head_rng, i), 0.5, (n, t, 16)))) for i in range(3)]


def test_golden_train_step_pin_reproduced(golden_tree):
    """The pin of ``tests/test_golden_pipeline.py``: one step from the golden
    checkpoint, with JAX's own head-dropout draws handed to the port."""
    batch = _golden_batch()
    eng = _port_engine(golden_tree, max_lr=1e-4)
    t = eng.model.ssl.cfg.num_frames(batch["wav"].shape[-1])
    masks = _jax_head_masks(jax.random.fold_in(jax.random.key(7), 0), 8, t)
    m = {k: float(v) for k, v in eng.train_step(
        eng.place_batch(batch), eng.step_generator(0, 0), dropout_masks=masks).items()}
    assert m["loss"] == pytest.approx(0.7708058953, abs=2e-4)
    assert m["L_CE"] == pytest.approx(0.1741586030, abs=1e-4)
    assert m["L_CF1"] == pytest.approx(0.3219523132, abs=1e-4)
    assert m["L_CF2"] == pytest.approx(0.2746949792, abs=1e-4)
    assert m["accuracy"] == pytest.approx(0.5, abs=1e-6)


def test_three_train_steps_match_the_jax_engine(golden_tree):
    """Head dropout 0, lr 1e-4: per-step metrics and the parameters after
    three steps of the port's Engine against the JAX Engine."""
    batches = [_golden_batch(4000) for _ in range(3)]
    for i, b in enumerate(batches):
        b["wav"] = b["wav"] * (1.0 + 0.5 * i)
    jm = JLinearNLL(ssl=JX.XLSRConfig.tiny(), emb_dim=16, dropout=0.0)
    jeng = JE.Engine(jm, JTrainConfig())
    params, buffers, opt = jeng.init_state(jax.random.key(0), params=golden_tree)
    opt = jset_lr(opt, 1e-4)
    eng = _port_engine(golden_tree, dropout=0.0)
    set_learning_rate(eng.optimizer, 1e-4)
    for i, b in enumerate(batches):
        params, buffers, opt, want = jeng.train_step(params, buffers, opt,
                                                     jeng.place_batch(b), jax.random.key(i))
        got = eng.train_step(eng.place_batch(b), eng.step_generator(0, i))
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i} {k}")
    want = from_jax(jax.tree.map(np.asarray, params), eng.model)
    start = from_jax(golden_tree, eng.model)
    for n, p in eng.model.named_parameters():
        if n.endswith("attn.k.bias"):  # noise gradient: each side moves at most 3 steps
            for x in (p.detach(), want[n]):
                assert (x - start[n]).abs().max() <= 3.0001e-4, n
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("scope", ["group", "global"])
def test_eval_metrics_match_jax_in_both_loss_scopes(golden_tree, scope):
    batch = _golden_batch(4000)
    jm = JLinearNLL(ssl=JX.XLSRConfig.tiny(), emb_dim=16)
    _, (want, _, _) = JE._loss_and_metrics(
        jax.tree.map(jnp.asarray, golden_tree), {}, jm,
        {k: jnp.asarray(v) for k, v in batch.items()}, None, False, scope)
    eng = _port_engine(golden_tree, loss_scope=scope)
    got = eng.eval_step(eng.place_batch(batch))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    m, s, l = eng.eval_step_scored(eng.place_batch(batch))
    assert s.shape == (8,) and torch.equal(l, torch.from_numpy(batch["labels"]).reshape(-1))


def test_flag_fix_ssl_trains_only_the_head(golden_tree):
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, flag_fix_ssl=True, device="cpu")
    eng = PE.Engine(model, TrainConfig(weight_decay=0.0))
    eng.init_state(params=golden_tree)
    set_learning_rate(eng.optimizer, 1e-3)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    eng.train_step(eng.place_batch(_golden_batch(4000)), eng.step_generator(0, 0))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == n.startswith("ssl."), n


def test_engine_refuses_unported_settings(tmp_path):
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=4, device="cpu")
    for kw, err in (({"mesh_shape": [2, 1]}, NotImplementedError),
                    ({"zero1": True}, NotImplementedError),
                    ({"loss_scope": "batch"}, ValueError)):
        with pytest.raises(err):
            PE.Engine(model, TrainConfig(**kw))
    PE.Engine(model, TrainConfig(mesh_shape=[1, 1]))
    # tensorboard scalars and the first epoch's profiler trace are ported
    eng = PE.Engine(model, TrainConfig(num_epochs=1))
    eng.fit(list, list, tensorboard_dir=str(tmp_path / "tb"),
            profile_dir=str(tmp_path / "prof"))
    assert [n for n in os.listdir(tmp_path / "prof") if n.startswith("trace_")]


def test_step_generators_are_reproducible():
    eng = PE.Engine(LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=4, device="cpu"),
                    TrainConfig(seed=7))
    a, b, c = (torch.rand(4, generator=g) for g in (eng.step_generator(1, 2),
                                                    eng.step_generator(1, 2),
                                                    eng.step_generator(2, 1)))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_metric_mean_reads_back_once():
    agg = PE.MetricMean()
    agg.add({"a": torch.tensor(1.0), "b": torch.tensor(4.0)})
    agg.add({"a": torch.tensor(3.0), "b": torch.tensor(2.0)})
    assert agg.result() == {"a": 2.0, "b": 3.0}
    assert PE.MetricMean().result() == {}


def test_dev_eer_pct():
    assert PE._dev_eer_pct(np.array([0.9, 0.8, 0.1, 0.2]), np.array([1, 1, 0, 0])) == 0.0
    assert np.isnan(PE._dev_eer_pct(np.array([0.9, 0.8]), np.array([1, 1])))


# ------------------------------------------------------- fit and checkpoints

def test_fit_early_stops_checkpoints_and_resumes(golden_tree, tmp_path):
    batch = _golden_batch(4000)
    cfg = dict(num_epochs=5, max_lr=1e-4, early_metric="eer", es_patience=2, es_delta=0.01)
    eng = _port_engine(golden_tree, **cfg)
    logged = []
    records = eng.fit(lambda: [batch], lambda: [batch], save_dir=str(tmp_path),
                      log_fn=lambda e, r: logged.append(e))
    # epoch 0 sets the EER watermark; two epochs without a gain stop the run
    assert [r["epoch"] for r in records] == logged == [0, 1, 2]
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [x["epoch"] for x in lines] == [0, 1, 2]
    for x in lines:
        assert {"lr", "seconds", "train_loss", "val_accuracy", "val_eer"} <= set(x)
        assert np.isfinite(x["train_loss"])
    assert lines[0]["lr"] == pytest.approx(1e-8) and lines[1]["lr"] > lines[0]["lr"]
    assert sorted(os.listdir(tmp_path)) == ["epoch_0.ckpt", "epoch_0.ckpt.json", "last.ckpt",
                                            "last.ckpt.json", "metrics.jsonl"]

    # the train state restores the model, the optimizer and the stop rule
    other = _port_engine(golden_tree, **cfg)
    epoch, best, extra = pckpt.load_train_state(str(tmp_path / "last.ckpt"), other.model,
                                                other.optimizer)
    assert (epoch, best) == (2, lines[0]["val_eer"])
    assert extra["es_counter"] == 2 and extra["es_metric"] == "eer"
    for (n, a), b in zip(eng.model.named_parameters(), other.model.parameters()):
        assert torch.equal(a, b), n
    sa, sb = eng.optimizer.state_arrays(), other.optimizer.state_arrays()
    assert sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    # resumed with its patience already spent, the run trains nothing more
    other.cfg.start_epoch = epoch + 1
    assert other.fit(lambda: [batch], lambda: [batch], resume_best=best,
                     resume_counter=extra["es_counter"]) == []

    # the JAX package reads the port-trained model and scores as the port does
    tree, jextra = jckpt.load(str(tmp_path / "last.ckpt"))
    assert jextra["epoch"] == 2
    wav = batch["wav"].reshape(8, -1)
    jout = JLinearNLL(ssl=JX.XLSRConfig.tiny(), emb_dim=16).apply(
        jax.tree.map(jnp.asarray, tree["params"]), jnp.asarray(wav))
    got = eng.score_step(wav)
    np.testing.assert_allclose(got.numpy(), np.asarray(jout.log_probs), rtol=0, atol=1e-5)


def test_fit_on_accuracy_without_a_gain_stops_after_patience(golden_tree, tmp_path):
    batch = _golden_batch(4000)
    eng = _port_engine(golden_tree, num_epochs=4, es_patience=1, ckpt_every=3)
    records = eng.fit(lambda: [batch], lambda: [batch], save_dir=str(tmp_path))
    # accuracy 50 % never beats the initial 90 %: one strike stops the run,
    # and the stop epoch writes last.ckpt off the ckpt_every cadence
    assert len(records) == 1 and records[0]["val_accuracy"] == 0.5
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".ckpt")) == ["last.ckpt"]


def test_to_jax_inverts_from_jax(golden_tree):
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, device="cpu")
    back = to_jax(load_jax_params(model, golden_tree))
    flat_a, flat_b = flatten(golden_tree), flatten(back)
    assert sorted(flat_a) == sorted(flat_b)
    for k in flat_a:
        assert flat_b[k].dtype == np.float32 and np.array_equal(flat_a[k], flat_b[k]), k
    sd = from_jax(back, model)
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())


def test_checkpoint_save_load_round_trip(tmp_path):
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "l": [np.ones(2, np.float32), torch.zeros(3, dtype=torch.bfloat16)]}
    path = str(tmp_path / "x.ckpt")
    pckpt.save(path, tree, extra={"epoch": 3})
    back, extra = pckpt.load(path)
    assert extra == {"epoch": 3}
    assert np.array_equal(back["a"]["w"], tree["a"]["w"]) and back["l"][1].dtype == np.float32
    jback, jextra = jckpt.load(path)  # the JAX package reads it too
    assert jextra == {"epoch": 3} and np.array_equal(jback["l"][0], tree["l"][0])
    writer = pckpt.AsyncWriter()
    writer.submit(str(tmp_path / "y.ckpt"), {"k": np.ones(1)}, {"e": 1})
    writer.wait()
    assert pckpt.load(str(tmp_path / "y.ckpt"))[1] == {"e": 1}
    writer.submit(str(tmp_path / "missing" / "\0bad"), {"k": np.ones(1)}, None)
    with pytest.raises(Exception):
        writer.wait()
