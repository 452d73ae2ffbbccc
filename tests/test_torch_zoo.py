"""The port's AASIST and ResNet back-ends (``models/aasist``,
``models/resnet``) against the JAX package's, on the CPU at the tiny SSL
config: configs and registry, parameter and buffer trees, forwards in
train and eval with the new running statistics, every ResNet depth,
``self_attention_pool``, the loss terms and gradients under every
``loss_type`` (AASIST with the JAX package's own dropout draws), ``Engine``
steps in both loss scopes, remat, checkpoints and resumes in either
direction, checkpoint averaging, the export artifact's keys and the
committed goldens.

Parameters come from JAX ``init`` (or ``tests/seeded_params.seeded_tree``)
through ``models/params.load_jax_params``, inputs from a numpy seed.

Tolerances, with their reasons:
- forwards, loss terms, running statistics and one-step metrics: rtol 1e-5
  / atol 2e-5 in fp32 (the same operations, summed in another order);
- ``Engine`` steps: the JAX model takes the port's discrete choices
  (``tests/zoo_pins.py``: a ReLU input within a rounding error of 0 may
  fall on either side and move every gradient before it); AdamW's first
  moment, linear in the gradient, leaf by leaf as
  ``tests/test_torch_zoo_grads.py`` holds gradients; parameters rtol 1e-5
  / atol 1e-5 as ``tests/test_torch_train.py``, except leaves whose
  gradient is zero up to rounding (the same rule), which Adam moves by up
  to a step either way and which are held within one step (``lr``);
- goldens: rebuilt by the JAX package, equal to the committed files within
  1e-6; reproduced by the port within 1e-5 (1e-4 on the card, as
  ``tests/test_golden_pipeline.py``)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_deepfake_audio_detection_tpu.models import resnet as JRN
from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.aasist import XLSRAasist as JAasist
from scl_deepfake_audio_detection_tpu.models.base import model_buffers
from scl_deepfake_audio_detection_tpu.models.resnet import XLSRResNet as JResNet
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_tpu.train import engine as JE
from scl_deepfake_audio_detection_tpu.train.optim import set_learning_rate as jset_lr
from scl_deepfake_audio_detection_tpu.utils.config import TrainConfig as JTrainConfig
from scl_deepfake_audio_detection_tpu.utils.config import load_config as jload_config
from scl_deepfake_audio_detection_torch.models import resnet as PRN
from scl_deepfake_audio_detection_torch.models import xlsr as PX
from scl_deepfake_audio_detection_torch.models.aasist import XLSRAasist
from scl_deepfake_audio_detection_torch.models.base import model_buffers as pmodel_buffers
from scl_deepfake_audio_detection_torch.models.params import (
    buffers_to_jax,
    from_jax,
    load_jax_params,
    to_jax,
)
from scl_deepfake_audio_detection_torch.models.resnet import XLSRResNet
from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt
from scl_deepfake_audio_detection_torch.train import engine as PE
from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
from scl_deepfake_audio_detection_torch.utils.config import TrainConfig, load_config
from scl_deepfake_audio_detection_torch.utils.registry import MODELS

import zoo_pins
from seeded_params import seeded_tree

# see tests/test_torch_cli_eval.py: one throwaway multi-threaded exp per process
torch.exp(torch.zeros(1 << 20))
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
AASIST_YAML = os.path.join(REPO, "configs", "conf-aasist.yaml")
RTOL, ATOL = 1e-5, 2e-5
KINDS = {"aasist": (JAasist, XLSRAasist), "resnet": (JResNet, XLSRResNet)}
LR = 1e-4


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree(t):
    return jax.tree.map(np.asarray, t)


def _close(got, want, err_msg="", rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, _np(want), rtol=rtol, atol=atol, err_msg=err_msg)


def _trees_close(got, want, what, rtol=RTOL, atol=ATOL):
    flat_g, flat_w = jax.tree.leaves_with_path(got), jax.tree.leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w], what
    for (path, g), (_, w) in zip(flat_g, flat_w):
        _close(np.asarray(g), w, f"{what} {jax.tree_util.keystr(path)}", rtol, atol)


def _wav(n=4, t=3200, seed=0):
    return (0.1 * np.random.default_rng(seed).normal(size=(n, t))).astype(np.float32)


def _japply(jm, params, wav, train, key=None, buffers=None):
    """The JAX model's (ModelOutput, new buffers), jitted."""
    fn = jax.jit(lambda p, w, k, b: jm.apply(p, w, train=train, rng=k, buffers=b,
                                             mutable=True))
    return fn(jax.tree.map(jnp.asarray, params), jnp.asarray(wav), key,
              model_buffers(jm) if buffers is None else jax.tree.map(jnp.asarray, buffers))


@pytest.fixture(scope="module", params=sorted(KINDS))
def zoo(request):
    """(kind, JAX model, params, buffers moved by one train forward)."""
    jm = KINDS[request.param][0](ssl=JX.XLSRConfig.tiny())
    params = _tree(jax.jit(jm.init)(jax.random.key(0)))
    _, nb = _japply(jm, params, _wav(seed=9), True)
    return request.param, jm, params, _tree(nb)


def _port(kind, params, buffers, **ssl_kw):
    model = KINDS[kind][1](ssl=PX.XLSRConfig.tiny(**ssl_kw), device="cpu")
    return load_jax_params(model, params, buffers)


def _jax_masks(model, key, n, t):
    """The head-dropout masks the JAX model draws from ``key``: its split
    into 24 keys, the first for the SSL frontend, then one per site."""
    if not isinstance(model, XLSRAasist):
        return None
    keys = jax.random.split(key, 24)
    return [torch.from_numpy(np.array(jax.random.bernoulli(keys[1 + i], 1.0 - rate, shape)))
            for i, (rate, shape) in enumerate(model.dropout_sites(n, t))]


# ------------------------------------------------------------ configuration

def test_conf_aasist_builds_the_jax_head():
    """``ModelConfig.extra`` keeps the ``aasist:`` block, so conf-aasist's
    filts, gat_dims, pool_ratios and temperatures reach the head."""
    cfg, jcfg = load_config(AASIST_YAML), jload_config(AASIST_YAML)
    assert cfg.model.name == jcfg.model.name == "xlsr_aasist"
    assert cfg.model.extra == jcfg.model.extra and "aasist" in cfg.model.extra
    m = XLSRAasist.from_config(cfg.model, ssl=PX.XLSRConfig.tiny(), device="meta")
    jm = JAasist.from_config(jcfg.model, ssl=JX.XLSRConfig.tiny())
    for f in ("filts", "gat_dims", "pool_ratios", "temperatures", "num_classes",
              "flag_fix_ssl", "contra_mode", "loss_type"):
        assert getattr(m, f) == getattr(jm, f), f


def test_a_resnet_block_sets_the_backbone(tmp_path):
    p = tmp_path / "r.yaml"
    p.write_text("model:\n  name: wav2vec2_resnet_nll\n  flag_fix_ssl: true\n  loss_type: 3\n"
                 "  resnet: {resnet_type: '34', num_nodes: 4, enc_dim: 64, nclasses: 2}\n"
                 "data: {name: eval_only}\n")
    cfg, jcfg = load_config(str(p)), jload_config(str(p))
    assert cfg.model.extra == jcfg.model.extra
    m = XLSRResNet.from_config(cfg.model, ssl=PX.XLSRConfig.tiny(), device="meta")
    jm = JResNet.from_config(jcfg.model, ssl=JX.XLSRConfig.tiny())
    for f in ("resnet_type", "num_nodes", "enc_dim", "num_classes", "flag_fix_ssl",
              "loss_type"):
        assert getattr(m, f) == getattr(jm, f), f
    assert MODELS.get(cfg.model.name) is XLSRResNet


@pytest.mark.parametrize("name,cls", [
    ("xlsr_aasist", XLSRAasist), ("wav2vec2_aasist", XLSRAasist),
    ("xlsr_resnet", XLSRResNet), ("wav2vec2_resnet", XLSRResNet),
    ("wav2vec2_resnet_nll", XLSRResNet), ("xlsr_resnet_nll", XLSRResNet)])
def test_zoo_names_resolve(name, cls):
    assert MODELS.get(name) is cls


@pytest.mark.parametrize("name", ["xlsr_btse", "wav2vec2_btse"])
def test_btse_waits_for_slice_g2(name):
    with pytest.raises(NotImplementedError, match="not ported yet.*Slice G2"):
        MODELS.get(name)


# -------------------------------------------------------- trees and forward

def test_parameter_and_buffer_trees_match_jax(zoo):
    kind, jm, params, buffers = zoo
    model = _port(kind, params, buffers)
    got = to_jax(model)
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for (path, a), (_, b) in zip(jax.tree.leaves_with_path(got),
                                 jax.tree.leaves_with_path(params)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    gb = buffers_to_jax(model)
    assert jax.tree.structure(gb) == jax.tree.structure(model_buffers(jm))
    _trees_close(gb, buffers, "buffers", 0, 0)
    assert sorted(pmodel_buffers(model)) == sorted(n for n, _ in model.named_buffers())
    assert all(b.dtype == torch.float32 for b in model.buffers())


def test_from_jax_checks_the_buffers(zoo):
    kind, _, params, buffers = zoo
    model = KINDS[kind][1](ssl=PX.XLSRConfig.tiny(), device="cpu")
    sd = from_jax(params, model, buffers)
    assert len(sd) == len(model.state_dict())
    bad = jax.tree.map(lambda x: x, buffers)
    bad["first_bn"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="left over"):
        from_jax(params, model, bad)
    # a tree without buffers resets the statistics, as JAX's init_buffers
    model = load_jax_params(model, params, buffers)
    load_jax_params(model, params)
    assert float(model.first_bn.mean.abs().sum()) == 0.0
    assert float((model.first_bn.var - 1).abs().sum()) == 0.0


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(zoo, train):
    """ModelOutput in eval (running statistics) and in train (the batch's
    statistics, JAX's dropout draws); in train the new running statistics
    too."""
    kind, jm, params, buffers = zoo
    wav = _wav()
    key = jax.random.key(3) if train else None
    want, nb = _japply(jm, params, wav, train, key, buffers)
    model = _port(kind, params, buffers)
    masks = _jax_masks(model, key, *wav.shape) if train else None
    got = model.apply(torch.from_numpy(wav), train=train, dropout_masks=masks)
    for name in ("logits", "log_probs", "emb", "feats"):
        _close(getattr(got, name), getattr(want, name), name)
    assert torch.equal(model.eval_scores(got), got.logits)
    _trees_close(buffers_to_jax(model), _tree(nb), "new buffers")


def test_eval_reads_the_running_statistics(zoo):
    kind, jm, params, buffers = zoo
    model = _port(kind, params, buffers)
    wav = torch.from_numpy(_wav())
    before = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        a = model.apply(wav).logits
        model.apply(wav, train=True)  # moves them
        b = model.apply(wav).logits
    assert not torch.allclose(a, b)
    load_jax_params(model, params, buffers)
    assert all(torch.equal(before[n], b) for n, b in model.named_buffers())


@pytest.mark.parametrize("depth", sorted(JRN.RESNET_CONFIGS))
def test_resnet_depths_have_the_jax_trees(depth):
    assert PRN.RESNET_CONFIGS[depth] == JRN.RESNET_CONFIGS[depth]
    jp = jax.eval_shape(lambda k: JRN.init_resnet(k, depth)[0], jax.random.key(0))
    with torch.device("meta"):
        net = PRN.ResNet(depth)
    got = to_jax(net, host=False)
    assert jax.tree.structure(got) == jax.tree.structure(jp)
    assert [tuple(a.shape) for a in jax.tree.leaves(got)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]
    jb = JRN.resnet_buffers(depth)
    assert jax.tree.structure(buffers_to_jax(net, host=False)) == jax.tree.structure(jb)


@pytest.mark.parametrize("depth", ["18", "34", "50"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_backbone_matches_jax(rng, depth, train):
    params, buffers = JRN.init_resnet(jax.random.key(1), depth, num_nodes=3, enc_dim=32)
    params, buffers = _tree(params), _tree(buffers)
    x = rng.normal(size=(4, 66, 32, 1)).astype(np.float32)
    fwd = jax.jit(JRN.resnet_forward, static_argnums=(3, 4, 5, 6))
    logits, emb, nb = fwd(params, buffers, jnp.asarray(x), depth, 3, train, jnp.float32)
    net = load_jax_params(PRN.ResNet(depth, 3, 32), params, buffers)
    got_l, got_e = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), train, torch.float32)
    # up to 52 batch-stat norms in a row (depth 50), each dividing by the
    # variance of as few as 16 values a channel: atol 1e-4
    _close(got_l, logits, "logits", atol=1e-4)
    _close(got_e, emb, "emb", atol=1e-4)
    _trees_close(buffers_to_jax(net), _tree(nb), "new buffers")


@pytest.mark.parametrize("mode", ["mean", "stats", "noise"])
def test_self_attention_pool_matches_jax(rng, mode):
    x = rng.normal(size=(3, 7, 5)).astype(np.float32)
    p = _tree(JRN.init_self_attention(jax.random.key(2), 5))
    key = jax.random.key(4) if mode == "noise" else None
    want = JRN.self_attention_pool(p, jnp.asarray(x), mean_only=mode == "mean",
                                   noise_rng=key)
    noise = (torch.from_numpy(np.array(jax.random.normal(key, x.shape)))
             if mode == "noise" else None)
    got = PRN.self_attention_pool(torch.from_numpy(p["w"]), torch.from_numpy(x),
                                  mean_only=mode == "mean", noise=noise)
    _close(got, want)


# ------------------------------------------------------------------ Engine

def _batch(seed=0, t=3200):
    rng = np.random.default_rng(seed)
    wav = (0.2 * rng.normal(size=(2, 4, t))).astype(np.float32)
    return {"wav": wav, "labels": np.tile([1.0, 1.0, 0.0, 0.0], (2, 1)).astype(np.float32)}


def _copy(t):
    return jax.tree.map(np.array, t)


def _adam_mu(opt_state):
    """optax's first moment, from the adamw state inside the chain."""
    found = [s.mu for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
             if hasattr(s, "mu")]
    assert len(found) == 1, len(found)
    return found[0]


def _jax_step(jm, state, batch, key, choices):
    """One JAX Engine step from ``state`` (params, buffers, optax state),
    the model pinned to ``choices``: a new Engine, so its jitted step is
    traced with these pins."""
    jeng = JE.Engine(jm, JTrainConfig())
    p, b, o = (jax.tree.map(jnp.asarray, t) for t in state)
    with zoo_pins.pin_jax(choices):
        p, b, o, m = jeng.train_step(p, b, o, jeng.place_batch(batch), key)
    return {"metrics": {k: float(v) for k, v in m.items()}, "buffers": _copy(b),
            "params": _copy(p), "mu": _copy(_adam_mu(o)), "state": (_copy(p), _copy(b), _copy(o))}


@pytest.fixture(scope="module")
def jrun(zoo, tmp_path_factory):
    """The port's first step from the zoo state (group scope, LR) and the
    JAX Engine's, pinned to the port's choices in it
    (``tests/zoo_pins.py``), with the JAX train state after it as a
    ``last.ckpt``; and a JAX Engine for the other steps."""
    kind, jm, params, buffers = zoo
    jeng = JE.Engine(jm, JTrainConfig())
    p, b, o = jeng.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, params),
                              buffers=jax.tree.map(jnp.asarray, buffers))
    eng = _port_engine(kind, params, buffers)
    with zoo_pins.record_port() as choices:
        got = _port_step(eng, _batch(0), jax.random.key(10))
    step = _jax_step(jm, (p, b, jset_lr(o, LR)), _batch(0), jax.random.key(10), choices)
    path = str(tmp_path_factory.mktemp(f"jrun_{kind}") / "last.ckpt")
    p, b, o = step["state"]
    jckpt.save_train_state(path, p, o, 0, jax.random.key(5), 70.0, buffers=b)
    return jeng, (eng, got), step, path


def _port_engine(kind, params=None, buffers=None, scope="group", **ssl_kw):
    eng = PE.Engine(KINDS[kind][1](ssl=PX.XLSRConfig.tiny(**ssl_kw), device="cpu"),
                    TrainConfig(loss_scope=scope))
    eng.init_state(params=params, buffers=buffers)
    set_learning_rate(eng.optimizer, LR)
    return eng


def _port_step(eng, batch, key):
    wav = batch["wav"]
    masks = _jax_masks(eng.model, key, wav.shape[0] * wav.shape[1], wav.shape[2])
    return eng.train_step(eng.place_batch(batch), eng.step_generator(0, 0), dropout_masks=masks)


def _metrics_close(got, want, what):
    """Metrics of one step; the SupCon terms (and the total) at rtol 1e-4:
    they divide the similarities by the temperature inside an exponential
    (``tests/test_torch_zoo_grads.py``)."""
    assert sorted(got) == sorted(want), what
    for k in want:
        rtol = RTOL if k in ("L_CE", "accuracy") else 1e-4
        _close(got[k], want[k], f"{what} {k}", rtol=rtol)


def _step_close(eng, got, want, what):
    """One step's metrics, running statistics (moved once, from all G*V
    views), AdamW's first moment (linear in the gradient: leaf by leaf as
    ``tests/test_torch_zoo_grads.py`` holds gradients) and parameters:
    AdamW moves an entry by about ``lr`` in the direction of its moment, so
    entries whose moment is within that moment check's tolerance of 0 may
    move either way and are held within two steps; every other entry rtol
    1e-5 / atol 1e-5, as ``tests/test_torch_train.py``."""
    _metrics_close(got, want["metrics"], what)
    _trees_close(buffers_to_jax(eng.model), want["buffers"], f"{what} buffers")
    opt = eng.optimizer
    mu = {n: opt.adamw.state[p]["exp_avg"] for n, p in zip(opt.names, opt.params)}
    want_mu = from_jax(want["mu"], eng.model)
    zoo_pins.assert_grads_close(mu, want_mu, f"{what} first moment")
    want_p = from_jax(want["params"], eng.model)
    tol = zoo_pins.grad_tolerance(want_mu)
    for n, p in eng.model.named_parameters():
        either_way = want_mu[n].double().abs() <= tol[n]
        diff = (p.detach() - want_p[n]).abs()
        if bool(either_way.any()):
            assert float(diff[either_way].max()) <= 2.0001 * LR, (what, n)
        firm = ~either_way
        np.testing.assert_allclose(p.detach()[firm].numpy(), want_p[n][firm].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=f"{what} {n}")


def test_train_step_matches_the_jax_engine(zoo, jrun):
    """One step from the same state: metrics, running statistics, first
    moment and parameters."""
    _, (eng, got), step, _ = jrun
    _step_close(eng, got, step, "step 0")


def test_port_resumes_the_jax_train_state(zoo, jrun):
    """The JAX train state after one step (buffers and optax's leaves) into
    the port, which then takes a second step beside the JAX Engine."""
    kind, jm = zoo[0], zoo[1]
    _, _, step, path = jrun
    eng = _port_engine(kind)
    epoch, best, _ = pckpt.load_train_state(path, eng.model, eng.optimizer)
    assert (epoch, best) == (0, 70.0)
    _trees_close(buffers_to_jax(eng.model), step["buffers"], "loaded buffers", 0, 0)
    _trees_close(to_jax(eng.model), step["params"], "loaded params", 0, 0)
    with zoo_pins.record_port() as choices:
        got = _port_step(eng, _batch(1), jax.random.key(11))
    want = _jax_step(jm, step["state"], _batch(1), jax.random.key(11), choices)
    _step_close(eng, got, want, "step 1")


def test_jax_resumes_the_port_train_state(zoo, jrun, tmp_path):
    """A port step, ``save_train_state`` (buffers included), the JAX
    package's ``load_train_state``; then one more step on each side from
    that one state."""
    kind, _, params, buffers = zoo
    jeng = jrun[0]
    eng = _port_engine(kind, params, buffers)
    _port_step(eng, _batch(0), jax.random.key(10))
    path = str(tmp_path / "last.ckpt")
    pckpt.save_train_state(path, eng.model, eng.optimizer, epoch=2, seed=1234, best=50.0)
    assert "buffers" in jckpt.load(path)[0]
    _, _, tmpl = jeng.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, params),
                                 buffers=jax.tree.map(jnp.asarray, buffers))
    p, b, o, epoch, _, best = jckpt.load_train_state(path, tmpl)
    assert (epoch, best) == (2, 50.0)
    _trees_close(b, buffers_to_jax(eng.model), "resumed buffers", 0, 0)
    _trees_close(p, to_jax(eng.model), "resumed params", 0, 0)
    p, b, o, want = jeng.train_step(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, b),
                                    o, jeng.place_batch(_batch(1)), jax.random.key(11))
    got = _port_step(eng, _batch(1), jax.random.key(11))
    _metrics_close(got, {k: float(v) for k, v in want.items()}, "after resume")
    _trees_close(buffers_to_jax(eng.model), _copy(b), "buffers after resume")


@pytest.mark.parametrize("scope", ["group", "global"])
def test_loss_scopes_match_jax(zoo, scope):
    """A training forward's metrics and new running statistics in both loss
    scopes (SupCon per anchor group, or over the whole batch)."""
    kind, jm, params, buffers = zoo
    batch, key = _batch(2), jax.random.key(12)
    fn = jax.jit(JE._loss_and_metrics, static_argnums=(2, 5, 6))
    _, (want, nb, _) = fn(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, buffers),
                          jm, {k: jnp.asarray(v) for k, v in batch.items()}, key, True, scope)
    model = _port(kind, params, buffers)
    wav = batch["wav"]
    masks = _jax_masks(model, key, wav.shape[0] * wav.shape[1], wav.shape[2])
    _, got, _ = PE._loss_and_metrics(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                     True, scope, dropout_masks=masks)
    _metrics_close({k: v.detach() for k, v in got.items()},
                   {k: float(v) for k, v in want.items()}, scope)
    _trees_close(buffers_to_jax(model), _copy(nb), f"{scope} buffers")


def test_full_remat_moves_the_statistics_once(zoo):
    """The head runs outside the checkpointed XLS-R layers: under 'full'
    remat one step moves the running statistics exactly as without remat."""
    kind, _, params, buffers = zoo
    got = {}
    for remat in (False, True):
        eng = _port_engine(kind, params, buffers, remat=remat, remat_policy="full")
        _port_step(eng, _batch(), jax.random.key(10))
        got[remat] = buffers_to_jax(eng.model)
    _trees_close(got[True], got[False], "full remat vs none", 0, 0)
    assert any(not np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got[True]),
                                                        jax.tree.leaves(buffers)))


def test_eval_and_score_steps_leave_the_statistics(zoo, jrun):
    kind, jm, params, buffers = zoo
    jeng = jrun[0]
    eng = _port_engine(kind, params, buffers)
    batch = _batch(3)
    before = buffers_to_jax(eng.model)
    metrics = eng.eval_step(eng.place_batch(batch))
    _, s, _ = eng.eval_step_scored(eng.place_batch(batch))
    scores = eng.score_step(batch["wav"].reshape(8, -1))
    _trees_close(buffers_to_jax(eng.model), before, "buffers", 0, 0)
    jp, jb = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, buffers)
    _metrics_close(metrics, {k: float(v) for k, v in jeng.eval_step(
        jp, jb, jeng.place_batch(batch)).items()}, "eval")
    jscores = jeng.score_step(jp, jb, jnp.asarray(batch["wav"].reshape(8, -1)))
    _close(scores, jscores, "score_step: raw logits")
    _close(s, _np(jscores)[:, 1], "eval_step_scored")


# ------------------------------------------------------------- checkpoints

def test_average_checkpoints_treats_buffers_as_jax(zoo, tmp_path):
    kind, _, params, buffers = zoo
    paths = []
    for i in range(2):
        p = str(tmp_path / f"e{i}.ckpt")
        b = jax.tree.map(lambda x: x * (1.0 + i), buffers)
        jckpt.save(p, {"params": jax.tree.map(lambda x: x + i, params), "buffers": b})
        paths.append(p)
    got, _ = pckpt.average_checkpoints(paths, str(tmp_path / "p.ckpt"))
    want, _ = jckpt.average_checkpoints(paths, str(tmp_path / "j.ckpt"))
    assert sorted(got) == sorted(want) and any(k.startswith("buffers//") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tree, _ = pckpt.load(str(tmp_path / "p.ckpt"))
    model = load_jax_params(KINDS[kind][1](ssl=PX.XLSRConfig.tiny(), device="cpu"),
                            tree["params"], tree["buffers"])
    _trees_close(buffers_to_jax(model), jax.tree.map(lambda x: 1.5 * x, buffers), "averaged")


# ------------------------------------------------------------------ export

def test_export_weights_have_the_jax_keys(zoo, tmp_path):
    """``weights.npz`` of the port's artifact: the JAX artifact's keys,
    shapes, dtypes and leaves, the buffers (b*) included; int8 quantizes
    the leaves the JAX scheme picks and never a buffer, which stay bit-equal
    to the fp artifact's; the program scores as the model."""
    from scl_deepfake_audio_detection_tpu import export as jexport
    from scl_deepfake_audio_detection_torch.export import export_scorer, load_scorer

    kind, jm, params, buffers = zoo
    model = _port(kind, params, buffers)
    cut, jdir = 3200, str(tmp_path / "jax")
    jmeta = jexport.export_scorer(jm, jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, buffers), jdir, cut=cut,
                                  platforms=("cpu",), compute_dtype=None)
    wav = _wav(2, cut, seed=5)
    with torch.inference_mode():
        ref = model.apply(torch.from_numpy(wav)).logits.numpy()
    arrays = {}
    for quant in (None, "int8"):
        pdir = str(tmp_path / f"port_{quant}")
        pmeta = export_scorer(model, pdir, cut=cut, compute_dtype=None, quantize=quant)
        with np.load(os.path.join(pdir, "weights.npz")) as z:
            arrays[quant] = {k: z[k] for k in z.files}
        got = load_scorer(pdir, device="cpu").score(wav)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 if quant is None else 0.5)
    for k in ("num_param_leaves", "num_buffer_leaves", "leaf_dtypes", "num_score_columns"):
        assert pmeta[k] == jmeta[k], k
    with np.load(os.path.join(jdir, "weights.npz")) as jz:
        assert sorted(arrays[None]) == sorted(jz.files)
        for k in jz.files:
            np.testing.assert_array_equal(arrays[None][k], jz[k], err_msg=k)
        picked = {k for k in jz.files if k.startswith("p") and jexport._quantizable(jz[k])}
    assert picked and set(pmeta["quantized_leaf_scales"]) == picked
    assert sorted(arrays["int8"]) == sorted(list(arrays[None]) + [f"qs{k}" for k in picked])
    for k in arrays[None]:
        if k.startswith("b"):
            assert arrays["int8"][k].tobytes() == arrays[None][k].tobytes(), k


# ----------------------------------------------------------------- goldens

GOLDEN_KINDS = {"aasist": "xlsr_aasist", "resnet": "xlsr_resnet"}


def _golden_inputs(meta):
    rng = np.random.default_rng(meta["wav_seed"])
    n, t = meta["wav_shape"]
    batches = [(0.1 * rng.normal(size=(n, t))).astype(np.float32)
               for _ in range(meta["train_forwards"] + 1)]
    return batches[:-1], batches[-1]


def build_golden(kind):
    """(buffers, scores, meta) of a tiny golden, computed by the JAX package:
    the parameters of ``seeded_tree`` (tiny SSL, the head's defaults), the
    running statistics of two train-mode forwards, the eval scores."""
    meta = {"model": GOLDEN_KINDS[kind], "ssl_preset": "tiny", "param_seed": 7,
            "wav_seed": 20241018, "wav_shape": [4, 8000], "train_forwards": 2}
    shapes = KINDS[kind][1](ssl=PX.XLSRConfig.tiny(), device="meta")
    params = jax.tree.map(jnp.asarray, seeded_tree(shapes, meta["param_seed"]))
    jm = KINDS[kind][0](ssl=JX.XLSRConfig.tiny())
    buffers = model_buffers(jm)
    train, wav = _golden_inputs(meta)
    for w in train:
        _, buffers = _japply(jm, params, w, True, buffers=buffers)
    out, _ = _japply(jm, params, wav, False, buffers=buffers)
    return _tree(buffers), _np(jm.eval_scores(out)), meta


def write_golden(kind):
    buffers, scores, meta = build_golden(kind)
    jckpt.save(os.path.join(GOLDEN, f"mini_{kind}.ckpt"), {"buffers": buffers}, extra=meta)
    with open(os.path.join(GOLDEN, f"mini_{kind}_scores.txt"), "w") as f:
        f.writelines(f"g{i} {a!r} {b!r}\n" for i, (a, b) in enumerate(scores.tolist()))


def _read_golden(kind):
    tree, meta = pckpt.load(os.path.join(GOLDEN, f"mini_{kind}.ckpt"))
    with open(os.path.join(GOLDEN, f"mini_{kind}_scores.txt")) as f:
        scores = np.array([[float(v) for v in ln.split()[1:]] for ln in f], np.float32)
    return tree["buffers"], scores, meta


@pytest.mark.parametrize("kind", sorted(GOLDEN_KINDS))
def test_goldens_are_what_the_jax_package_writes(kind):
    want_b, want_s, want_meta = _read_golden(kind)
    buffers, scores, meta = build_golden(kind)
    assert meta == want_meta
    _trees_close(buffers, want_b, "golden buffers", 0, 1e-6)
    np.testing.assert_allclose(scores, want_s, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", sorted(GOLDEN_KINDS))
def test_port_reproduces_the_goldens(kind):
    buffers, want, meta = _read_golden(kind)
    model = MODELS.get(meta["model"])(ssl=PX.XLSRConfig.tiny(), device="cpu")
    load_jax_params(model, seeded_tree(model, meta["param_seed"]), buffers)
    _, wav = _golden_inputs(meta)
    with torch.inference_mode():
        got = PE.score_step(model, wav).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


if __name__ == "__main__":  # rewrite the goldens (deliberate numerics changes only)
    for k in sorted(GOLDEN_KINDS):
        write_golden(k)
        print(f"wrote {os.path.join(GOLDEN, f'mini_{k}.ckpt')}")
