"""Rank functions of the port's parallel tests (``tests/test_torch_parallel*.py``).

``parallel/mesh.launch`` starts each in spawned processes, which import this
module by name: it imports the port and numpy, never JAX or the JAX
package.  Each rank writes what the test reads with ``torch.save`` under
``out_dir``; rank 0 writes the mesh's results (every rank holds the same
ones after the gathers), and every rank writes its own where they may
differ."""

import contextlib
import io
import os
import sys

import numpy as np
import torch

from scl_deepfake_audio_detection_torch.parallel import mesh as M

LR = 1e-4


def linear_batches(n=2, groups=4, views=4, t=4000, seed=0):
    rng = np.random.default_rng(seed)
    return [{"wav": (0.2 * (1.0 + 0.5 * i) * rng.normal(size=(groups, views, t))).astype(np.float32),
             "labels": np.tile(np.array([1, 1, 0, 0], np.float32), (groups, 1))}
            for i in range(n)]


def _linear_engine(tree, shape, **cfg):
    from scl_deepfake_audio_detection_torch.models import xlsr as PX
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.train.engine import Engine
    from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

    model = LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, dropout=0.0, device="cpu")
    eng = Engine(model, TrainConfig(mesh_shape=list(shape), **cfg))
    eng.init_state(params=tree)
    set_learning_rate(eng.optimizer, LR)
    return eng


def _steps(eng, batches):
    from scl_deepfake_audio_detection_torch.models.params import to_jax
    from scl_deepfake_audio_detection_torch.utils.tree import flatten

    metrics = []
    for i, b in enumerate(batches):
        m = eng.train_step(eng.place_batch(b), eng.step_generator(0, i))
        metrics.append({k: float(v) for k, v in m.items()})
    opt = {k: v.detach().float().clone() for k, v in eng.optimizer.state_arrays().items()}
    return {"metrics": metrics, "params": flatten(to_jax(eng.model)), "opt": opt,
            "moment_shapes": {n: tuple(eng.optimizer.adamw.state[t]["exp_avg"].shape)
                              for n, t in zip(eng.optimizer.names, eng.optimizer.targets)
                              if t in eng.optimizer.adamw.state},
            "local_shapes": {n: tuple(p.shape) for n, p in eng.model.named_parameters()}}


def _grads_aasist(tree, buffers, wav, labels, masks):
    """One training forward of the narrow AASIST at (2, 1) on [G, V, T]
    groups, its batch norm synced over the data ranks: the loss terms, the
    data-mean gradients and the running statistics after it."""
    from scl_deepfake_audio_detection_torch.models import xlsr as PX
    from scl_deepfake_audio_detection_torch.models.aasist import XLSRAasist
    from scl_deepfake_audio_detection_torch.models.params import load_jax_params
    from scl_deepfake_audio_detection_torch.train.engine import (
        _loss_and_metrics,
        mesh_for,
        place_batch,
    )
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

    model = load_jax_params(XLSRAasist(ssl=PX.XLSRConfig.tiny(), device="cpu"), tree, buffers)
    par = M.MeshContext.from_mesh(mesh_for(TrainConfig(mesh_shape=[2, 1]), torch.device("cpu")))
    local, shard = par.shard_batch({"wav": wav, "labels": labels})
    params = [p for _, p in model.named_parameters()]
    with M.batch_shard(shard):
        total, metrics, _ = _loss_and_metrics(model, place_batch(local, "cpu"), True, "group",
                                              None, [torch.from_numpy(m) for m in masks])
        g = torch.autograd.grad(total, params, allow_unused=True)
    grads = par.mean_over_data([torch.zeros_like(p) if x is None else x
                                for p, x in zip(params, g)])
    return {"grads": {n: x for (n, _), x in zip(model.named_parameters(), grads)},
            "terms": par.mean_metrics({k: v.detach() for k, v in metrics.items()}),
            "buffers": {n: b.clone() for n, b in model.named_buffers()}}


def two_ranks(out_dir, tree, aasist):
    """(2, 1) and (1, 2) over one group of two ranks."""
    M.join_environment("cpu")
    res = {}
    batches = linear_batches()
    res["dp"] = _steps(_linear_engine(tree, (2, 1)), batches)
    res["dp_zero1"] = _steps(_linear_engine(tree, (2, 1), zero1=True, zero1_min_size=256),
                             batches)
    res["dp_global"] = _steps(_linear_engine(tree, (2, 1), loss_scope="global"), batches[:1])
    tp = _linear_engine(tree, (1, 2))
    res["tp_gathered"] = {n: t.clone() for n, t in M.gather_params(tp.model).items()}
    res["tp"] = _steps(tp, batches)
    res["tp_clip"] = _steps(_linear_engine(tree, (1, 2), grad_clip_norm=1e-3), batches)
    eng = _linear_engine(tree, (2, 1))
    wav = np.random.default_rng(3).normal(size=(8, 3200)).astype(np.float32)
    res["score"] = eng.score_step(wav).clone()
    res["score_ragged"] = eng.score_step(wav[:5]).clone()
    res["aasist"] = _grads_aasist(*aasist)
    res["gan"] = gan_run((2, 1))
    torch.save(res, os.path.join(out_dir, f"rank{M.rank()}.pt"))
    return 0


class MLP(torch.nn.ModuleList):
    """The JAX package's GAN test MLP (``tests/test_gan_al.py``) from the
    port's ``Linear``; its JAX tree is a list of {w, b}."""

    def __init__(self, sizes, out_squeeze=False):
        from scl_deepfake_audio_detection_torch.models.base import Linear

        super().__init__([Linear(i, o) for i, o in zip(sizes[:-1], sizes[1:])])
        self.out_squeeze = out_squeeze

    def apply(self, x, train=False, generator=None):
        for i, layer in enumerate(self):
            x = layer(x)
            if i < len(self) - 1:
                x = torch.relu(x)
        return x[..., 0] if self.out_squeeze else x


GAN_SIZES = ([3, 8, 2], [2, 8, 1])


def gan_batches(n=3, rows=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"z": rng.standard_normal((rows, GAN_SIZES[0][0])).astype(np.float32),
             "real": rng.standard_normal((rows, 2)).astype(np.float32) + 1.0}
            for _ in range(n)]


def gan_run(mesh_shape=None, device="cpu"):
    """Three non-saturating steps of seeded MLPs on ``gan_batches``; over a
    mesh of ``mesh_shape`` when given.  -> (initial trees, final trees,
    metrics)."""
    from scl_deepfake_audio_detection_torch.models.base import init_parameters
    from scl_deepfake_audio_detection_torch.models.params import to_jax
    from scl_deepfake_audio_detection_torch.train.gan import GANEngine

    gen, disc = MLP(GAN_SIZES[0]), MLP(GAN_SIZES[1], True)
    init_parameters(gen, torch.Generator().manual_seed(11))
    init_parameters(disc, torch.Generator().manual_seed(12))
    gen, disc = gen.to(device), disc.to(device)
    init = [to_jax(gen), to_jax(disc)]
    mesh = None if mesh_shape is None else M.make_mesh(mesh_shape, "cpu")
    eng = GANEngine(gen, disc, GAN_SIZES[0][0], lr_g=1e-2, lr_d=5e-3, mesh=mesh)
    metrics = eng.run_epoch(gan_batches(), 0)
    return init, [to_jax(gen), to_jax(disc)], metrics


def distill_run(mesh=None):
    """Two distillation steps of a tiny student (head dropout on) under a
    tiny teacher: the metrics and the student's parameters."""
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.params import to_jax
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.distill import DistillEngine
    from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
    from scl_deepfake_audio_detection_torch.utils.tree import flatten

    teacher = LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=16, device="cpu", seed=1)
    student = LinearNLL(ssl=XLSRConfig.tiny(encoder_dim=16, ffn_dim=32, num_heads=2),
                        emb_dim=16, device="cpu", seed=2)
    eng = DistillEngine(teacher, student, seed=3, mesh=mesh)
    eng.init_state()
    set_learning_rate(eng.optimizer, 1e-3)
    metrics = eng.run_epoch(linear_batches(), 0)
    return {"metrics": metrics, "params": flatten(to_jax(student))}


def four_ranks(out_dir, tree):
    """(2, 2): dp x tp, with and without ZeRO-1, and a ZeRO-1 train state."""
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt

    M.join_environment("cpu")
    batches = linear_batches()
    res = {"dptp": _steps(_linear_engine(tree, (2, 2)), batches)}
    eng = _linear_engine(tree, (2, 2), zero1=True, zero1_min_size=256)
    res["dptp_zero1"] = _steps(eng, batches)
    ckpt.save_train_state(os.path.join(out_dir, "zero1.ckpt"), eng.model, eng.optimizer, 0,
                          7, 91.0, write=eng.par.is_writer)
    res["distill"] = distill_run(eng.mesh)
    torch.save(res, os.path.join(out_dir, f"rank{M.rank()}.pt"))
    return 0


def cli_rank(argv, out_dir, head_dropout=None):
    """The port's CLI as one rank of the launched group; its stdout and
    stderr go to ``out_dir/rank<k>.out`` and ``.err``.  ``head_dropout``
    sets the LinearNLL head's rate (the two packages draw other masks)."""
    from scl_deepfake_audio_detection_torch.cli import main
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL

    if head_dropout is not None:
        build = LinearNLL.from_config.__func__

        def no_dropout(cls, model_cfg, ssl=None, **kw):
            return build(cls, model_cfg, ssl=ssl, dropout=head_dropout, **kw)

        LinearNLL.from_config = classmethod(no_dropout)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    r = M.rank() if M.is_distributed() else int(os.environ.get("RANK", "0"))
    with open(os.path.join(out_dir, f"rank{r}.out"), "w") as f:
        f.write(out.getvalue())
    with open(os.path.join(out_dir, f"rank{r}.err"), "w") as f:
        f.write(err.getvalue())
    return rc


def pipeline_ranks(out_dir, weights, x, microbatches):
    """``pipeline_apply`` of a stack of tanh layers over a 'pipe' group of
    every rank: the output and the gradients of sum(y * y)."""
    from scl_deepfake_audio_detection_torch.parallel.pipeline import pipeline_apply

    M.join_environment("cpu")
    stacked = {k: torch.tensor(v, requires_grad=True) for k, v in weights.items()}
    xt = torch.tensor(x, requires_grad=True)

    def layer(h, p):
        return torch.tanh(h @ p["w"] + p["b"])

    y = pipeline_apply(layer, stacked, xt, None, microbatches)
    (y * y).sum().backward()
    res = {"y": y.detach(), "dx": xt.grad, **{f"d{k}": v.grad for k, v in stacked.items()}}
    torch.save(res, os.path.join(out_dir, f"rank{M.rank()}.pt"))
    sys.stdout.flush()
    return 0


def _seeded_layer(device):
    """An XLS-R 300M encoder layer (1024 wide, 16 heads of 64) in bf16
    compute, its parameters N(0, 0.02) from a CPU generator of seed 0, and
    an input [2, 201, 1024]."""
    from scl_deepfake_audio_detection_torch.models.xlsr import EncoderLayer, XLSRConfig

    layer = EncoderLayer(XLSRConfig.xlsr_300m(compute_dtype="bfloat16"))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    x = torch.randn((2, 201, 1024), generator=g)
    return layer.to(device), x.to(device)


def tp_layer_rank(out_dir):
    """One of two ranks on one card: the layer split over 'model' (8 heads
    a rank), its output, the input's gradient of sum(y^2) and the kernels'
    launches."""
    from scl_deepfake_audio_detection_torch.ops import _kernels as K

    device = M.join_environment("cuda")
    layer, x = _seeded_layer(device)
    M.shard_params(layer, M.MeshContext.from_mesh(M.make_mesh((1, 2), "cuda")))
    x.requires_grad_(True)
    K.reset_launches()
    y = layer(x)
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    res = {"y": y.detach().float().cpu(), "dx": x.grad.float().cpu(),
           "launches": dict(K.LAUNCHES), "heads": layer.attn.q.weight.shape[0] // 64}
    torch.save(res, os.path.join(out_dir, f"rank{M.rank()}.pt"))
    return 0
