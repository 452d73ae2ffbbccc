"""One dp x tp train step over ``n`` ranks on the CPU: the multi-rank dry run.

Counterpart of ``__graft_entry__.dryrun_multichip``: ``dryrun_multichip(n)``
starts ``n`` gloo ranks on the CPU (``parallel/mesh.launch``), lays them out
as (n / 2 data x 2 model) when ``n`` is even (else n x 1), and runs at tiny
shapes

1. one train step of the tiny LinearNLL with remat and ZeRO-1 (a small
   ``zero1_min_size``, so that its leaves split);
2. one train step of the tiny ResNet head, whose batch norm takes its
   moments over the data ranks;
3. scoring with the batch split over 'data' and the encoder over 'model';

each rank printing one line a pass.  It raises ``RuntimeError`` when a
rank fails.

    python -c "from scl_deepfake_audio_detection_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import time

import numpy as np


def _rank(n: int) -> int:
    import torch

    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.resnet import XLSRResNet
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.parallel import mesh as M
    from scl_deepfake_audio_detection_torch.train.engine import Engine
    from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

    t0 = time.time()
    M.join_environment("cpu", n)
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    me = M.rank()

    def say(msg):
        print(f"rank {me}: {msg} [{time.time() - t0:.1f}s]", flush=True)

    rng = np.random.default_rng(0)
    groups, views, t = 2 * dp, 4, 3200
    batch = {"wav": rng.normal(size=(groups, views, t)).astype(np.float32),
             "labels": np.tile(np.array([1, 1, 0, 0], np.float32), (groups, 1))}

    model = LinearNLL(ssl=XLSRConfig.tiny(remat=True), emb_dim=16, device="cpu")
    engine = Engine(model, TrainConfig(mesh_shape=[dp, tp], zero1=True, zero1_min_size=256))
    engine.init_state()
    set_learning_rate(engine.optimizer, 1e-4)
    m = engine.train_step(engine.place_batch(batch), engine.step_generator(0, 0))
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"loss {loss}")
    say(f"dryrun_multichip ok: mesh=({dp} data x {tp} model), loss={loss:.4f} "
        f"acc={float(m['accuracy']):.3f}")

    bn = Engine(XLSRResNet(ssl=XLSRConfig.tiny(remat=True), device="cpu"),
                TrainConfig(mesh_shape=[dp, tp]))
    bn.init_state()
    set_learning_rate(bn.optimizer, 1e-4)
    m2 = bn.train_step(bn.place_batch(batch), bn.step_generator(0, 0))
    if not np.isfinite(float(m2["loss"])):
        raise FloatingPointError(f"bn-head loss {float(m2['loss'])}")
    say(f"dryrun_multichip bn-head ok: loss={float(m2['loss']):.4f}")

    lp = engine.score_step(rng.normal(size=(2 * dp, t)).astype(np.float32))
    if tuple(lp.shape) != (2 * dp, 2) or not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"scores {tuple(lp.shape)}")
    say(f"dryrun_multichip sharded scoring ok: {tuple(lp.shape)}")
    return 0


def dryrun_multichip(n: int) -> None:
    """Run the dry run over ``n`` CPU ranks; raises when a rank fails."""
    from scl_deepfake_audio_detection_torch.parallel.mesh import launch

    codes = launch(_rank, n, args=(n,), threads=1)
    if any(codes):
        raise RuntimeError(f"dryrun_multichip({n}): rank exit codes {codes}")
