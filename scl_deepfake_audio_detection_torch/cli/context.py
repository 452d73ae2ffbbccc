"""The runtime state behind every model-bearing CLI mode.

Counterpart of ``scl_deepfake_audio_detection_tpu/cli/context.py``, with
torch objects.  Three phases, in the order the modes need them, so that
``--show_params`` never builds a model on a device and only the training
mode makes optimizer state:

1. ``build_runtime``: the config, with the RawBoost knobs from the flags.
2. ``load_model_state``: the device, the ``TrainConfig``, the model (seeded
   init, or the parameters of a JAX-format ``--model_path`` checkpoint) and
   its ``Engine``.
3. ``init_state``: the optimizer (training only) and the resume of a full
   train state that ``--model_path`` names (a ``last.ckpt`` of either
   package).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from scl_deepfake_audio_detection_torch.cli.common import CliError, _build_model
from scl_deepfake_audio_detection_torch.cli.flags import _rawboost_from_args


@dataclasses.dataclass
class RunContext:
    """Everything the per-mode modules share; the phases fill it in."""

    args: Any
    pidx: int = 0  # this process's index of pcnt in a multi-process eval
    pcnt: int = 1
    cfg: Any = None
    device: Any = None
    train_cfg: Any = None
    model: Any = None
    engine: Any = None
    desc: Optional[dict] = None  # dataset descriptor (registry)
    resume_path: Optional[str] = None  # checkpoint path iff a full train state
    resume_epoch: Optional[int] = None
    resume_extra: dict = dataclasses.field(default_factory=dict)
    resume_counter: Optional[int] = None
    resume_best: Optional[float] = None


def build_runtime(args) -> RunContext:
    from scl_deepfake_audio_detection_torch.utils.config import load_config

    if args.compute_dtype not in ("float32", "bfloat16"):
        raise CliError(2, f"--compute_dtype must be float32 or bfloat16, "
                          f"got {args.compute_dtype!r}")
    cfg = load_config(args.config)
    cfg.rawboost = _rawboost_from_args(args)
    return RunContext(args=args, cfg=cfg)


def load_model_state(ctx: RunContext) -> None:
    from scl_deepfake_audio_detection_torch.models.params import load_jax_params
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train.engine import Engine
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig
    from scl_deepfake_audio_detection_torch.utils.device import resolve_device

    args = ctx.args
    try:
        ctx.device = resolve_device(args.device)
    except RuntimeError as e:
        raise CliError(1, str(e))
    ctx.train_cfg = TrainConfig(
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        start_epoch=args.start_epoch,
        min_lr=args.min_lr,
        max_lr=args.max_lr,
        weight_decay=args.weight_decay,
        loss=args.loss,
        grad_clip_norm=args.grad_clip_norm,
        grad_accum_steps=args.grad_accum_steps,
        early_metric=args.early_metric,
        es_patience=args.es_patience,
        es_delta=args.es_delta,
        padding_type=args.padding_type,
        seed=args.seed,
        comment=args.comment,
        compute_dtype=args.compute_dtype,
        loss_scope=args.loss_scope,
        ckpt_every=args.ckpt_every,
        async_ckpt=not args.sync_ckpt,
    )
    if args.model_path and not args.model_path.endswith(".ckpt"):
        raise CliError(2, f"not ported yet: --model_path {args.model_path} "
                          "(the port reads JAX-format .ckpt files; reference "
                          ".pth checkpoints come with Slice E)")
    ctx.model = _build_model(args, ctx.cfg, ctx.device)
    ctx.engine = Engine(ctx.model, ctx.train_cfg)
    if args.model_path:
        tree, extra = ckpt.load(args.model_path)
        load_jax_params(ctx.model, tree["params"] if "params" in tree else tree)
        if isinstance(tree, dict) and "opt_state_leaves" in tree:
            ctx.resume_path = args.model_path  # a full train state of either package
            ctx.resume_epoch = int(extra.get("epoch", -1)) + 1
            ctx.resume_extra = extra
        print(f"loaded checkpoint {args.model_path} (extra={extra})")


def init_state(ctx: RunContext) -> None:
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.utils.registry import DATASETS

    args = ctx.args
    # the modes of later slices were refused before
    training = not (args.eval or args.serve or args.serve_http is not None)
    if training:
        ctx.engine.init_state()
    if ctx.resume_path is not None and training:
        _, ctx.resume_best, _ = ckpt.load_train_state(
            ctx.resume_path, ctx.model, ctx.engine.optimizer)
        ctx.resume_counter = int(ctx.resume_extra.get("es_counter", 0))
        saved_metric = str(ctx.resume_extra.get("es_metric", "acc"))
        if saved_metric != args.early_metric:
            # the watermark tracks another metric (acc up, eer down)
            print(f"resume: checkpoint early-stop metric {saved_metric!r} != "
                  f"--early_metric {args.early_metric!r}; starting the "
                  f"EarlyStop watermark fresh")
            ctx.resume_best = None
            ctx.resume_counter = 0
        if args.start_epoch == 0 and ctx.resume_epoch:
            ctx.train_cfg.start_epoch = ctx.resume_epoch
            best_str = "fresh" if ctx.resume_best is None else f"{ctx.resume_best:.4f}"
            print(f"resuming full train state at epoch {ctx.resume_epoch} "
                  f"(best so far {best_str})")
    try:
        ctx.desc = DATASETS.get(ctx.cfg.data.name)
    except KeyError as e:
        raise CliError(2, str(e).strip("'\""))
