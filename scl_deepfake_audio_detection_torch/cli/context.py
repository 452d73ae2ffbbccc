"""The runtime state behind every model-bearing CLI mode.

Counterpart of ``scl_deepfake_audio_detection_tpu/cli/context.py``, with
torch objects.  Three phases, in the order the modes need them, so that
``--show_params`` never builds a model on a device and only the training
mode makes optimizer state:

1. ``build_runtime``: the config, with the RawBoost knobs from the flags.
2. ``load_model_state``: the device, the ``TrainConfig``, and either an
   export artifact's scorer (``--from_export``) or the model (seeded init,
   ``--ssl_checkpoint``'s SSL weights over it, or the parameters of
   ``--model_path``: a checkpoint of either package or a reference
   ``epoch_N.pth``) and its ``Engine``.
3. ``init_state``: the optimizer (training only; distillation makes its
   own) and the resume of a full train state that ``--model_path`` names
   (a ``last.ckpt`` of either package; under ``--distill_from`` it seeds
   only the student's parameters).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Optional

from scl_deepfake_audio_detection_torch.cli.common import (
    CliError,
    _build_model,
    _load_ssl_checkpoint,
)
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
    scorer: Any = None  # --from_export's artifact (in place of model and engine)
    model: Any = None
    engine: Any = None
    desc: Optional[dict] = None  # dataset descriptor (registry)
    ref_extras: Any = None  # a reference .pth's unmapped tensors, for the way back
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
    if args.from_export:
        _check_from_export(args)
        from scl_deepfake_audio_detection_torch.export import load_scorer

        ctx.scorer = load_scorer(args.from_export, device=ctx.device)
        meta = ctx.scorer.meta
        print(f"loaded export {args.from_export}: {meta['model_tag']}, cut "
              f"{ctx.scorer.cut}, platforms {meta['platforms']}, "
              f"{meta['param_bytes'] / 1e6:.1f} MB weights",
              file=sys.stderr)  # stderr: --serve replies own stdout
        return
    ctx.model = _build_model(args, ctx.cfg, ctx.device)
    ctx.engine = Engine(ctx.model, ctx.train_cfg)
    if not args.model_path:
        if args.ssl_checkpoint:
            _load_ssl_checkpoint(args, ctx.model)
    elif args.model_path.endswith(".pth"):
        _load_reference_pth(ctx)
    else:
        tree, extra = ckpt.load(args.model_path)
        if "params" in tree:  # a params(+buffers) checkpoint or a train state
            load_jax_params(ctx.model, tree["params"], tree.get("buffers"))
        else:
            load_jax_params(ctx.model, tree)
        if isinstance(tree, dict) and "opt_state_leaves" in tree:
            ctx.resume_path = args.model_path  # a full train state of either package
            ctx.resume_epoch = int(extra.get("epoch", -1)) + 1
            ctx.resume_extra = extra
        print(f"loaded checkpoint {args.model_path} (extra={extra})")


def _check_from_export(args) -> None:
    """The mode combinations an artifact can serve, as the JAX CLI checks them."""
    if not (args.serve or args.serve_http is not None or args.eval):
        raise CliError(2, "--from_export works with --serve or --eval "
                          "(--eval --predict for the prediction writer)")
    if args.emb:
        raise CliError(2, "--emb needs the model (export artifacts carry the score "
                          "columns only); run --emb with --model_path instead")
    if args.model_path:
        raise CliError(2, "--from_export already contains the weights; drop --model_path")
    if args.export_model or args.parity_check or args.verify_export:
        raise CliError(2, "--export_model/--parity_check/--verify_export need the model "
                          "itself, not an artifact; run them with --model_path/--config")
    if args.export_reference_ckpt:
        raise CliError(2, "--export_reference_ckpt cannot reverse-migrate an export "
                          "artifact (it carries an exported program and flat weights, no "
                          "parameter tree); export from the original checkpoint with "
                          "--model_path instead")


def _load_reference_pth(ctx: RunContext) -> None:
    """``--model_path epoch_N.pth``: a reference ``wav2vec2_linear_nll``
    state dict (embedded fairseq SSL and head) into the model, its unmapped
    tensors kept for ``--export_reference_ckpt``."""
    from scl_deepfake_audio_detection_torch.models import convert
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.params import load_jax_params
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt

    args, model = ctx.args, ctx.model
    if not isinstance(model, LinearNLL):
        raise CliError(2, "reference .pth loading is implemented for the "
                          "wav2vec2_linear_nll model (the one behind every published "
                          "checkpoint); use --config conf-N-linear")
    sd = ckpt.load_reference_head_checkpoint(args.model_path)
    params, ssl_cfg, ctx.ref_extras = convert.from_reference_model_checkpoint(
        sd, like=model.ssl.cfg, return_extras=True)
    if ssl_cfg.encoder_dim != model.ssl.cfg.encoder_dim:
        print(f"warning: checkpoint SSL dim {ssl_cfg.encoder_dim} != model config "
              f"{model.ssl.cfg.encoder_dim}", file=sys.stderr)
    load_jax_params(model, params)
    print(f"loaded reference checkpoint {args.model_path} "
          f"({ssl_cfg.encoder_layers}-layer SSL)")


def init_state(ctx: RunContext) -> None:
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.utils.registry import DATASETS

    args = ctx.args
    # forward-only modes make no optimizer state
    training = not (args.eval or args.serve or args.serve_http is not None
                    or args.parity_check or args.export_model or args.verify_export)
    # distillation makes its own optimizer (train/distill.DistillEngine), and
    # a full train state as --model_path only seeds the student's parameters
    # (load_model_state put them in the model)
    training_engine = training and not args.distill_from
    if training_engine and ctx.scorer is None:
        ctx.engine.init_state()
    if ctx.resume_path is not None and training_engine:
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
