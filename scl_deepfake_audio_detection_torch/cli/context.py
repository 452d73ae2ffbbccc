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

Before them, ``start_ranks`` forms the process group of a training run
under ``--mesh`` or ``--multihost`` (JAX ``cli/context.py:50-92``): a
process of torchrun's environment joins its group (an environment that is
incomplete or malformed exits 2); ``--mesh D,M`` with no environment
starts D*M ranks here, one a card (fewer cards than ranks over NCCL exits
2), or forms a group of one in this process; ``--multihost`` with no
environment prints the JAX CLI's notice and runs as one process.  The
scoring modes form no group: ``--multihost`` gives them this process's
index and count (``pidx`` of ``pcnt``, its slice of the eval list), and
``--mesh`` one model replica on each of its data*model local cards.
"""

from __future__ import annotations

import dataclasses
import os
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
    pidx: int = 0  # this process's data index of pcnt (its loader shard, its eval slice)
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


def is_training(args) -> bool:
    """No mode flag: the training run (or distillation)."""
    return not (args.eval or args.serve or args.serve_http is not None or args.parity_check
                or args.export_model or args.verify_export or args.export_reference_ckpt)


def _device_type(args) -> str:
    from scl_deepfake_audio_detection_torch.utils.device import resolve_device

    try:
        return resolve_device(args.device).type
    except RuntimeError as e:
        raise CliError(1, str(e))


def _cluster(args):
    from scl_deepfake_audio_detection_torch.parallel import mesh as M

    try:
        return M.cluster_env()
    except ValueError as e:  # a cluster that was asked for must not run as one process
        raise CliError(2, f"{'--multihost' if args.multihost else '--mesh'}: {e}")


def start_ranks(args, argv) -> Optional[int]:
    """Form or join the process group of a multi-rank training run; returns
    the ranks' exit code when they ran in processes started here, else None
    (this process goes on, as a rank or alone)."""
    from scl_deepfake_audio_detection_torch.parallel import mesh as M

    try:
        shape = M.parse_mesh(args.mesh)
    except ValueError as e:
        raise CliError(2, f"--mesh: {e}")
    if not is_training(args) or (shape is None and not args.multihost):
        return None
    env = _cluster(args)
    device_type = _device_type(args)
    world = None if shape is None else shape[0] * shape[1]
    try:
        if env is not None:
            M.join_environment(device_type, world)
            return None
        if shape is None:  # --multihost alone: build_runtime says so
            return None
        M.check_cards(world, device_type)
    except ValueError as e:
        raise CliError(2, f"--mesh {args.mesh}: {e}")
    if world == 1:
        M.init_process_group(device_type)
        return None
    rc = next((c for c in M.launch(_rank_cli, world, args=(argv,)) if c), 0)
    return rc if rc >= 0 else 1  # a rank ended by a signal


def _rank_cli(argv) -> int:
    """One started rank: the CLI on the same flags; ranks above 0 print
    nothing to stdout (rank 0 prints the run's lines)."""
    if int(os.environ.get("RANK", "0")) > 0:
        sys.stdout = open(os.devnull, "w")
    from scl_deepfake_audio_detection_torch.cli import main

    return main(argv)


def build_runtime(args) -> RunContext:
    from scl_deepfake_audio_detection_torch.utils.config import load_config

    if args.compute_dtype not in ("float32", "bfloat16"):
        raise CliError(2, f"--compute_dtype must be float32 or bfloat16, "
                          f"got {args.compute_dtype!r}")
    cfg = load_config(args.config)
    cfg.rawboost = _rawboost_from_args(args)
    ctx = RunContext(args=args, cfg=cfg)
    env = _cluster(args) if args.multihost else None
    if args.multihost and env is None:
        print("--multihost: no cluster detected (no RANK/WORLD_SIZE in the "
              "environment); continuing as a single process", file=sys.stderr)
    elif env is not None and not is_training(args):  # a scoring process: its slice
        ctx.pidx, ctx.pcnt = env["rank"], env["world"]
    return ctx


def load_model_state(ctx: RunContext) -> None:
    from scl_deepfake_audio_detection_torch.models.params import load_jax_params
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train.engine import Engine
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig
    from scl_deepfake_audio_detection_torch.utils.device import resolve_device

    import torch

    from scl_deepfake_audio_detection_torch.parallel import mesh as M

    args = ctx.args
    try:
        ctx.device = resolve_device(args.device)
    except RuntimeError as e:
        raise CliError(1, str(e))
    training = is_training(args)
    if ctx.device.type == "cuda" and (M.is_distributed() or ctx.pcnt > 1):
        local = int(os.environ.get("LOCAL_RANK", "0"))
        ctx.device = M.rank_device("cuda", local)
        torch.cuda.set_device(ctx.device)
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
        mesh_shape=list(M.parse_mesh(args.mesh)) if args.mesh and training else None,
        zero1=args.zero1,
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
    try:
        ctx.engine = Engine(ctx.model, ctx.train_cfg,
                            local_batches=bool(args.multihost and training))
    except ValueError as e:  # a mesh that does not fit the ranks
        raise CliError(2, f"--mesh {args.mesh}: {e}")
    if training:
        ctx.pidx, ctx.pcnt = ctx.engine.par.data_rank, ctx.engine.par.dp
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
    training = is_training(args)
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
