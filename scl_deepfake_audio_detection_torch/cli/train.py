"""Training CLI modes: SCL view-batch training with early stopping and
full-state checkpoints (the reference ``02_train.sh`` flow), distillation
(``--distill_from``), ``--show_params`` and ``--warm_cache``.

Counterpart of ``scl_deepfake_audio_detection_tpu/cli/train.py``.  With host
augmentation ``SCLViewBatchBuilder`` composes each anchor group in numpy on
``TrainLoader``'s worker threads; with ``--device_aug`` the workers only
decode and co-crop (``DeviceAugTrainLoader``) and
``data/device_pipeline.DeviceViewComposer`` composes the views on the
model's device.  ``Engine.fit`` trains there, or under ``--distill_from``
``train/distill.DistillEngine`` on the same batches.  It prints the JAX
CLI's lines: trial counts, the model tag, one line per epoch and the total
time.

Over ranks (``cli.context.start_ranks``): under ``--multihost`` each data
rank's loaders take its shard of the lists (``shard_index`` = data rank of
``num_shards`` = data ranks, the dev loader dropping a ragged last batch),
as the JAX CLI's processes do; under ``--mesh`` alone every rank reads the
global batch sequence of a one-process run and ``Engine`` takes its slice.
Every rank joins a checkpoint's gathers; rank 0 makes the run directory
and writes.
"""

from __future__ import annotations

import os
import sys
import time

from scl_deepfake_audio_detection_torch.cli.common import CliError, _build_model
from scl_deepfake_audio_detection_torch.cli.context import RunContext


def run_show_params(args, ctx: RunContext) -> int:
    """--show_params: the per-leaf parameter table of the configured model,
    built on the ``meta`` device (shapes only, no memory touched)."""
    from scl_deepfake_audio_detection_torch.models.params import to_jax
    from scl_deepfake_audio_detection_torch.ops.layers import param_table

    model = _build_model(args, ctx.cfg, "meta")
    print(param_table(to_jax(model, host=False)))
    return 0


def run_warm_cache(args, ctx: RunContext) -> int:
    """--warm_cache: fill the offline augmentation cache of the train and
    dev lists, then exit; no model, no device."""
    from scl_deepfake_audio_detection_torch.data import protocols
    from scl_deepfake_audio_detection_torch.data.cache_warmup import warm_aug_cache
    from scl_deepfake_audio_detection_torch.data.datasets import (
        SCLViewBatchBuilder,
        resources_from_config,
        spec_from_config,
    )

    cfg = ctx.cfg
    spec = spec_from_config(cfg.data.name, cfg.data.kwargs)
    if spec is None:
        print("config's dataset is eval-only; nothing to cache", file=sys.stderr)
        return 2
    res = resources_from_config(cfg.data.kwargs, cfg.rawboost)
    for subset in ("train", "dev"):
        _, files = protocols.gen_list_scl(args.database_path, subset)
        builder = SCLViewBatchBuilder(spec, args.database_path, files, res, seed=args.seed)
        stats = warm_aug_cache(builder, num_workers=args.num_workers, verbose=True)
        print(f"{subset}: {stats}")
    return 0


def run(args, ctx: RunContext) -> int:
    """Training over the SCL pipeline."""
    from scl_deepfake_audio_detection_torch.data import protocols
    from scl_deepfake_audio_detection_torch.data.datasets import (
        SCLViewBatchBuilder,
        resources_from_config,
        spec_from_config,
    )
    from scl_deepfake_audio_detection_torch.data.loader import (
        DeviceAugTrainLoader,
        TrainLoader,
    )
    from scl_deepfake_audio_detection_torch.train.tblog import tensorboard_available

    cfg, train_cfg, engine = ctx.cfg, ctx.train_cfg, ctx.engine
    spec = spec_from_config(cfg.data.name, cfg.data.kwargs)
    if spec is None:
        print("config's dataset is eval-only; pass --eval", file=sys.stderr)
        return 2
    # the flag overrides the dataset's repeat_pad, as the reference passes
    # padding_type into every Dataset_for (main.py:375)
    spec.repeat_pad = args.padding_type == "repeat"
    res = resources_from_config(cfg.data.kwargs, cfg.rawboost)

    _, file_train = protocols.gen_list_scl(args.database_path, "train")
    _, file_dev = protocols.gen_list_scl(args.database_path, "dev")
    print(f"no. of training trials {len(file_train)}")
    print(f"no. of validation trials {len(file_dev)}")

    groups = args.groups_per_step or max(args.batch_size, 1)
    train_builder = SCLViewBatchBuilder(spec, args.database_path, file_train, res,
                                        seed=args.seed)
    dev_builder = SCLViewBatchBuilder(spec, args.database_path, file_dev, res,
                                      seed=args.seed + 1)
    composer = _device_composer(args, cfg, spec, ctx.device) if args.device_aug else None
    if composer is None:
        loader_cls, kw = TrainLoader, {}
    else:
        loader_cls, kw = DeviceAugTrainLoader, {"wire_dtype": args.wire_dtype}
    # --multihost: this data rank's stream of the lists; else the whole
    shard = dict(shard_index=ctx.pidx, num_shards=ctx.pcnt) if args.multihost else {}
    train_loader = loader_cls(train_builder, groups, shuffle=True,
                              num_workers=args.num_workers, seed=args.seed, **shard, **kw)
    dev_loader = loader_cls(dev_builder, groups, shuffle=False,
                            drop_last=bool(shard) and ctx.pcnt > 1,
                            num_workers=args.num_workers, seed=args.seed, **shard, **kw)

    save_dir = os.path.join(args.out_dir, train_cfg.model_tag())
    if engine.par.is_writer:
        os.makedirs(save_dir, exist_ok=True)
    print(f"model tag: {train_cfg.model_tag()}")

    epoch_counter = {"n": train_cfg.start_epoch}

    def composed(raw_batches, epoch):
        for i, raw in enumerate(raw_batches):
            views, labels = composer(raw["anchors"], raw["reals"], raw["vocoded"],
                                     composer_seed(args.seed, epoch, i),
                                     spoofs=raw["spoofs"], variant=spec.variant)
            yield {"wav": views, "labels": labels, "utts": raw["utts"]}

    def train_batches():
        e = epoch_counter["n"]
        epoch_counter["n"] += 1
        return composed(train_loader.epoch(e), e) if composer else train_loader.epoch(e)

    def dev_batches():  # epoch -1: the same dev views every epoch and across resumes
        return composed(dev_loader.epoch(0), -1) if composer else dev_loader.epoch(0)

    if args.distill_from:
        return _run_distill(args, ctx, train_batches, save_dir)

    tb_dir = args.tensorboard_dir or os.path.join(save_dir, "logs")
    print(f"tensorboard scalars: {tb_dir}" if tensorboard_available() else
          "tensorboard scalars: not written (torch.utils.tensorboard does not import)")

    def log_fn(epoch, record):
        eer = record.get("val_eer")  # under --early_metric eer; None for one class
        eer_s = f"val_eer={eer:.2f}% " if isinstance(eer, float) else ""
        print(f"epoch {epoch}: lr={record['lr']:.3g} "
              f"train_loss={record.get('train_loss', float('nan')):.4f} "
              f"val_loss={record.get('val_loss', float('nan')):.4f} "
              f"val_acc={record.get('val_accuracy', float('nan')):.4f} "
              f"{eer_s}({record['seconds']:.1f}s)")

    t0 = time.time()
    engine.fit(train_batches, dev_batches, save_dir=save_dir,
               log_fn=log_fn, tensorboard_dir=tb_dir, profile_dir=args.profile_dir,
               resume_best=ctx.resume_best, resume_counter=ctx.resume_counter)
    print(f"Total training time: {time.time() - t0}s")
    return 0


def _run_distill(args, ctx: RunContext, train_batches, save_dir) -> int:
    """--distill_from: the configured model (the student) learns from a
    frozen ``wav2vec2_linear_nll`` teacher at ``--teacher_preset``, read from
    a checkpoint of either package (``.ckpt``, with its batch-norm buffers
    where it has them) or a reference ``epoch_N.pth``.  Each epoch sets the
    learning rate ``Engine.fit`` would set for it, runs, prints its metrics
    and writes ``student_last.ckpt``."""
    import numpy as np

    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.params import to_jax
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train import distill as D
    from scl_deepfake_audio_detection_torch.train.optim import cyclic_exp_lr, set_learning_rate

    train_cfg = ctx.train_cfg
    teacher_preset = getattr(XLSRConfig, args.teacher_preset)
    teacher = LinearNLL(ssl=teacher_preset(compute_dtype=args.compute_dtype), device=ctx.device)
    if args.distill_from.endswith(".pth"):
        from scl_deepfake_audio_detection_torch.models import convert

        sd = ckpt.load_reference_head_checkpoint(args.distill_from)
        t_params, _ = convert.from_reference_model_checkpoint(sd, like=teacher.ssl.cfg)
        t_buffers = {}
    else:
        tree, _ = ckpt.load(args.distill_from)
        t_params = tree["params"] if "params" in tree else tree
        t_buffers = tree.get("buffers") or {}
    dcfg = D.DistillConfig(temperature=args.distill_temp, alpha=args.distill_alpha,
                           emb_loss_weight=args.distill_emb_w,
                           weight_decay=args.weight_decay)
    try:
        deng = D.DistillEngine(teacher, ctx.model, dcfg, seed=args.seed,
                               mesh=ctx.engine.mesh, local_batches=ctx.engine.par.local_batches)
    except ValueError as e:  # a BN student needs the full Engine
        raise CliError(2, str(e))
    deng.init_state(t_params, teacher_buffers=t_buffers)
    t0 = time.time()
    for epoch in range(train_cfg.start_epoch, train_cfg.start_epoch + train_cfg.num_epochs):
        te = time.time()
        # the JAX CLI leaves the rate at 0 here, so its student never moves
        # (ROADMAP.md, faults); the port sets the rate Engine.fit sets
        set_learning_rate(deng.optimizer, cyclic_exp_lr(epoch, train_cfg.min_lr,
                                                        train_cfg.max_lr))
        metrics = deng.run_epoch(train_batches(), epoch)
        print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
              + f" ({time.time() - te:.1f}s)")
        if not all(np.isfinite(v) for v in metrics.values()):
            print("non-finite distillation metrics; stopping", file=sys.stderr)
            return 1
        params = to_jax(ctx.model)  # every rank: a tensor-parallel student gathers
        if deng.par.is_writer:
            ckpt.save(os.path.join(save_dir, "student_last.ckpt"), {"params": params},
                      extra={"epoch": epoch, **{k: float(v) for k, v in metrics.items()}})
    print(f"Total distillation time: {time.time() - t0}s; student at "
          f"{os.path.join(save_dir, 'student_last.ckpt')} — eval/serve/"
          f"export it with --model_path + --ssl_preset {args.ssl_preset}")
    return 0


def composer_seed(seed: int, epoch: int, step: int) -> int:
    """The composer's seed for step ``step`` of ``epoch`` (-1 for the dev
    pass), from the words of the JAX CLI's per-batch key: ``seed + 77``
    and ``(epoch + 1) * 1_000_003 + step``."""
    from scl_deepfake_audio_detection_torch.data.device_pipeline import mix_seed

    return mix_seed(seed + 77, (epoch + 1) * 1_000_003 + step)


def _device_composer(args, cfg, spec, device):
    """The banks and the composer of ``--device_aug``, after checking that
    the config asks for exactly the recipe it implements."""
    from scl_deepfake_audio_detection_torch.data.device_pipeline import (
        DeviceViewComposer,
        build_banks,
    )

    want = {"RawBoost12", "background_noise", "reverb"}  # the conf-3 recipe
    got = {m.replace("_wrapper", "") for m in spec.augmentation_methods}
    if got != want:
        # any other list would train another augmentation distribution
        # than the config asks for, silently
        raise CliError(2, f"--device_aug supports the conf-3 recipe {sorted(want)} "
                          f"only; this config requests {sorted(got)} — run without "
                          "--device_aug (host augmentation covers every method)")
    noise_bank, rir_bank = build_banks(cfg.data.kwargs.get("noise_path"),
                                       cfg.data.kwargs.get("rir_path"),
                                       sr=spec.wav_samp_rate)
    print(f"device augmentation: noise bank {noise_bank.shape}, rir bank {rir_bank.shape}")
    return DeviceViewComposer(cfg.rawboost, noise_bank, rir_bank, fs=spec.wav_samp_rate,
                              seed=args.seed, snr_mode=args.snr_mode, device=device)
