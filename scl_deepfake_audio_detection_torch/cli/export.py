"""Artifact and parity modes: ``--export_model`` (the scoring artifact of
``export.py``), ``--verify_export``, ``--export_reference_ckpt`` (a
reference-loadable ``.pth``) and ``--parity_check``.

Counterpart of ``scl_deepfake_audio_detection_tpu/cli/export.py``, with
its messages and exit codes.
"""

from __future__ import annotations

import sys

import numpy as np

from scl_deepfake_audio_detection_torch.cli.common import parse_calibration
from scl_deepfake_audio_detection_torch.cli.context import RunContext


def run_export_reference_ckpt(args, ctx: RunContext) -> int:
    """Write the loaded model as a reference ``epoch_N.pth`` and exit;
    dispatched before ``context.init_state``."""
    from scl_deepfake_audio_detection_torch.models import convert
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.params import to_jax

    if not isinstance(ctx.model, LinearNLL):
        print("--export_reference_ckpt maps onto the reference wav2vec2_linear_nll "
              "state dict; use --config conf-N-linear", file=sys.stderr)
        return 2
    if not args.model_path:
        print("--export_reference_ckpt needs --model_path (exporting a random init is "
              "never what you want)", file=sys.stderr)
        return 2
    convert.save_reference_checkpoint(to_jax(ctx.model), args.export_reference_ckpt,
                                      extras=ctx.ref_extras)
    n = sum(p.numel() for p in ctx.model.parameters())
    print(f"wrote reference checkpoint {args.export_reference_ckpt} ({n / 1e6:.1f}M params"
          + (", extras round-tripped" if ctx.ref_extras else "") + ")")
    return 0


def run_parity_check(args, ctx: RunContext) -> int:
    from scl_deepfake_audio_detection_torch.train.parity import run_parity_check

    report = run_parity_check(
        ctx.model, args.parity_check, args.database_path,
        use_eval_subdir=ctx.desc["eval_subdir"], padding_type=args.padding_type,
        fmt=args.score_format, n=args.parity_n, tol=args.parity_tol,
        batch_size=max(args.batch_size, 1), num_workers=args.num_workers,
        compute_dtype=args.compute_dtype)
    print(report)
    return 0 if report.ok else 1


def run_verify_export(args, ctx: RunContext) -> int:
    """Score a seeded probe batch through the artifact and through the
    model; exit 0 iff they agree within ``--parity_tol``."""
    from scl_deepfake_audio_detection_torch.export import load_scorer
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.device import torch_dtype

    vscorer = load_scorer(args.verify_export, device=ctx.device)
    if vscorer.meta["model_tag"] != ctx.cfg.model.name:
        print(f"note: artifact model_tag {vscorer.meta['model_tag']!r} != config model "
              f"{ctx.cfg.model.name!r}", file=sys.stderr)
    rng = np.random.default_rng(args.seed)
    probe = (rng.standard_normal((4, vscorer.cut)) * 0.1).astype(np.float32)
    art = vscorer.score(probe)
    model = cast_matmul_params(ctx.model.eval(), torch_dtype(args.compute_dtype))
    ours = score_step(model, probe).float().cpu().numpy()
    if art.shape != ours.shape:
        print(f"verify_export: FAIL — score shape {art.shape} (artifact) != {ours.shape} "
              f"(model)", file=sys.stderr)
        return 1
    diff = float(np.max(np.abs(art - ours)))
    ok = diff <= args.parity_tol
    print(f"verify_export: max |artifact - model| = {diff:.3e} over {probe.shape[0]} "
          f"probe utts ({'OK' if ok else 'FAIL'}, tol {args.parity_tol:g})")
    return 0 if ok else 1


def run_export_model(args, ctx: RunContext) -> int:
    from scl_deepfake_audio_detection_torch.export import export_scorer

    meta = export_scorer(ctx.model, args.export_model, compute_dtype=args.compute_dtype,
                         padding_type=args.padding_type,
                         calibration=parse_calibration(args.calibrate),
                         model_tag=ctx.cfg.model.name, quantize=args.export_quant)
    qnote = (f", stored {meta['stored_bytes'] / 1e6:.1f} MB as {meta['quantization']}"
             if meta.get("quantization") else "")
    print(f"exported {meta['model_tag']} -> {args.export_model} "
          f"({meta['param_bytes'] / 1e6:.1f} MB weights{qnote}, platforms "
          f"{meta['platforms']}); run it with --from_export")
    return 0
