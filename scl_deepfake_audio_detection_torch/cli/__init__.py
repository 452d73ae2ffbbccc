"""Command-line interface of the port.

``python -m scl_deepfake_audio_detection_torch.cli`` takes the JAX CLI's
flags (``cli/flags.py``) plus ``--device`` (default ``cuda``).  It averages
checkpoints (``--average_ckpts``), analyses score files (``--analyze``,
``--compare``, ``--fuse``, ``--fit_calibration``), prints the parameter
table (``--show_params``), fills the offline augmentation cache
(``--warm_cache``), writes a reference ``.pth`` (``--export_reference_ckpt``),
checks scores against a reference score file (``--parity_check``), exports
and verifies a scoring artifact (``--export_model``, ``--verify_export``),
serves scores (``--serve`` on stdin, ``--serve_http``), scores an eval list
(``--eval``, with ``--predict``, ``--emb``, ``--long_audio``,
``--resume_eval``, ``--decode_cache``; both also ``--from_export``) or
trains (no mode flag; ``--device_aug`` composes the views on the device;
``--distill_from`` trains the configured model as a student of a frozen
teacher),
in the fixed order of the JAX CLI's dispatch.  The modes that build no
model come first: they never touch the card.  Training under ``--mesh`` or
``--multihost`` runs one rank a card (``cli.context.start_ranks``); the
ranks are started here, or joined from torchrun's environment.

  ``cli.analyze``   checkpoint averaging and score analysis (no model, no device)
  ``cli.context``   the shared runtime: config, device, model or artifact, engine
  ``cli.train``     training, distillation, --show_params and --warm_cache
  ``cli.export``    artifacts, reference checkpoints and the parity check
  ``cli.serve``     the stdin and HTTP scoring services
  ``cli.evaluate``  eval-list scoring
"""

from __future__ import annotations

import sys

from scl_deepfake_audio_detection_torch.cli.common import CliError
from scl_deepfake_audio_detection_torch.cli.flags import build_parser

__all__ = ["build_parser", "main"]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args, unknown = build_parser().parse_known_args(argv)
    try:
        return _dispatch(args, unknown, argv)
    except CliError as e:
        if e.message:
            print(e.message, file=sys.stderr)
        return e.code


def _dispatch(args, unknown, argv) -> int:
    if unknown:
        raise CliError(2, f"unrecognized arguments: {' '.join(unknown)} (no flag "
                          "of the JAX CLI has that name, or it is not ported yet)")

    from scl_deepfake_audio_detection_torch.cli import analyze

    rc = analyze.dispatch(args)
    if rc is not None:
        return rc
    if (args.predict or args.emb) and not args.eval:
        # the reference takes --predict/--emb inside --eval; without this
        # guard they would fall through to a training run
        raise CliError(2, "--predict/--emb select an output format for "
                          "--eval scoring: pass --eval as well")

    if args.serve and args.serve_http is not None:
        raise CliError(2, "--serve and --serve_http are two front-ends to one "
                          "scorer; pick one")

    from scl_deepfake_audio_detection_torch.cli import context

    if args.show_params or args.warm_cache:
        return _run(args, context.build_runtime(args))
    from scl_deepfake_audio_detection_torch.parallel import mesh

    grouped = mesh.is_distributed()
    rc = context.start_ranks(args, argv)
    if rc is not None:  # the ranks ran in processes of their own
        return rc
    try:
        return _run(args, context.build_runtime(args))
    finally:  # leave a group this run formed or joined
        if not grouped and mesh.is_distributed():
            mesh.leave()


def _run(args, ctx) -> int:
    """The model-bearing modes, in the JAX CLI's order."""
    from scl_deepfake_audio_detection_torch.cli import context
    from scl_deepfake_audio_detection_torch.cli import train as train_mode

    serving = args.serve or args.serve_http is not None
    if args.show_params:
        return train_mode.run_show_params(args, ctx)
    if args.warm_cache:
        return train_mode.run_warm_cache(args, ctx)
    context.load_model_state(ctx)
    from scl_deepfake_audio_detection_torch.cli import export as export_mode

    # reverse migration writes the loaded parameters before any optimizer
    if args.export_reference_ckpt:
        return export_mode.run_export_reference_ckpt(args, ctx)
    context.init_state(ctx)
    if args.parity_check:
        return export_mode.run_parity_check(args, ctx)
    if args.verify_export:
        return export_mode.run_verify_export(args, ctx)
    if args.export_model:
        return export_mode.run_export_model(args, ctx)
    if serving:
        from scl_deepfake_audio_detection_torch.cli import serve

        return serve.run(args, ctx)
    if args.eval:
        from scl_deepfake_audio_detection_torch.cli import evaluate

        return evaluate.run(args, ctx)
    return train_mode.run(args, ctx)
