"""Command-line interface of the port.

``python -m scl_deepfake_audio_detection_torch.cli`` takes the JAX CLI's
flags (``cli/flags.py``) plus ``--device`` (default ``cuda``).  It trains
(no mode flag), scores an eval list (``--eval``) or prints the parameter
table (``--show_params``), in the fixed order of the JAX CLI's dispatch.
Every mode and option of a later slice exits 2 with "not ported yet",
before a model is built or the card is touched.

  ``cli.context``   the shared runtime: config, device, model, engine
  ``cli.train``     training and --show_params
  ``cli.evaluate``  eval-list scoring (--eval)
"""

from __future__ import annotations

import sys

from scl_deepfake_audio_detection_torch.cli.common import CliError
from scl_deepfake_audio_detection_torch.cli.flags import build_parser, unported

__all__ = ["build_parser", "main"]


def main(argv=None) -> int:
    args, unknown = build_parser().parse_known_args(argv)
    try:
        return _dispatch(args, unknown)
    except CliError as e:
        if e.message:
            print(e.message, file=sys.stderr)
        return e.code


def _dispatch(args, unknown) -> int:
    if unknown:
        raise CliError(2, f"unrecognized arguments: {' '.join(unknown)} (no flag "
                          "of the JAX CLI has that name, or it is not ported yet)")
    later = unported(args)
    if later:
        raise CliError(2, "not ported yet: " + ", ".join(
            f"{flag} ({where})" for flag, where in later))

    from scl_deepfake_audio_detection_torch.cli import context
    from scl_deepfake_audio_detection_torch.cli import train as train_mode

    ctx = context.build_runtime(args)
    if args.show_params:
        return train_mode.run_show_params(args, ctx)
    context.load_model_state(ctx)
    context.init_state(ctx)
    if args.eval:
        from scl_deepfake_audio_detection_torch.cli import evaluate

        return evaluate.run(args, ctx)
    return train_mode.run(args, ctx)
