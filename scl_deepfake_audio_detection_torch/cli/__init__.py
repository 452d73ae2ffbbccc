"""Command-line interface of the port.

``python -m scl_deepfake_audio_detection_torch.cli --eval ...`` scores an
eval list into a ``utt cm0 cm1`` file, with the JAX CLI's flag names and
defaults for what it handles, plus ``--device`` (default ``cuda``).  Every
other mode and flag of the JAX CLI exits 2 with "not ported yet".
"""

from __future__ import annotations

import argparse
import sys

from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig

__all__ = ["build_parser", "main"]


class CliError(Exception):
    """A usage failure: ``main`` prints ``message`` and exits with ``code``."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="scl_deepfake_audio_detection_torch.cli",
        description="SCL deepfake audio detection on PyTorch/CUDA (eval scoring)")
    p.add_argument("--eval", action="store_true", default=False)
    p.add_argument("--config", type=str, default="configs/conf-3-linear.yaml")
    p.add_argument("--database_path", type=str, default="/your/path/to/data/")
    p.add_argument("--eval_output", type=str, default=None)
    p.add_argument("--model_path", type=str, default=None,
                   help="JAX-format .ckpt (npz) to score with; random init "
                        "from --seed otherwise")
    p.add_argument("--ssl_preset", type=str, default="xlsr_300m",
                   choices=list(XLSRConfig.preset_names()))
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--padding_type", type=str, default="zero", choices=["zero", "repeat"])
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--wire_dtype", type=str, default="float32",
                   choices=["float32", "int16"],
                   help="host->device wire format for eval batches; int16 "
                        "halves the transfer and is lossless for PCM16 audio")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> int:
    args, unknown = build_parser().parse_known_args(argv)
    try:
        if unknown:
            raise CliError(2, f"not ported yet: {' '.join(unknown)} "
                              "(the port handles --eval scoring only)")
        if not args.eval:
            raise CliError(2, "not ported yet: only --eval scoring is ported")
        from scl_deepfake_audio_detection_torch.cli import evaluate

        return evaluate.run(args)
    except CliError as e:
        print(e.message, file=sys.stderr)
        return e.code
