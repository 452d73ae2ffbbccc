"""What the per-mode CLI modules share."""

from __future__ import annotations

from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
from scl_deepfake_audio_detection_torch.utils.registry import MODELS


class CliError(Exception):
    """A usage failure: ``main`` prints ``message`` to stderr and exits with
    ``code`` (2 for a usage error, as argparse)."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


def parse_calibration(spec):
    """The ``(a, b)`` of a ``--calibrate 'a,b'`` spec, None without one; a
    usage error (exit 2) on anything but exactly two floats."""
    if not spec:
        return None
    try:
        cal = tuple(float(x) for x in spec.split(","))
    except ValueError:
        raise CliError(2, f"--calibrate expects 'a,b' (two floats), got {spec!r}")
    if len(cal) != 2:
        raise CliError(2, f"--calibrate expects 'a,b' (two floats), got {spec!r}")
    return cal


def _build_model(args, cfg, device):
    """The configured model at ``--ssl_preset`` on ``device``, with remat
    (the 'attn' policy) and ``--bf16_grads`` as the JAX CLI builds it,
    parameters from ``--seed``."""
    try:
        cls = MODELS.get(cfg.model.name)
    except (KeyError, NotImplementedError) as e:
        raise CliError(2, str(e).strip("'\""))
    gsd = "bfloat16" if args.bf16_grads else None
    ssl = getattr(XLSRConfig, args.ssl_preset)(compute_dtype=args.compute_dtype, remat=True,
                                               grad_stack_dtype=gsd)
    return cls.from_config(cfg.model, ssl=ssl, device=device, seed=args.seed)
