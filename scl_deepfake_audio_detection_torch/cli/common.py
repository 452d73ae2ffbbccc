"""What the per-mode CLI modules share."""

from __future__ import annotations

import importlib.util
import os

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
    except KeyError as e:
        raise CliError(2, str(e).strip("'\""))
    gsd = "bfloat16" if args.bf16_grads else None
    ssl = getattr(XLSRConfig, args.ssl_preset)(compute_dtype=args.compute_dtype, remat=True,
                                               grad_stack_dtype=gsd)
    return cls.from_config(cfg.model, ssl=ssl, device=device, seed=args.seed)


def _load_ssl_checkpoint(args, model) -> None:
    """``--ssl_checkpoint``: the SSL frontend's weights from a fairseq
    ``.pt`` or a HuggingFace model directory, over the seeded init."""
    from scl_deepfake_audio_detection_torch.models import convert
    from scl_deepfake_audio_detection_torch.models.params import load_jax_params

    if os.path.isdir(args.ssl_checkpoint):
        if importlib.util.find_spec("transformers") is None:
            raise CliError(2, f"--ssl_checkpoint {args.ssl_checkpoint}: a HuggingFace "
                              "model directory needs the transformers package, which is "
                              "not installed")
        ssl_params, _ = convert.load_hf_pretrained(args.ssl_checkpoint)
    else:
        ssl_params, _ = convert.load_fairseq_checkpoint(args.ssl_checkpoint)
    load_jax_params(model.ssl, ssl_params)
    print(f"loaded pretrained SSL from {args.ssl_checkpoint}")


def replica_scorer(args, model, device):
    """Under ``--mesh D,M`` the score function of the scoring modes over
    D*M replicas of ``model``, one a local card (on ``--device cpu`` D*M
    slices on the CPU), each batch split over them; None for one replica
    (the caller's ``score_step``)."""
    import torch

    from scl_deepfake_audio_detection_torch.parallel.mesh import parse_mesh
    from scl_deepfake_audio_detection_torch.train.engine import ReplicaScorer

    try:
        shape = parse_mesh(args.mesh)
    except ValueError as e:
        raise CliError(2, f"--mesh: {e}")
    n = 1 if shape is None else shape[0] * shape[1]
    if n == 1:
        return None
    if device.type != "cuda":
        return ReplicaScorer(model, [device] * n)
    cards = torch.cuda.device_count()
    if n > cards:
        raise CliError(2, f"--mesh {args.mesh}: {n} replicas need {n} cards (one a card); "
                          f"this host has {cards}")
    first = device.index or 0
    return ReplicaScorer(model, [torch.device("cuda", (first + i) % cards) for i in range(n)])
