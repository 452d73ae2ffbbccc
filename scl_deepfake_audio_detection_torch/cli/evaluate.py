"""``--eval``: score an eval list into ``utt cm0 cm1`` lines.

EvalDataset -> EvalLoader -> score_step -> produce_evaluation_file, the
flow of ``scl_deepfake_audio_detection_tpu/cli/evaluate.py`` without its
decode cache, resume, long-audio and multi-host options.
"""

from __future__ import annotations

import sys
import time

from scl_deepfake_audio_detection_torch.cli import CliError
from scl_deepfake_audio_detection_torch.data import protocols
from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset, layout
from scl_deepfake_audio_detection_torch.data.loader import EvalLoader
from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.params import load_jax_params
from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
from scl_deepfake_audio_detection_torch.train import scoring
from scl_deepfake_audio_detection_torch.train.engine import score_step
from scl_deepfake_audio_detection_torch.utils.config import load_config
from scl_deepfake_audio_detection_torch.utils.device import resolve_device, torch_dtype


def build_model(args, cfg) -> LinearNLL:
    """The scoring model: seeded random init, or the ``--model_path``
    checkpoint's parameters; matmul weights cast to the compute dtype."""
    if cfg.model.name != "xlsr_linear_nll":
        raise CliError(2, f"not ported yet: model {cfg.model.name!r} "
                          "(the port has xlsr_linear_nll)")
    if args.model_path and not args.model_path.endswith(".ckpt"):
        raise CliError(2, f"not ported yet: --model_path {args.model_path} "
                          "(the port reads JAX-format .ckpt files)")
    ssl = getattr(XLSRConfig, args.ssl_preset)(compute_dtype=args.compute_dtype)
    model = LinearNLL.from_config(cfg.model, ssl=ssl,
                                  device=resolve_device(args.device), seed=args.seed)
    if args.model_path:
        tree, extra = ckpt.load(args.model_path)
        load_jax_params(model, tree["params"] if "params" in tree else tree)
        print(f"loaded checkpoint {args.model_path} (extra={extra})")
    return cast_matmul_params(model.eval(), torch_dtype(args.compute_dtype))


def run(args) -> int:
    cfg = load_config(args.config)
    try:
        desc = layout(cfg.data.name)
    except KeyError as e:
        raise CliError(2, str(e))
    model = build_model(args, cfg)

    if desc["variant"] is None:
        _, file_eval = protocols.gen_list_eval_only(args.database_path)
    else:
        _, file_eval = protocols.gen_list_scl(args.database_path, "eval")
    print(f"no. of eval trials {len(file_eval)}")
    out = args.eval_output or "scores.txt"
    ds = EvalDataset(file_eval, args.database_path, padding_type=args.padding_type,
                     use_eval_subdir=desc["eval_subdir"])
    loader = EvalLoader(ds, batch_size=max(args.batch_size, 1),
                        num_workers=args.num_workers, wire_dtype=args.wire_dtype)
    t0 = time.time()
    total = len(file_eval)
    last = {"n": 0, "t": t0}

    def progress(n):
        if n - last["n"] >= max(200, total // 50) or n >= total:
            now = time.time()
            rate = (n - last["n"]) / max(now - last["t"], 1e-9)
            print(f"  scored {n}/{total} ({rate:.1f} utt/s)", file=sys.stderr)
            last["n"], last["t"] = n, now

    scoring.produce_evaluation_file(loader, lambda wav: score_step(model, wav), out,
                                    progress=progress)
    dt = time.time() - t0
    print(f"scored {total} utts in {dt:.1f}s ({total / dt:.1f} utt/s) -> {out}")
    return 0
