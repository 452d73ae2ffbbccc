#!/usr/bin/env python
"""Hold ``utils/measure`` against the plain timing loops of ``chip_smoke.py``,
in turns, on one card.

Usage:
    python scripts/compare_torch_measure.py [--rounds 2]

At XLS-R 300M + LinearNLL with seeded random weights, bf16 (TF32 off):

- the eval forward at [16, 64600]: ``phase_times``' loop (20 ``score_step``
  calls, host clock to a synchronize) against
  ``utils/measure.chained_eval_throughput`` (20 calls), ms a forward, in the
  order plain, chained, chained, plain per round;
- the conf-3 step at [2, 11, 64000] (remat 'attn'): ``phase_train_main_path``'s
  loop (6 ``Engine.train_step`` calls on placed batches, host clock to a
  synchronize) against ``utils/measure.train_ms_per_step`` (k1 = 3, k2 = 9),
  ms a step, in the same order, on one engine.

It prints the card's name and power limit, one line per turn, and a JSON
line with every reading.  It needs one card and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params  # noqa: E402
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL  # noqa: E402
from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig  # noqa: E402
from scl_deepfake_audio_detection_torch.ops import _kernels as K  # noqa: E402
from scl_deepfake_audio_detection_torch.train.engine import Engine, score_step  # noqa: E402
from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate  # noqa: E402
from scl_deepfake_audio_detection_torch.utils import measure  # noqa: E402
from scl_deepfake_audio_detection_torch.utils.config import TrainConfig  # noqa: E402

ORDER = ("plain", "measure", "measure", "plain")


def eval_plain(model, wav, iters=20) -> float:
    for _ in range(3):
        score_step(model, wav)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        score_step(model, wav)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def train_plain(eng, placed, iters=6) -> float:
    t0 = time.perf_counter()
    for i in range(iters):
        eng.train_step(placed[i % len(placed)], eng.step_generator(1, i + 1))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_measure: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    K.build()
    out = {"card": card, "eval_ms": {"plain": [], "measure": []},
           "train_ms": {"plain": [], "measure": []}}

    g = torch.Generator(device="cuda").manual_seed(1)
    model = LinearNLL(ssl=XLSRConfig.xlsr_300m(compute_dtype="bfloat16"), device="cuda", seed=0)
    cast_matmul_params(model.eval(), torch.bfloat16)
    wav = torch.randn(16, 64600, device="cuda", generator=g) * 0.1
    for _ in range(args.rounds):
        for how in ORDER:
            ms = (eval_plain(model, wav) if how == "plain"
                  else measure.chained_eval_throughput(model, wav, 20)[1])
            out["eval_ms"][how].append(ms)
            print(f"[eval] {card}: {how} {ms:.3f} ms a forward", flush=True)
    del model
    torch.cuda.empty_cache()

    cfg = TrainConfig(seed=1234)
    ssl = XLSRConfig.xlsr_300m(compute_dtype=cfg.compute_dtype, remat=cfg.remat,
                               remat_policy="attn")
    eng = Engine(LinearNLL(ssl=ssl, device="cuda", seed=1234), cfg)
    eng.init_state()
    set_learning_rate(eng.optimizer, 1e-5)
    rng = np.random.default_rng(1234)
    labels = np.tile(np.array([1.0] * 5 + [0.0] * 6, np.float32), (2, 1))
    batches = [{"wav": (0.1 * rng.normal(size=(2, 11, 64000))).astype(np.float32),
                "labels": labels} for _ in range(3)]
    placed = [eng.place_batch(b) for b in batches]
    eng.train_step(placed[0], eng.step_generator(1, 0))
    torch.cuda.synchronize()
    for _ in range(args.rounds):
        for how in ORDER:
            ms = (train_plain(eng, placed) if how == "plain"
                  else measure.train_ms_per_step(eng, batches[0]))
            out["train_ms"][how].append(ms)
            print(f"[train] {card}: {how} {ms:.3f} ms a step", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
