#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch port goes, on one GPU.

    python3 scripts/profile_torch_train.py [--groups 2] [--views 11] [--samples 64000]

The conf-3 step: XLS-R 300M + LinearNLL, seeded random init, bf16, remat
'attn', loss_type 1 per anchor group, AdamW; the batch already on the card.
Prints, with the card's name and power limit:

- CUDA-event times of one step and of its three parts (forward with the
  loss, backward, optimizer), peak memory, and the attention kernels' share
  (their launches per step x their time per launch);
- a ``torch.profiler`` pass over a few steps: device time by kernel (top
  12) and the device's busy share of the profiled wall time.
Needs a CUDA device; the port's kernels build on first use.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--groups", type=int, default=2)
    p.add_argument("--views", type=int, default=11)
    p.add_argument("--samples", type=int, default=64000)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--cudnn_benchmark", action="store_true",
                   help="let cuDNN time its algorithms for each conv shape first")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA device", file=sys.stderr)
        return 1
    from profile_torch_eval import device_profile
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.ops import _kernels as K
    from scl_deepfake_audio_detection_torch.train.engine import Engine, _loss_and_metrics
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    K.build()
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    cfg = TrainConfig()
    ssl = XLSRConfig.xlsr_300m(compute_dtype=cfg.compute_dtype, remat=cfg.remat,
                               remat_policy="attn")
    eng = Engine(LinearNLL(ssl=ssl, device="cuda"), cfg)
    eng.init_state()
    rng = np.random.default_rng(0)
    g, v, n = args.groups, args.views, args.samples
    labels = np.tile(np.array([1.0] * (v // 2) + [0.0] * (v - v // 2), np.float32), (g, 1))
    batch = eng.place_batch({"wav": (0.1 * rng.normal(size=(g, v, n))).astype(np.float32),
                             "labels": labels})
    gen = eng.step_generator(0, 0)

    eng.train_step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(args.iters)]
    K.reset_launches()
    for e in ev:
        e[0].record()
        total, _, _ = _loss_and_metrics(eng.model, batch, True, cfg.loss_scope, gen)
        e[1].record()
        total.backward()
        e[2].record()
        eng.optimizer.step()
        e[3].record()
    torch.cuda.synchronize()
    launches = {k: c // args.iters for k, c in K.LAUNCHES.items()}
    parts = np.array([[e[i].elapsed_time(e[i + 1]) for i in range(3)] for e in ev]).mean(0)
    step = parts.sum()
    peak = torch.cuda.max_memory_allocated()
    print(f"[stages] {card}: train step [{g}, {v}, {n}] bf16 remat 'attn', cudnn.benchmark "
          f"{args.cudnn_benchmark}: {step:.3f} ms "
          f"({g * v / step * 1e3:.2f} views/s), peak memory {peak / 2**30:.3f} GiB")
    for name, ms in zip(("forward + loss", "backward (with the remat recompute)",
                         "optimizer (AdamW)"), parts):
        print(f"[stages]   {name:40s} {ms:8.3f} ms  {100 * ms / step:5.1f} %")

    t = ssl.num_frames(n)
    shape = (g * v, ssl.num_heads, t, ssl.head_dim)
    q = torch.randn(shape, device="cuda").bfloat16()
    o, lse = K.flash_attn_fwd(q, q, q)
    _, delta = K.flash_attn_bwd_dq(q, q, q, o, q, lse)
    calls = {"flash_attn_fwd": lambda: K.flash_attn_fwd(q, q, q),
             "flash_attn_bwd_dq": lambda: K.flash_attn_bwd_dq(q, q, q, o, q, lse),
             "flash_attn_bwd_dkv": lambda: K.flash_attn_bwd_dkv(q, q, q, q, lse, delta)}
    attn = 0.0
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(50):
            fn()
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / 50
        attn += launches[name] * ms
        print(f"[stages]   {name:20s} {launches[name]:3d} x {ms:.4f} ms = "
              f"{launches[name] * ms:7.3f} ms  {100 * launches[name] * ms / step:5.1f} % "
              f"({list(shape)})")
    print(f"[stages]   {'attention kernels together':40s} {attn:8.3f} ms  "
          f"{100 * attn / step:5.1f} %")
    device_profile(lambda: eng.train_step(batch, gen), 2, card, "step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
