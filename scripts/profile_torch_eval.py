#!/usr/bin/env python3
"""Where the time of one eval forward of the PyTorch port goes, on one GPU.

    python3 scripts/profile_torch_eval.py [--batch 16] [--samples 64600]

XLS-R 300M + LinearNLL, seeded random init, bf16, the batch already on the
card.  Prints, with the card's name and power limit:

- CUDA-event times of the stages of one forward (feature encoder, post-LN
  + projection + positional conv, the encoder layers, final LN + head) and
  the attention kernel's share (its launches x its time per launch);
- a ``torch.profiler`` pass over a few forwards: device time by kernel
  (top 12) and the device's busy share of the profiled wall time.
Needs a CUDA device; the port's kernels build on first use.
"""

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters, out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--samples", type=int, default=64600)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_eval: needs a CUDA device", file=sys.stderr)
        return 1
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.ops import _kernels as K
    from scl_deepfake_audio_detection_torch.ops.layers import leaky_relu
    from scl_deepfake_audio_detection_torch.train.engine import score_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    K.build()
    model = LinearNLL(ssl=XLSRConfig.xlsr_300m(compute_dtype="bfloat16"), device="cuda")
    cast_matmul_params(model.eval(), torch.bfloat16)
    ssl, cdt = model.ssl, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    wav = torch.randn(args.batch, args.samples, device="cuda", generator=g) * 0.1
    it = args.iters

    with torch.inference_mode():
        total, _ = _ms(lambda: score_step(model, wav), it)
        fe, x = _ms(lambda: ssl.feature_encoder(wav), it)
        pre, x = _ms(lambda: (lambda y: y + ssl.pos_conv_embed(y).to(y.dtype))(
            ssl.proj(ssl.post_extract_ln(x), cdt).to(cdt)), it)

        def layers(y):
            for layer in ssl.encoder.layers:
                y = layer(y)
            return y

        enc, y = _ms(lambda: layers(x), it)

        def tail(y):
            z = model.ll(ssl.encoder.final_ln(y), cdt).relu()
            for lin in model.backend.frame:
                z = leaky_relu(lin(z, cdt), model.leaky_slope)
            return model.backend.out(z.mean(1), cdt).float().log_softmax(-1)

        head, _ = _ms(lambda: tail(y), it)
        b, t = x.shape[:2]
        h, d = ssl.cfg.num_heads, ssl.cfg.head_dim
        q = torch.randn(b, h, t, d, device="cuda", generator=g).to(cdt)
        attn, _ = _ms(lambda: K.flash_attn_fwd(q, q, q), 50)
    n_att = ssl.cfg.encoder_layers
    print(f"[stages] {card}: forward [{args.batch}, {args.samples}] bf16 "
          f"{total:.3f} ms ({args.batch / total * 1e3:.2f} utt/s)")
    for name, ms in (("feature encoder (7 convs + LN + GELU)", fe),
                     ("post-LN + proj + pos conv", pre),
                     (f"{n_att} encoder layers", enc),
                     ("final LN + head", head)):
        print(f"[stages]   {name:40s} {ms:8.3f} ms  {100 * ms / total:5.1f} %")
    print(f"[stages]   {'sum of the stages, each timed alone':40s} {fe + pre + enc + head:8.3f} ms")
    print(f"[stages]   of which flash_attn_fwd {n_att} x {attn:.4f} ms = "
          f"{n_att * attn:.3f} ms  {100 * n_att * attn / total:5.1f} % "
          f"(T={t}, [{b}, {h}, {t}, {d}])")

    with torch.inference_mode():
        device_profile(lambda: score_step(model, wav), 3, card, "fwd")
    return 0


def device_profile(fn, n: int, card: str, unit: str) -> None:
    """Run ``fn`` once, then ``n`` times under ``torch.profiler``; print the
    device's busy share of the wall time and the top 12 kernels by device
    time per ``unit`` (one call of ``fn``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # one record per kernel run: the profiler can list a kernel twice
    kernels = list({(e.name, e.time_range.start, e.time_range.end): e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA}.values())
    if not kernels:
        print("[profile] torch.profiler recorded no device events")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for e in kernels:
        tot, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), k + 1)
    ktotal = sum(v[0] for v in by_name.values())
    print(f"[profile] {card}: {n} x {unit}, device busy {busy / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({100 * busy / wall_us:.1f} %), "
          f"{len(kernels)} kernel launches, kernel time summed {ktotal / 1e3:.3f} ms "
          f"(above the busy time where kernels overlap)")
    for name, (us, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile]   {100 * us / ktotal:5.1f} %  {us / n / 1e3:8.3f} ms/{unit}  "
              f"{k // n:4d}/{unit}  {name[:90]}")


if __name__ == "__main__":
    sys.exit(main())
