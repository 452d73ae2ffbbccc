#!/usr/bin/env python
"""Time the port's training batch norm against the JAX package's form on the card.

``ops/layers.batch_norm`` is torch's fused batch norm (cuDNN or torch's own
kernel), which refuses a training batch of one value a channel.  The JAX
package writes the batch norm out (``jnp.mean`` / ``jnp.var``, then ``(x -
mean) * rsqrt(var + eps) * scale + bias``), and its n / max(n - 1, 1) rule
takes that batch too; ``jax_form`` below is that form in torch.  This
script records the shape of every batch-norm call in one training forward
of AASIST (conf-aasist.yaml) and of ResNet-18 at XLS-R 300M bf16 on a [22,
64000] batch (2 groups of 11 views, the training shape), then times
forward plus backward of each call both ways on the card (CUDA events, the
median of 20 after 3 warm-ups, the two ways in turns, the better of two).

Usage: python3 scripts/time_torch_batch_norm.py  (prints one JSON line last)
"""

import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RESNET_YAML = "model:\n  name: xlsr_resnet\n  resnet:\n    resnet_type: '18'\n"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown card"


def bn_shapes(kind: str):
    """(shape, dtype) of every batch-norm call of one training forward."""
    from scl_deepfake_audio_detection_torch.models import base
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.utils.config import load_config
    from scl_deepfake_audio_detection_torch.utils.registry import MODELS

    if kind == "aasist":
        cfg = load_config(os.path.join(ROOT, "configs", "conf-aasist.yaml"))
        model_cfg = cfg.model
    else:
        import tempfile

        with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
            f.write(RESNET_YAML)
        model_cfg = load_config(f.name).model
        os.unlink(f.name)
    model = MODELS.get(model_cfg.name).from_config(
        model_cfg, ssl=XLSRConfig.xlsr_300m(compute_dtype="bfloat16"), device="cuda")
    seen = []
    inner = base.batch_norm

    def record(x, *a, **k):
        seen.append((tuple(x.shape), x.dtype))
        return inner(x, *a, **k)

    base.batch_norm = record
    try:
        wav = 0.1 * torch.randn(22, 64000, device="cuda")
        with torch.no_grad():
            model.apply(wav, train=True)
    finally:
        base.batch_norm = inner
    del model
    torch.cuda.empty_cache()
    return seen


def jax_form(x, scale, bias, mean, var, eps=1e-5, momentum=0.1):
    """The JAX package's training batch norm, in fp32, returned in x's
    dtype: the batch statistics, then (x - mean) * scale * rsqrt(var + eps)
    + bias; the running statistics moved by n / max(n - 1, 1)."""
    x32 = x.float()
    n = x32.numel() // x32.shape[1]
    v, m = torch.var_mean(x32, dim=[d for d in range(x32.dim()) if d != 1], correction=0)
    with torch.no_grad():
        mean.mul_(1 - momentum).add_(m, alpha=momentum)
        var.mul_(1 - momentum).add_(v, alpha=momentum * n / max(n - 1, 1))
    shape = [1, -1] + [1] * (x32.dim() - 2)
    a = (scale * torch.rsqrt(v + eps)).reshape(shape)
    return torch.addcmul(bias.reshape(shape), x32 - m.reshape(shape), a).to(x.dtype)


def timed(fn, x, grad, iters=20, warm=3):
    ms = []
    for i in range(warm + iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = fn(x)
        y.backward(grad)
        end.record()
        torch.cuda.synchronize()
        x.grad = None
        if i >= warm:
            ms.append(start.elapsed_time(end))
    return statistics.median(ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_batch_norm: no CUDA device", file=sys.stderr)
        return 1
    from scl_deepfake_audio_detection_torch.ops.layers import batch_norm

    card = card_line()
    result = {"card": card, "heads": {}}
    for kind in ("aasist", "resnet"):
        rows, totals = [], {"port": 0.0, "jax_form": 0.0}
        for shape, dtype in bn_shapes(kind):
            c = shape[1]
            x = torch.randn(shape, device="cuda", dtype=dtype).requires_grad_()
            grad = torch.randn(shape, device="cuda", dtype=dtype)
            w = torch.rand(c, device="cuda") + 0.5
            b = 0.1 * torch.randn(c, device="cuda")
            stats = [torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")]
            ways = {"port": lambda t: batch_norm(t, w, b, *stats, True),
                    "jax_form": lambda t: jax_form(t, w, b, *stats)}
            got = {k: [] for k in ways}
            for k in ("port", "jax_form", "jax_form", "port"):
                got[k].append(timed(ways[k], x, grad))
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   **{k: min(v) for k, v in got.items()}}
            rows.append(row)
            for k in totals:
                totals[k] += row[k]
        result["heads"][kind] = {"calls": rows, "sum_ms": totals}
        print(f"[bn] {card}: {kind}, {len(rows)} batch norms of a [22, 64000] training "
              f"forward, forward + backward: port (fused) {totals['port']:.3f} ms, "
              f"the JAX form {totals['jax_form']:.3f} ms")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
