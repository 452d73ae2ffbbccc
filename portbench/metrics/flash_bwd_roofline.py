"""The attention backward's share of its roofline: the least time the
dq and dk/dv work of every call needs (its bytes at 3.35 TB/s or its FLOPs
at 989.4 TFLOP/s, from the shapes), over the device time of every kernel
launched inside the ranges the benchmark puts around the attention
backward, as a percentage."""

from portbench.harness import flops


def read(ctx):
    busy = ctx.tr.range_s.get("flash_backward") if ctx.tr else None
    calls = ctx.tr.range_calls.get("flash_backward") if ctx.tr else None
    if not busy or not calls:
        return None
    t = ctx.traffic
    b, h, n, d = flops.attention_shape(ctx.cfg, t["groups"] * t["views"], int(t["samples"]))
    return calls * flops.bound_seconds(*flops.flash_bwd_work(b, h, n, d)) / busy * 100.0
