"""The attention forward's share of its roofline: the least time the
work of every call needs (q, k, v, O, LSE moved once at 3.35 TB/s, or its
FLOPs at 989.4 TFLOP/s, whichever is longer; from the shapes), over the
device time of every kernel launched inside the ranges the benchmark puts
around ``self_attention``, as a percentage."""

from portbench.harness import flops


def read(ctx):
    busy = ctx.tr.range_s.get("self_attention") if ctx.tr else None
    calls = ctx.tr.range_calls.get("self_attention") if ctx.tr else None
    if not busy or not calls:
        return None
    t = ctx.traffic
    batch = int(t.get("batch") or t["groups"] * t["views"])
    b, h, n, d = flops.attention_shape(ctx.cfg, batch, int(t["samples"]))
    return calls * flops.bound_seconds(*flops.flash_fwd_work(b, h, n, d)) / busy * 100.0
