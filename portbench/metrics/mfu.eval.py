"""The window's analytic matmul FLOPs (``harness/flops``) over its wall
time, as a percentage of the H100's published dense bf16 peak."""

from portbench.harness import flops


def read(ctx):
    wall = ctx.info.get("window_s")
    if not ctx.window_flops or not wall:
        return None
    return ctx.window_flops / wall / flops.PEAK_BF16_FLOPS * 100.0
