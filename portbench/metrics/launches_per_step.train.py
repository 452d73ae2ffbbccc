"""CUDA kernels launched in the traced window over the steps in it."""


def read(ctx):
    steps = ctx.info.get("traced_steps")
    if not ctx.tr or not ctx.tr.launches or not steps:
        return None
    return ctx.tr.launches / steps
