"""The share of the traced window in which no operation ran on the device,
as a percentage."""


def read(ctx):
    if not ctx.tr or not ctx.tr.window_s or not ctx.tr.busy_s:
        return None
    return (1.0 - ctx.tr.busy_s / ctx.tr.window_s) * 100.0
