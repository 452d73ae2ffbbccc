"""Device ms of the head per forward: CUDA events recorded when the
frontend's ``extract_features`` returns and when ``apply`` returns, the
median over the window."""

from portbench.harness.core import median


def read(ctx):
    m = median(ctx.rec.spans.get("head.device", []))
    return None if m is None else m * 1e3
