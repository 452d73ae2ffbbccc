"""Host ms to issue one ``score_step`` call: the median of the spans the
benchmark puts around the eval writer's score function."""

from portbench.harness.core import median


def read(ctx):
    m = median(ctx.rec.spans.get("eval.issue", []))
    return None if m is None else m * 1e3
