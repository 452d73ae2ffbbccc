"""Find the knee of open-loop serving on the card: the highest offered
rate at which the backlog does not grow and no request is shed.

    python3 portbench/sweep_serve.py --config xlsr300m-linearnll \
        --traffic http-open --rates 80,120,160 [--seconds 8] [--seed N]

A configuration and a traffic mix are named as ``BENCHMARK.json`` and
``portbench/traffic/`` have them; no cell is needed.  Each rate runs them
once in this process as a traced run does (a window for the latencies, then
the same again under the profiler for the device's idle share), at that
rate.  One JSON line a rate: p50 and p95 latency, requests shed or failed,
how late the load generator ran, the backlog's growth (median latency of
the last quarter of the requests over the first quarter's), the
MicroBatcher's rows a batch and host ms a dispatch, the idle share and the
score readings against the plain reference.  A rate is sustained when
nothing failed, the growth is under 2 and the p95 is under the mix's
latency limit.  A serving cell takes 0.8 of the highest sustained rate, in
a traffic mix of its own.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ["USE_FLAX"] = "0"


def main(argv=None, root=ROOT) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=4000000001)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from portbench.harness import cells, core, spec

    bench = spec.load(root)
    best = None
    for rate in [float(r) for r in args.rates.split(",")]:
        ctx = cells.ctx_for(bench, args.config, args.traffic, f"{args.config}.{args.traffic}",
                            args.seed, args.seconds, True, args.device)
        ctx.traffic["rate_per_s"] = rate
        ctx.bench.driver(ctx.traffic["kind"]).run(ctx)
        info, c = ctx.info, ctx.rec.counters
        idle = (1 - ctx.tr.busy_s / ctx.tr.window_s) * 100 if ctx.tr and ctx.tr.window_s else None
        batches = c.get("batcher.batches") or None
        ok = (ctx.failed == 0 and info["backlog_growth"] < 2.0
              and ctx.e2e["serve_p95_ms"] < ctx.traffic["latency_limit_ms"])
        best = rate if ok else best
        print(json.dumps({"rate_per_s": rate, "p50_ms": info["p50_ms"],
                          "p95_ms": ctx.e2e["serve_p95_ms"], "failed": ctx.failed,
                          "shed": info["shed"], "generator_late_p95_ms": info["generator_late_p95_ms"],
                          "backlog_growth": info["backlog_growth"], "idle_share_pct": idle,
                          "rows_per_batch": batches and c["batcher.served"] / batches,
                          "dispatch_ms": batches and c["batcher.dispatch_s"] / batches * 1e3,
                          "sustained": ok, "readings": info.get("readings")}), flush=True)
        core.free()
    print(json.dumps({"highest_sustained_rate_per_s": best,
                      "cell_rate_per_s": None if best is None else 0.8 * best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
