"""Open-loop HTTP scoring through the port's ``serving.make_server`` (the
``--serve_http`` front end: handler threads decode and pad, one
``MicroBatcher`` worker batches and calls ``score_step``), as the CLI
builds it (matmul weights cast to the compute dtype; the float32 wire).

The load comes from ``harness/loadgen.py`` in a process of its own: WAV
bodies of seeded lengths, sent at the due times of an open-loop Poisson
schedule at the traffic file's fixed rate.  Each request's latency runs
from when it was due.  ``serve_p95_ms`` is the 95th percentile of every
request due in the window, a failed or shed one counted as never answered.
``correct``: every reply's log-probabilities against the plain reference's
on the clip as the server pads it; every request answered.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading

import numpy as np

from portbench.harness import core, traffic as gen
from portbench.harness.drivers.eval_list import reference_scores, score_gaps
from portbench.reference.common import pad_zero

NEVER_MS = 1e6  # the latency a request that got no answer counts with


def p95(latencies_ms) -> float:
    xs = sorted(latencies_ms)
    return float(np.percentile(np.asarray(xs, np.float64), 95)) if xs else NEVER_MS


def run(ctx: core.Ctx) -> None:
    t = ctx.traffic
    lengths, plan = gen.http_plan(ctx.seed, t, ctx.seconds)
    replies = _program(ctx)
    core.free()
    first = replies[:ctx.info["replies_first_window"]]
    lat = [(r[2] - r[0]) * 1e3 if r is not None and r[3] == 200 else math.inf for r in first]
    ctx.attempted = len(replies)
    ctx.failed = sum(1 for r in replies if r is None or r[3] != 200)
    ctx.e2e["serve_p95_ms"] = min(p95(lat), NEVER_MS)
    late = [r[1] - r[0] for r in first if r is not None]
    q = max(len(lat) // 4, 1)
    ctx.info.update(generator_late_p95_ms=p95([x * 1e3 for x in late]),
                    p50_ms=float(np.median(lat)) if lat else None,
                    backlog_growth=float(np.median(lat[-q:]) / np.median(lat[:q])) if lat else None,
                    shed=sum(1 for r in first if r is not None and r[3] == 503))
    clips = gen.clips(ctx.seed, lengths, stream=2)
    cut = int(t["cut"])
    used = sorted({r[4] for r in replies if r is not None and r[3] == 200})
    ref = dict(zip(used, reference_scores(
        ctx, np.stack([pad_zero(clips[c].astype(np.float32) / 32768.0, cut) for c in used]),
        int(t["batch_size"])))) if used else {}
    for name, value in score_gaps([np.abs(np.asarray(r[5], np.float32) - ref[r[4]]).max()
                                   for r in replies if r is not None and r[3] == 200]).items():
        ctx.check(name, value)
    ctx.check("unanswered", sum(1 for r in replies if r is None or r[3] < 0))



def _program(ctx: core.Ctx):
    from scl_deepfake_audio_detection_torch import serving
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.device import torch_dtype

    t, cfg = ctx.traffic, ctx.cfg
    model = core.port_model(cfg, ctx.ref, ctx.seed, ctx.device)
    model = cast_matmul_params(model.eval(), torch_dtype(cfg["precision"]["compute_dtype"]))
    core.phase(ctx, "model")

    def batch_score(block):
        out = score_step(model, block)
        if ctx.fault == "answer":  # a planted fault: one score altered where it is made
            out = out.clone()
            out[0, 1] += 0.05
        return out

    score = ctx.rec.wrap(batch_score, "serve.dispatch") if ctx.trace else batch_score
    server = serving.make_server(score, cut=int(t["cut"]), host="127.0.0.1", port=0,
                                 batch_size=int(t["batch_size"]), max_wait_ms=float(t["max_wait_ms"]),
                                 max_queue=int(t["max_queue"]))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    gen_proc = subprocess.Popen(
        [sys.executable, os.path.join(os.path.dirname(os.path.dirname(__file__)), "loadgen.py")],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        gen_proc.stdin.write(json.dumps({"port": server.server_address[1], "seed": ctx.seed,
                                         "seconds": ctx.seconds, "traffic": t}) + "\n")
        gen_proc.stdin.flush()
        if gen_proc.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        core.phase(ctx, "warmup")
        b = server.batcher
        core.setup_done(ctx)
        replies = []

        def window(traced):
            c0 = (b.served, b.batches, b.dispatch_s, b.readback_s)
            gen_proc.stdin.write("go\n")
            gen_proc.stdin.flush()
            replies.extend(json.loads(gen_proc.stdout.readline()))
            if not traced:
                ctx.info["replies_first_window"] = len(replies)
                ctx.rec.counters.update(zip(
                    ("batcher.served", "batcher.batches", "batcher.dispatch_s",
                     "batcher.readback_s"),
                    [x - y for x, y in zip((b.served, b.batches, b.dispatch_s, b.readback_s), c0)]))

        core.run_window(ctx, window)
        gen_proc.stdin.close()
        gen_proc.wait(timeout=60)
    finally:
        if gen_proc.poll() is None:
            gen_proc.kill()
            gen_proc.wait()
        server.shutdown()
        server.close()
        th.join(timeout=30)
    ctx.info["batches"] = ctx.rec.counters["batcher.batches"]
    return replies


def control(ctx: core.Ctx, precision: str) -> dict:
    """The reference in ``precision`` put in the program's place, over every
    clip of the plan as the server pads it, read by the same number."""
    t = ctx.traffic
    lengths, _ = gen.http_plan(ctx.seed, t, ctx.seconds or 1.0)
    rows = np.stack([pad_zero(c.astype(np.float32) / 32768.0, int(t["cut"]))
                     for c in gen.clips(ctx.seed, lengths, stream=2)])
    exact = reference_scores(ctx, rows, int(t["batch_size"]))
    low = reference_scores(ctx, rows, int(t["batch_size"]), precision)
    return score_gaps(np.abs(low - exact).max(axis=1))
