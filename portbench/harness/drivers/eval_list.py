"""A closed-loop eval list: fixed-length clips scored in batches through the
port's eval writer (``train/scoring.produce_evaluation_file``) with
``train/engine.score_step`` as its score function, as ``--eval`` runs it
(matmul weights cast to the compute dtype, the int16 wire).

The clips come from a seeded pool made in set-up and are fed in a seeded
order until the window's time is up; the writer keeps two batches in flight
and reads each back two behind.  ``eval_utt_per_s`` (or the metric the
mix names under ``metric``) is every row written over the time from the
first issue to the return of the writer (the last readback and its lines).
``correct``: every row of the score file against the plain reference's
scores of its clip (the widest absolute gap of either column), summed up by
row and by clip, and no issued row missing.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from portbench.harness import core, flops, traffic as gen
from portbench.reference.common import Ops, exact_float32


def run(ctx: core.Ctx) -> None:
    t = ctx.traffic
    b, samples, pool_n = int(t["batch"]), int(t["samples"]), int(t["pool"])
    pool = np.stack(gen.clips(ctx.seed, [samples] * pool_n))
    core.phase(ctx, "inputs")
    fd, path = tempfile.mkstemp(suffix=".txt")
    os.close(fd)
    try:
        issued = _program(ctx, pool, path)
        rows = _read_rows(path)
    finally:
        os.unlink(path)
    core.free()
    ctx.attempted, ctx.failed = issued, issued - len(rows)
    ctx.window_flops = flops.forward_flops(ctx.cfg, samples, ctx.info["batches"] * b)
    ctx.e2e[t.get("metric", "eval_utt_per_s")] = ctx.info["batches"] * b / ctx.info["window_s"]
    cids = sorted({c for c, _ in rows.values()})
    ref = dict(zip(cids, reference_scores(ctx, pool[cids], b)))
    gaps = [(c, float(np.abs(v - ref[c]).max())) for c, v in rows.values()]
    for name, value in score_gaps([g for _, g in gaps]).items():
        ctx.check(name, value)
    for name, value in clip_gaps(gaps).items():
        ctx.check(name, value)
    ctx.check("rows_missing", ctx.failed)


def score_gaps(row_gaps) -> dict:
    """The widest gap of any row's score columns, the mean row's, and the
    median, 90th, 95th and 99th percentile row's."""
    g = np.asarray(row_gaps, np.float64)
    if not len(g):
        return {"score_gap": 0.0}
    out = {"score_gap": float(g.max()), "score_gap_mean": float(g.mean()),
           "score_gap_median": float(np.median(g))}
    out.update({f"score_gap_p{q}": float(np.percentile(g, q)) for q in (90, 95, 99)})
    return out


def clip_gaps(gaps) -> dict:
    """Of (clip id, row gap) pairs: each clip's widest row gap over all the
    rows that scored it, and the mean, median and 95th percentile clip.  A
    score altered in one batch slot reaches more clips the longer the
    window, while a clip's sound rows repeat its one gap."""
    worst = {}
    for c, g in gaps:
        worst[c] = max(worst.get(c, 0.0), g)
    w = np.asarray(list(worst.values()), np.float64)
    if not len(w):
        return {}
    return {"clip_gap_mean": float(w.mean()), "clip_gap_median": float(np.median(w)),
            "clip_gap_p95": float(np.percentile(w, 95))}


def _program(ctx: core.Ctx, pool: np.ndarray, path: str) -> int:
    """Set-up and the window; returns the rows issued in the window."""
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.train import scoring
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.device import torch_dtype

    t, cfg, rec = ctx.traffic, ctx.cfg, ctx.rec
    b = int(t["batch"])
    model = core.port_model(cfg, ctx.ref, ctx.seed, ctx.device)
    model = cast_matmul_params(model.eval(), torch_dtype(cfg["precision"]["compute_dtype"]))
    core.phase(ctx, "model")
    wire = pool if t["wire"] == "int16" else pool.astype(np.float32) / 32768.0
    ids = gen.batch_stream(ctx.seed, len(pool), b)
    count = [0]

    def batches(n=None, end=None):
        k = 0
        while (n is None or k < n) and (end is None or time.perf_counter() < end):
            row = next(ids)
            count[0] += 1
            k += 1
            yield wire[row], [f"c{c}_{count[0]}_{j}" for j, c in enumerate(row)]

    def score_fn(wav):
        out = score_step(model, wav)
        if ctx.fault == "answer":  # a planted fault: one score altered where it is made
            out = out.clone()
            out[0, 1] += 0.05
        return out

    scoring.produce_evaluation_file(batches(n=int(t["warmup_batches"])), score_fn, path)
    core.phase(ctx, "warmup")
    timed = rec.wrap(score_fn, "eval.issue") if ctx.trace else score_fn
    with contextlib.ExitStack() as stack:
        if ctx.trace:
            stack.enter_context(head_events(ctx, model))
            stack.enter_context(attention_range(ctx))
        core.setup_done(ctx)
        count[0] = 0

        def window(traced):
            t0 = time.perf_counter()
            stamps = []
            scoring.produce_evaluation_file(
                batches(end=t0 + ctx.seconds), timed, path, append=traced,
                progress=lambda n: stamps.append(time.perf_counter() - t0))
            if not traced:
                ctx.info["window_s"] = time.perf_counter() - t0
                ctx.info["batches_by_second"] = np.bincount(np.asarray(stamps, int)).tolist()
                ctx.info["batches"] = count[0]
                if rec.mode == "time" and ctx.device.type == "cuda":
                    rec.spans["head.device"] = [x / 1e3 for x in rec.device_ms("head")]
                    rec.events.clear()

        core.run_window(ctx, window)
    return count[0] * b


def _read_rows(path):
    rows = {}
    with open(path) as f:
        for line in f:
            utt, a, c = line.split()
            rows[utt] = (int(utt[1:].split("_")[0]), np.array([float(a), float(c)], np.float32))
    return rows


def reference_scores(ctx: core.Ctx, wav: np.ndarray, block: int, precision=None) -> np.ndarray:
    """The plain reference's two score columns of clips wav [N, S] (int16 or
    float), in blocks of ``block`` clips, float32 with TF32 off."""
    from portbench.harness import weights

    P = weights.make(ctx.ref.param_spec(ctx.cfg), ctx.seed, ctx.device,
                     ctx.cfg.get("init_scale"))
    ops = Ops(precision)
    out = []
    x = wav.astype(np.float32) / 32768.0 if wav.dtype == np.int16 else wav.astype(np.float32)
    with torch.no_grad(), exact_float32():
        for i in range(0, len(x), block):
            w = torch.from_numpy(x[i:i + block]).to(ctx.device)
            out.append(ctx.ref.scores(P, w, ctx.cfg, ops).float().cpu().numpy())
    del P
    return np.concatenate(out)


@contextlib.contextmanager
def head_events(ctx: core.Ctx, model):
    """CUDA events after the frontend returns and after the head, from
    outside the port: the two calls wrapped on this model object."""
    if ctx.device.type != "cuda":
        yield
        return
    rec, ssl_fn, apply_fn = ctx.rec, model.ssl.extract_features, model.apply
    pending = []

    def extract(*a, **kw):
        out = ssl_fn(*a, **kw)
        if rec.mode == "time":
            pending.append(torch.cuda.Event(enable_timing=True))
            pending[-1].record()
        return out

    def apply(*a, **kw):
        out = apply_fn(*a, **kw)
        if pending:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec.events.append(("head", pending.pop(), ev))
        return out

    model.ssl.extract_features, model.apply = extract, apply
    try:
        yield
    finally:
        del model.ssl.extract_features, model.apply


@contextlib.contextmanager
def attention_range(ctx: core.Ctx):
    """A profiler range around every attention core the encoder calls."""
    from scl_deepfake_audio_detection_torch.models import xlsr

    fn = xlsr.self_attention
    xlsr.self_attention = ctx.rec.wrap(fn, "self_attention")
    try:
        yield
    finally:
        xlsr.self_attention = fn


def control(ctx: core.Ctx, precision: str) -> dict:
    """The reference in ``precision`` put in the program's place, over the
    whole pool, read by the same number."""
    t = ctx.traffic
    pool = np.stack(gen.clips(ctx.seed, [int(t["samples"])] * int(t["pool"])))
    exact = reference_scores(ctx, pool, int(t["batch"]))
    low = reference_scores(ctx, pool, int(t["batch"]), precision)
    gaps = np.abs(low - exact).max(axis=1)
    return {**score_gaps(gaps), **clip_gaps(enumerate(gaps))}
