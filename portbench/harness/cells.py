"""One run of one cell: the driver its traffic names, then the metrics and
the result line."""

from __future__ import annotations

import time
from typing import Optional

import torch

from portbench.harness import core, spec as S

FORBIDDEN = ("jax", "jaxlib", "flax", "scl_deepfake_audio_detection_tpu")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root=S.ROOT, t_process: Optional[float] = None, fault: Optional[str] = None) -> dict:
    ctx = make_ctx(workload, seed, seconds, trace, device, root, t_process, fault)
    ctx.bench.driver(ctx.traffic["kind"]).run(ctx)
    return result(ctx)


def make_ctx(workload: str, seed: int, seconds: float = 0.0, trace: bool = False,
             device: str = "cuda", root=S.ROOT, t_process: Optional[float] = None,
             fault: Optional[str] = None) -> core.Ctx:
    bench = S.load(root)
    w = bench.workload(workload)
    return ctx_for(bench, w["config"], w["traffic"], workload, seed, seconds, trace, device,
                   t_process, fault, bench.limits(workload))


def ctx_for(bench, config: str, traffic: str, cell: str, seed: int, seconds: float = 0.0,
            trace: bool = False, device: str = "cuda", t_process: Optional[float] = None,
            fault: Optional[str] = None, limits: Optional[dict] = None) -> core.Ctx:
    """A run of ``config`` under ``traffic``, named ``cell``; with no
    ``limits`` every number compared is a reading only."""
    cfg = bench.config(config)
    return core.Ctx(bench=bench, cell=cell, cfg=cfg, traffic=bench.traffic(traffic),
                    seed=int(seed), seconds=float(seconds), trace=bool(trace),
                    device=torch.device(device),
                    t_process=time.perf_counter() if t_process is None else t_process,
                    ref=bench.reference(cfg["reference"]), rec=core.Recorder(),
                    limits=limits or {}, fault=fault)


def result(ctx: core.Ctx) -> dict:
    bench = ctx.bench
    units = S.units(bench)
    kind = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in bench.metrics_of(ctx.cell, kind):
        name = m["name"]
        value = (bench.metric_reader(name)(ctx) if ctx.trace else ctx.e2e.get(name))
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    correct = all(c["value"] <= c["limit"] for c in ctx.checks.values()) and bool(ctx.checks)
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    out = {"correct": correct, "attempted": int(ctx.attempted), "failed": int(ctx.failed),
           "metrics": metrics, "device": dev}
    if ctx.trace:
        dev["busy_s"], dev["window_s"] = ctx.tr.busy_s, ctx.tr.window_s
        out["breakdown"] = core.breakdown(ctx.tr)
    out["info"] = ctx.info
    out["checks"] = ctx.checks
    return out
