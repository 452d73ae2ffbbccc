"""What every driver shares: the port's model built from a configuration
file with the benchmark's weights, the span recorder, the profiler and its
reduction to busy time, kernel time by name and by range, and the result.
"""

from __future__ import annotations

import bisect
import contextlib
import statistics
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench.harness import weights

GIB = 1024 ** 3


# ------------------------------------------------------------------ model

def port_model(cfg: dict, ref, seed: int, device):
    """The port's model class named by the configuration, built on ``meta``
    (no weights of its own), moved to ``device`` and filled with the
    benchmark's seeded weights."""
    import importlib

    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig

    mod, cls = cfg["port"]["class"].split(":")
    ssl = dict(cfg["ssl"])
    ssl["conv_layers"] = tuple(tuple(c) for c in ssl["conv_layers"])
    prec, tr = cfg["precision"], cfg["training"]
    xcfg = XLSRConfig(**ssl, compute_dtype=prec["compute_dtype"], remat=tr["remat"],
                      remat_policy=tr["remat_policy"])
    if xcfg.approx_gelu != (prec["gelu"] == "tanh"):
        raise ValueError("the port's GELU form differs from the configuration's")
    kwargs = {k: v for k, v in cfg["head"].items() if k != "kind"}
    kwargs.update({k: tr[k] for k in ("loss_type", "contra_mode", "temperature")})
    model = getattr(importlib.import_module(mod), cls)(ssl=xcfg, device="meta", **kwargs)
    model = model.to_empty(device=device)
    weights.load_into(model, weights.make(ref.param_spec(cfg), seed, device,
                                          cfg.get("init_scale")))
    return model


# ------------------------------------------------------------------ spans

class Recorder:
    """Spans and counters of the benchmark's own, kept in memory.  ``mode``
    is None (an untraced run: nothing recorded), "time" (the first window
    of a traced run: host seconds of each span, CUDA events) or "range"
    (its second window, under the profiler: each span a profiler range)."""

    def __init__(self):
        self.mode = None
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.counters: Dict[str, float] = {}
        self.events: List[tuple] = []  # (name, start event, end event)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.mode == "range":
            with torch.profiler.record_function("pb." + name):
                yield
        elif self.mode == "time":
            t0 = time.perf_counter()
            yield
            self.spans[name].append(time.perf_counter() - t0)
        else:
            yield

    def wrap(self, fn: Callable, name: str) -> Callable:
        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return wrapped

    def device_ms(self, name: str) -> List[float]:
        """Milliseconds between each recorded pair of CUDA events."""
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for n, s, e in self.events if n == name]


def median(xs):
    return statistics.median(xs) if xs else None


# --------------------------------------------------------------- profiler

def profiler(on: bool, device: torch.device):
    if not on:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    launches: int = 0
    by_name: Dict[str, float] = field(default_factory=dict)
    range_s: Dict[str, float] = field(default_factory=dict)  # device s launched in a range
    range_calls: Dict[str, int] = field(default_factory=dict)
    gaps: Dict[str, float] = field(default_factory=dict)  # idle s by the host's range


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(prof, window_range: str = "pb.window") -> Trace:
    """Busy time (the union of every device operation's interval inside the
    window), kernel launches, device time by kernel name, device time of
    the kernels launched inside each ``pb.*`` range (matched through the
    launch's correlation id), and idle gaps labelled by the innermost
    ``pb.*`` range the host was in when each began."""
    tr = Trace()
    if prof is None:
        return tr
    evs = prof.profiler.kineto_results.events()
    cpu, dev, ranges, host_names = [], [], [], set()
    for e in evs:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(e)
            continue
        host_names.add(e.name())
        if e.name().startswith("pb."):
            ranges.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.name().startswith("cu"):
            cpu.append(e)
    # the device-side copies of host ranges (user annotations) are no work
    dev = [e for e in dev if e.name() not in host_names and not e.is_user_annotation()]
    win = [r for r in ranges if r[0] == window_range]
    if not win:
        return tr
    w0, w1 = win[0][1], win[0][2]
    tr.window_s = (w1 - w0) / 1e9
    launch_at = {e.correlation_id(): e.start_ns() for e in cpu}
    by_range: Dict[str, list] = defaultdict(list)
    for n, s, e in ranges:
        if n != window_range:
            by_range[n[3:]].append((s, e))
    index = {n: (sorted(v), [s for s, _ in sorted(v)]) for n, v in by_range.items()}

    def inside(t):
        """The ranges (name, start) that hold host time ``t``."""
        out = []
        for n, (spans, starts) in index.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][1] >= t:
                out.append((spans[i][0], n))
        return out

    iv = []
    for e in dev:
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t <= s:
            continue
        iv.append((s, t))
        d = (t - s) / 1e9
        name = e.name()
        tr.by_name[name] = tr.by_name.get(name, 0.0) + d
        if "memcpy" not in name.lower() and "memset" not in name.lower():
            tr.launches += 1
        at = launch_at.get(e.linked_correlation_id()) or launch_at.get(e.correlation_id())
        if at is not None:
            for _, n in inside(at):
                tr.range_s[n] = tr.range_s.get(n, 0.0) + d
    for n, (spans, _) in index.items():
        tr.range_calls[n] = sum(1 for s, _ in spans if w0 <= s <= w1)
    merged = _union(iv)
    tr.busy_s = sum(e - s for s, e in merged) / 1e9
    edges = [w0] + [x for m in merged for x in m] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            label = max(inside(s), default=(0, "none"))[1]
            tr.gaps[label] = tr.gaps.get(label, 0.0) + (e - s) / 1e9
    return tr


def breakdown(tr: Trace) -> dict:
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(tr.by_name), "idle_gaps": top(tr.gaps)}


# ------------------------------------------------------------------ cells

@dataclass
class Ctx:
    """What a driver gets and fills."""

    bench: Any
    cell: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float
    ref: Any = None
    rec: Recorder = None
    limits: dict = field(default_factory=dict)
    fault: Optional[str] = None
    look: Optional[dict] = None  # where a driver leaves what ``control.py --look`` reads
    # filled by the driver
    e2e: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, dict] = field(default_factory=dict)
    tr: Optional[Trace] = None
    window_flops: float = 0.0
    memory_peak_bytes: int = 0
    info: Dict[str, Any] = field(default_factory=dict)

    def check(self, name: str, value: float) -> None:
        """A reading; compared, beside its limit, where the cell's limits
        file names it."""
        self.info.setdefault("readings", {})[name] = float(value)
        if name in self.limits:
            self.checks[name] = {"value": float(value), "limit": float(self.limits[name]["limit"])}


TRACED_WINDOW_S = 10.0  # the profiled window's length, at most


def run_window(ctx: Ctx, body: Callable[[bool], None]) -> None:
    """The measured window, ``body(False)``, with the device's peak memory
    reset at its start.  A traced run then runs a second window,
    ``body(True)``, of at most ``TRACED_WINDOW_S`` under the profiler: the
    first gives the metrics taken on the host's clock, unslowed by the
    profiler, the second the device trace (a shorter one keeps the trace's
    reduction inside the run's time)."""
    dev = ctx.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ctx.rec.mode = "time" if ctx.trace else None
    body(False)
    sync()
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        ctx.e2e["peak_mem_gib"] = peak / GIB
        ctx.memory_peak_bytes = max(ctx.memory_peak_bytes, peak)
    if not ctx.trace:
        return
    ctx.rec.mode = "range"
    seconds, ctx.seconds = ctx.seconds, min(ctx.seconds, TRACED_WINDOW_S)
    prof = profiler(True, dev)
    with prof:
        with torch.profiler.record_function("pb.window"):
            body(True)
            sync()
    ctx.rec.mode, ctx.seconds = None, seconds
    ctx.tr = reduce_trace(prof)
    if dev.type == "cuda":
        ctx.memory_peak_bytes = max(ctx.memory_peak_bytes, torch.cuda.max_memory_allocated())


def phase(ctx: "Ctx", name: str) -> None:
    """Seconds from the process's start to the end of a set-up phase."""
    ctx.info.setdefault("setup_phases", {})[name] = round(time.perf_counter() - ctx.t_process, 3)


def setup_done(ctx: Ctx) -> None:
    """Set-up ends at the first timed call."""
    if ctx.device.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()
    ctx.e2e["setup_s"] = time.perf_counter() - ctx.t_process
    phase(ctx, "setup")


def free() -> None:
    """Return the freed program's device memory before the reference runs."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
