"""Shared measurement methodology for the port's eval and train-step numbers.

Counterpart of ``scl_deepfake_audio_detection_tpu/utils/measure.py``, with
its two rules:

- end timing on a HOST READBACK (``float(...)``): the host's clock then
  covers every launch the loop issued, whatever the launches queue;
- chain iterations through the previous output so repeated identical
  calls cannot be elided or cached anywhere between host and card (the
  perturbation is numerically nil: ``out[0, 0] * 1e-30``).

On the card each helper also prints the device time of the same loop from
CUDA events beside the host's.  Both run on the card unless the caller
passes ``device="cpu"`` (``utils/device.resolve_device``); the model or the
engine must already be on that device.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from scl_deepfake_audio_detection_torch.ops.layers import dewire_pcm16
from scl_deepfake_audio_detection_torch.train.engine import score_step
from scl_deepfake_audio_detection_torch.utils.device import resolve_device


def _on(device, have: torch.device, what: str) -> torch.device:
    dev = resolve_device(device)
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"{what} is on {have}, not on {dev}; pass device={str(have)!r} "
                         f"or move it")
    return have


def _events(device: torch.device):
    if device.type != "cuda":
        return None
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def chained_eval_throughput(model, wav, iters: int, warmup: int = 3,
                            device: Optional[str] = None) -> Tuple[float, float]:
    """(utterances/sec, ms/iter) for ``train/engine.score_step`` on ``wav``
    ([batch, samples], numpy or a tensor; fp32, or int16 PCM wire), each
    call fed the last one's ``out[0, 0] * 1e-30``, timed from a host
    readback to a host readback.  The JAX function's ``params`` argument
    is gone: an ``nn.Module`` holds its own parameters."""
    dev = _on(device, next(model.parameters()).device, "the model")
    ev = _events(dev)
    with torch.inference_mode():
        wav = dewire_pcm16(torch.as_tensor(wav).to(dev))
        feed = torch.zeros((), dtype=wav.dtype, device=dev)
        for _ in range(max(warmup, 1)):
            out = score_step(model, wav + feed)
            feed = out[0, 0].to(wav.dtype) * 1e-30
        float(out.sum())  # host readback: the card is idle from here
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        for _ in range(iters):
            out = score_step(model, wav + feed)
            feed = out[0, 0].to(wav.dtype) * 1e-30
        if ev:
            ev[1].record()
        checksum = float(out.sum())  # timed region ends when data reaches host
        dt = time.perf_counter() - t0
    assert np.isfinite(checksum)
    batch = wav.shape[0]
    if ev:
        print(f"chained_eval_throughput: [{batch}, {wav.shape[1]}] x {iters}: host "
              f"{dt / iters * 1e3:.4f} ms/iter, CUDA events "
              f"{ev[0].elapsed_time(ev[1]) / iters:.4f} ms/iter")
    return batch * iters / dt, dt / iters * 1000


def _engine_state(engine):
    """Copies of everything a train step changes: the model's parameters
    and buffers, and the optimizer's AdamW state, update targets and
    accumulation state."""
    opt = engine.optimizer
    return {
        "model": {k: v.detach().clone() for k, v in engine.model.state_dict().items()},
        "targets": [t.detach().clone() for t in opt.targets],
        "adamw": {t: {k: v.clone() if isinstance(v, torch.Tensor) else v
                      for k, v in st.items()} for t, st in opt.adamw.state.items()},
        "mini_step": opt.mini_step,
        "acc": None if opt.acc is None else [a.clone() for a in opt.acc],
    }


@torch.no_grad()
def _restore(engine, state) -> None:
    opt = engine.optimizer
    live = engine.model.state_dict()
    for k, v in state["model"].items():
        live[k].copy_(v)
    for t, v in zip(opt.targets, state["targets"]):
        t.copy_(v)
    opt.adamw.state.clear()
    for t, st in state["adamw"].items():
        opt.adamw.state[t] = {k: v.clone() if isinstance(v, torch.Tensor) else v
                              for k, v in st.items()}
    opt.mini_step = state["mini_step"]
    opt.acc = None if state["acc"] is None else [a.clone() for a in state["acc"]]
    opt.zero_grad()


def train_ms_per_step(engine, batch: Dict[str, np.ndarray], k1: int = 3, k2: int = 9,
                      device: Optional[str] = None) -> float:
    """Differenced train-step timing: ``k`` chained ``Engine.train_step``
    calls on ``batch`` (the {wav, labels} group batch, placed once and
    re-fed every step), each with ``engine.step_generator(0, i)``, the step
    ``fit`` takes, timed warm from a readback to a readback for k1 and for
    k2 steps; returns (t[k2] - t[k1]) / (k2 - k1) in ms, so the per-run
    overhead cancels in the difference.  The JAX function's scan never
    touches its caller's state; here every run starts from the engine's
    state and the engine is left bit-equal to how it was found."""
    if engine.optimizer is None:
        engine.init_state()
    dev = _on(device, engine.device, "the engine")
    placed = engine.place_batch(batch)
    probe = next(engine.model.parameters()).detach()
    saved = _engine_state(engine)
    ev = _events(dev)

    def run(k: int):
        _restore(engine, saved)
        float(probe.reshape(-1)[0])  # host readback: the card is idle from here
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        for i in range(k):
            m = engine.train_step(placed, engine.step_generator(0, i))
        if ev:
            ev[1].record()
        loss = float(m["loss"])  # host readback ends timing
        dt = time.perf_counter() - t0
        assert np.isfinite(loss)
        return dt, ev[0].elapsed_time(ev[1]) if ev else None

    try:
        run(k1)  # warm: the first steps allocate and tune
        times = {k: run(k) for k in (k1, k2)}
    finally:
        _restore(engine, saved)
    ms = (times[k2][0] - times[k1][0]) / (k2 - k1) * 1000
    if ev:
        ev_ms = (times[k2][1] - times[k1][1]) / (k2 - k1)
        print(f"train_ms_per_step: k = {k1}, {k2}: host {ms:.4f} ms/step, CUDA events "
              f"{ev_ms:.4f} ms/step")
    return ms
