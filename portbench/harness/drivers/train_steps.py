"""SCL train steps through the port's ``train/engine.Engine``, as ``fit``
calls it: each step places a [G, V, S] view batch with ``place_batch`` and
runs ``train_step(batch, step_generator(0, i))`` (forward, the loss per
anchor group, backward through remat, AdamW from ``train/optim``).

Set-up builds one engine with the benchmark's weights, drives it through
its first ``check_steps`` steps on batches whose rows all differ, reads the
program's numbers from them (each step's loss; each leaf's first gradient
from AdamW's first moment after step 1, m = (1 - b1) g; after each check
step each leaf's change since the start and that step's own, and AdamW's
moments), and hands the same engine to the window, which runs steps until
its time is up and ends on a readback of the last loss.
``train_ms_per_step`` is the window's wall time over its steps.

``correct``: the plain reference follows the same steps from the same
weights, batches and dropout draws in float32, and each number is compared
by the worst leaf or the median leaf, the gap between the two norms over
the reference's norm of that leaf or of the median leaf, whichever is
larger; leaves whose
reference gradient is under a thousandth of the median leaf's are left out
(their change is round-off under AdamW).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Optional

import numpy as np
import torch

from portbench.harness import core, flops, traffic as gen, weights
from portbench.reference.common import AdamW, Ops, exact_float32, step_seed


def make_pool(ctx: core.Ctx):
    t = ctx.traffic
    g, v, s, n = int(t["groups"]), int(t["views"]), int(t["samples"]), int(t["pool_steps"])
    wav = np.stack(gen.clips(ctx.seed, [s] * (n * g * v), stream=1)).astype(np.float32) / 32768.0
    labels = np.tile(np.asarray(t["view_labels"], np.int64), (n, g, 1))
    return wav.reshape(n, g, v, s), labels


def run(ctx: core.Ctx) -> None:
    wav, labels = make_pool(ctx)
    core.phase(ctx, "inputs")
    prog = _program(ctx, wav, labels)
    core.free()
    ref = reference_readings(ctx, wav, labels, look=ctx.look)
    for name, value in compare(prog, ref).items():
        ctx.check(name, value)
    ctx.info.update(loss_program=prog["loss"].tolist(), loss_reference=ref["loss"].tolist())


def _leaf_norms(tensors):
    return torch.stack([torch.linalg.vector_norm(x.float()) for x in tensors]).cpu().numpy()


def _program(ctx: core.Ctx, wav, labels) -> dict:
    from scl_deepfake_audio_detection_torch.train.engine import Engine
    from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

    t, cfg, rec = ctx.traffic, ctx.cfg, ctx.rec
    tr = cfg["training"]
    model = core.port_model(cfg, ctx.ref, ctx.seed, ctx.device)
    core.phase(ctx, "model")
    engine = Engine(model, TrainConfig(seed=ctx.seed, weight_decay=tr["weight_decay"],
                                       compute_dtype=cfg["precision"]["compute_dtype"],
                                       remat=tr["remat"]))
    engine.init_state()
    opt = engine.optimizer
    set_learning_rate(opt, tr["lr"])
    if ctx.fault == "unchanged":  # a planted fault: the step leaves the state as it was
        opt.step = lambda: (opt.zero_grad(), True)[1]
    look = ctx.look
    pool_n = len(wav)

    def step(i):
        batch = {"wav": wav[i % pool_n], "labels": labels[i % pool_n]}
        if ctx.fault == "half_batch":  # a planted fault: half the groups left out
            batch = {k: x[: len(x) // 2] for k, x in batch.items()}
        return engine.train_step(engine.place_batch(batch), engine.step_generator(0, i))

    n_check = int(t["check_steps"])
    p0 = weights.make(ctx.ref.param_spec(cfg), ctx.seed, ctx.device, cfg.get("init_scale"))
    named = dict(model.named_parameters())
    params = [named[n].detach() for n in opt.names]
    readings = {"names": list(opt.names), "loss": []}
    zero = torch.zeros(1, device=ctx.device)
    for i in range(n_check):
        if look is not None and i:  # the program's parameters before this step
            look.setdefault("params", {})[i] = {n: named[n].detach().float().cpu()
                                                for n in opt.names}
        if ctx.fault == "moments_reset" and i == 1:  # a planted fault: AdamW starts afresh
            opt.adamw.state.clear()
        prev = [x.clone() for x in params]
        readings["loss"].append(step(i)["loss"])
        st = [opt.adamw.state.get(p, {}) for p in opt.targets]
        if i == 0:
            readings["grad"] = _leaf_norms([s["exp_avg"] / 0.1 if s else zero for s in st])
            if look is not None:
                look["sign1"] = {n: torch.sign(s["exp_avg"]).to(torch.int8).cpu()
                                 for n, s in zip(opt.names, st) if s}
        _after_step(readings, params, [p0[n] for n in opt.names], prev,
                    [s["exp_avg"] if s else zero for s in st],
                    [s["exp_avg_sq"] if s else zero for s in st])
    del p0, prev
    readings["loss"] = np.array([float(x) for x in readings["loss"]])
    core.phase(ctx, "check_steps")
    with contextlib.ExitStack() as stack:
        run_step = step
        if ctx.trace:
            run_step = rec.wrap(step, "train.step")
            stack.enter_context(attention_ranges(ctx))
        core.setup_done(ctx)
        box = {"next": n_check, "steps": 0}

        def window(traced):
            t0 = time.perf_counter()
            end, i, last = t0 + ctx.seconds, box["next"], None
            while time.perf_counter() < end:
                last = run_step(i)["loss"]
                i += 1
            box["finite"] = box.get("finite", True) and bool(np.isfinite(float(last)))
            if not traced:
                box["wall"], box["steps"] = time.perf_counter() - t0, i - box["next"]
            else:
                ctx.info["traced_steps"] = i - box["next"]
            box["next"] = i

        core.run_window(ctx, window)
    ctx.attempted = box["next"] - n_check
    ctx.failed = 0 if box["finite"] else 1
    ctx.window_flops = box["steps"] * flops.train_step_flops(
        cfg, int(t["samples"]), int(t["groups"]) * int(t["views"]))
    ctx.info.update(steps=box["steps"], window_s=box["wall"])
    ctx.e2e["train_ms_per_step"] = box["wall"] / box["steps"] * 1e3
    return readings


def reference_readings(ctx: core.Ctx, wav, labels, precision=None, groups=None,
                       look: Optional[dict] = None) -> dict:
    """The plain reference's loss of each check step, each leaf's first
    gradient, its change after each check step and AdamW's moments after
    the last.  With the program's ``look`` (``control.py --look``): the
    share of elements whose first gradient's sign differs from the
    program's, and the reference's loss of each later check step from the
    program's parameters before it."""
    cfg, ref, t = ctx.cfg, ctx.ref, ctx.traffic
    tr = cfg["training"]
    P0 = weights.make(ref.param_spec(cfg), ctx.seed, ctx.device, cfg.get("init_scale"))
    names = [n for n, _, _ in ref.param_spec(cfg) if not n.endswith((".mean", ".var"))]
    P = {n: P0[n].clone().requires_grad_(True) for n in names}
    opt = AdamW(P, tr["lr"], tr["weight_decay"])
    ops = Ops(precision)
    keep = 1.0 - cfg["head"]["dropout"]
    g, v, s = wav.shape[1:]
    frames = flops.num_frames(cfg["ssl"], s)
    out = {"names": names, "loss": []}
    params = [P[n].detach() for n in names]
    with exact_float32():
        for i in range(int(t["check_steps"])):
            gen_ = torch.Generator(device=ctx.device).manual_seed(step_seed(ctx.seed, 0, i))
            masks = [torch.rand(shape, generator=gen_, device=ctx.device) < keep
                     for shape in ref.dropout_shapes(cfg, g * v, frames)]
            w = torch.from_numpy(wav[i]).to(ctx.device)
            lab = torch.from_numpy(labels[i]).to(ctx.device)
            loss = ref.loss(P, w, lab, cfg, ops, masks, groups)
            grads = torch.autograd.grad(loss, list(P.values()), allow_unused=True)
            grads = dict(zip(P, grads))
            out["loss"].append(loss.item())
            if i == 0:
                out["grad"] = _leaf_norms([grads[n] if grads[n] is not None
                                           else torch.zeros(1, device=ctx.device) for n in names])
                if look is not None:
                    look.update(_sign_flips(look["sign1"], grads))
            if look is not None and i in look.get("params", {}):
                with torch.no_grad():
                    Q = {n: look["params"][i][n].to(ctx.device) if n in look["params"][i]
                         else P0[n] for n in P}
                    look.setdefault("ref_loss_on_program", {})[i] = ref.loss(
                        Q, w, lab, cfg, ops, masks, groups).item()
                    del Q
            prev = [x.clone() for x in params]
            opt.step(grads)
            del grads, loss
            _after_step(out, params, [P0[n] for n in names], prev,
                        [opt.m[n] for n in names], [opt.v[n] for n in names])
    out["loss"] = np.array(out["loss"])
    return out


def _after_step(out: dict, params, start, prev, m, v) -> None:
    """Append each leaf's norms after a check step: of its change since the
    start and since the step before, of AdamW's first moment and of the
    square root of its second."""
    for key, xs in (("change", [p - a for p, a in zip(params, start)]),
                    ("increment", [p - a for p, a in zip(params, prev)]),
                    ("moment1", m), ("moment2", [x.sqrt() for x in v])):
        out.setdefault(key, []).append(_leaf_norms(xs))


def _sign_flips(program_signs: dict, grads: dict) -> dict:
    """The share of elements whose first gradient has another sign in the
    program than in the reference, over all of them and over each leaf's
    larger half by the reference's magnitude."""
    flips = big_flips = total = big = 0
    for n, s in program_signs.items():
        g = grads.get(n)
        if g is None:
            continue
        diff = s.to(g.device).float().reshape(g.shape) != torch.sign(g)
        a = g.abs()
        large = a >= a.flatten().median()
        flips += int(diff.sum())
        big_flips += int((diff & large).sum())
        total += g.numel()
        big += int(large.sum())
    if not total:
        return {}
    return {"flip_share": flips / total, "flip_share_larger_half": big_flips / big}


def _leaf_gaps(prog: dict, ref: dict, pv, rv):
    """Each kept leaf's gap between the program's norm ``pv`` and the
    reference's ``rv`` (each in its own side's leaf order) over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; leaves whose reference gradient is under a thousandth of the
    median leaf's are left out."""
    idx = [ref["names"].index(n) for n in prog["names"]]
    rg, r = ref["grad"][idx], rv[idx]
    kept = rg >= 1e-3 * statistics.median(rg)
    return np.abs(pv[kept] - r[kept]) / np.maximum(r[kept], statistics.median(r[kept]))


def compare(prog: dict, ref: dict) -> dict:
    """The readings: the loss gap of the first step and of the worst step;
    the worst leaf's gap and the median leaf's (``<name>_median``) of the
    first gradient, and after each check step k of the change since the
    start (``update_gap_step<k>``), of that step's own change
    (``increment_gap_step<k>``, from the second) and of the norms of
    AdamW's moments (``moment1_gap_step<k>``, ``moment2_gap_step<k>``); the
    last step's go without the suffix: ``update_gap`` is the change over
    all the check steps."""
    loss = np.abs(prog["loss"] - ref["loss"]) / np.abs(ref["loss"])
    out = {"loss_gap_step1": float(loss[0]), "loss_gap": float(loss.max())}
    pairs = {"grad_gap": (prog["grad"], ref["grad"])}
    n = len(ref["change"])
    for key, base in (("change", "update_gap"), ("increment", "increment_gap"),
                      ("moment1", "moment1_gap"), ("moment2", "moment2_gap")):
        for k in range(1 if key == "increment" else 0, n):
            pairs[base if k == n - 1 else f"{base}_step{k + 1}"] = (prog[key][k], ref[key][k])
    for name, (pv, rv) in pairs.items():
        gaps = _leaf_gaps(prog, ref, pv, rv)
        out[name], out[name + "_median"] = float(gaps.max()), float(np.median(gaps))
    return out


@contextlib.contextmanager
def attention_ranges(ctx: core.Ctx):
    """Profiler ranges around every attention core the encoder calls (the
    recomputed ones too) and around every attention backward."""
    from scl_deepfake_audio_detection_torch.models import xlsr
    from scl_deepfake_audio_detection_torch.ops import attention

    fwd, bwd = xlsr.self_attention, attention.flash_attention_backward
    xlsr.self_attention = ctx.rec.wrap(fwd, "self_attention")
    attention.flash_attention_backward = ctx.rec.wrap(bwd, "flash_backward")
    try:
        yield
    finally:
        xlsr.self_attention, attention.flash_attention_backward = fwd, bwd


def control(ctx: core.Ctx, precision: Optional[str] = None, fault: Optional[str] = None) -> dict:
    """The reference put in the program's place, in ``precision`` or with
    half of the anchor groups left out (``fault='half_batch'``), read by the
    same numbers."""
    wav, labels = make_pool(ctx)
    exact = reference_readings(ctx, wav, labels)
    groups = list(range(wav.shape[1] // 2)) if fault == "half_batch" else None
    other = reference_readings(ctx, wav, labels, None if groups else precision, groups)
    return compare(other, exact)
