"""Pipeline parallelism for stacked layer parameters (GPipe).

Counterpart of ``scl_deepfake_audio_detection_tpu/parallel/pipeline.py``.
Stage s of a 'pipe' process group holds layers [s*L/S, (s+1)*L/S); the
batch streams through the stages in microbatches, each activation sent to
the next stage (all forwards, then all backwards: the GPipe schedule, with
the bubble fraction (S-1)/(M+S-1)).  The JAX package writes it as one SPMD
program under ``shard_map``, ``ppermute`` between stages; here each rank
runs its stage and the activations move by point-to-point ``send`` /
``recv`` inside autograd Functions, whose backward sends the gradient the
other way.  That is chosen over ``torch.distributed.pipelining`` because
the schedule is the JAX one step for step, needs no model split into an
``nn.Module`` per stage, takes any ``layer_fn(activation, layer params)``
as the JAX function does, and runs over gloo on the CPU as over NCCL.

The output is the whole [B, ...] batch on every stage (the JAX version
replicates it with a masked ``psum``); its gradient reaches the stages from
the last stage's loss alone.  Every rank holds the whole ``stacked``
(as the JAX caller passes the unsharded stack); a rank's gradient is
non-zero only at its own layers, and ``x``'s only on stage 0: the sum of
the ranks' gradients is the sequential stack's.  Composing with 'data':
pass the pipe group of a (data, pipe) layout; each data shard runs its own
pipeline, and the data-parallel gradient mean stays the caller's
(``train/optim``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map

from scl_deepfake_audio_detection_torch.parallel.mesh import _all_reduce_

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def _stage_layers(stacked, stage: int, stages: int):
    """[L, ...] leaves -> this stage's L/S layers, one tree each."""
    leaves, _ = tree_flatten(stacked)
    n = leaves[0].shape[0]
    if n % stages:
        raise ValueError(f"layer count {n} not divisible by {stages} stages")
    k = n // stages
    return [tree_map(lambda a: a[i], stacked) for i in range(stage * k, (stage + 1) * k)]


_HEAD = 3 + 8  # (header length, ndim, dtype code, up to 8 sizes)


def _wire(device) -> torch.device:
    """Where a point-to-point message lives: gloo sends host memory."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else torch.device(device)


def _send_tensor(t: torch.Tensor, dst: int, tag: int) -> None:
    """A header with the shape and dtype, then the tensor."""
    if t.dim() > 8:
        raise ValueError("pipeline activations have at most 8 dims")
    head = torch.zeros(_HEAD, dtype=torch.int64)
    head[0], head[1], head[2] = 3 + t.dim(), t.dim(), _DTYPES.index(t.dtype)
    head[3:3 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    wire = _wire(t.device)
    dist.send(head.to(wire), dst, tag=tag)
    dist.send(t.detach().contiguous().to(wire), dst, tag=tag)


def _recv_tensor(src: int, tag: int, device) -> torch.Tensor:
    wire = _wire(device)
    head = torch.zeros(_HEAD, dtype=torch.int64, device=wire)
    dist.recv(head, src, tag=tag)
    head = head.cpu()
    ndim, code = int(head[1]), int(head[2])
    out = torch.empty([int(v) for v in head[3:3 + ndim]], dtype=_DTYPES[code], device=wire)
    dist.recv(out, src, tag=tag)
    return out.to(device)


class _Send(torch.autograd.Function):
    """Sends x to the next stage; returns a 0-d zero that carries the
    dependency, whose backward receives x's gradient from that stage."""

    @staticmethod
    def forward(ctx, x, dst, tag):
        ctx.dst, ctx.tag = dst, tag
        ctx.meta = (x.shape, x.dtype, x.device)
        _send_tensor(x, dst, tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        g = _recv_tensor(ctx.dst, ctx.tag, ctx.meta[2])
        return g.to(ctx.meta[1]).reshape(ctx.meta[0]), None, None


class _Recv(torch.autograd.Function):
    """Receives the previous stage's activation; the backward sends its
    gradient back.  ``anchor`` is a tensor that requires grad, so that the
    received activation joins the graph."""

    @staticmethod
    def forward(ctx, anchor, src, tag, device):
        ctx.src, ctx.tag = src, tag
        return _recv_tensor(src, tag, device)

    @staticmethod
    def backward(ctx, g):
        _send_tensor(g, ctx.src, ctx.tag)
        return None, None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every stage (a masked sum over the group);
    the backward gives the gradient to the last stage only (every stage
    computes the same loss from the same output)."""

    @staticmethod
    def forward(ctx, x, is_last, group):
        ctx.is_last = is_last
        return _all_reduce_(x.clone() if is_last else torch.zeros_like(x), group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_last else torch.zeros_like(g)), None, None


def pipeline_apply(layer_fn: Callable[[torch.Tensor, Any], torch.Tensor], stacked,
                   x: torch.Tensor, group=None, microbatches: Optional[int] = None):
    """``x -> layer_fn(...layer_fn(x, L0)..., L_last)`` as a GPipe pipeline
    over ``group`` (None: every rank; one rank is the plain loop).

    layer_fn: (activation [mb, ...], one layer's parameter tree) -> activation.
    stacked:  a tree of [L, ...] tensors, the whole stack (on every rank).
    x:        [B, ...]; split into ``microbatches`` (default: one a stage).

    Returns [B, ...] on every rank, equal to the sequential stack (the same
    operations on each microbatch)."""
    stages = 1 if group is None and not dist.is_initialized() else dist.get_world_size(group)
    if stages == 1:
        for layer in _stage_layers(stacked, 0, 1):
            x = layer_fn(x, layer)
        return x
    stage = dist.get_rank(group)
    m = microbatches or stages
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    layers = _stage_layers(stacked, stage, stages)
    prev = None if stage == 0 else dist.get_global_rank(group, stage - 1) if group else stage - 1
    nxt = None if stage == stages - 1 else (
        dist.get_global_rank(group, stage + 1) if group else stage + 1)
    anchor = tree_flatten(stacked)[0][0]
    outs, sent = [], []
    for i, xs in enumerate(x.chunk(m)):
        h = xs if prev is None else _Recv.apply(anchor, prev, i, x.device)
        for layer in layers:
            h = layer_fn(h, layer)
        if nxt is None:
            outs.append(h)
        else:
            sent.append(_Send.apply(h, nxt, i))
    is_last = nxt is None
    if is_last:
        y = torch.cat(outs)
    else:  # the output's shape, tied to this stage's sends
        y = torch.zeros((b, *h.shape[1:]), dtype=h.dtype, device=h.device) + torch.stack(sent).sum()
    return _FromLast.apply(y, is_last, group)
