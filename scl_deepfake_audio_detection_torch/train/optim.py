"""Optimizer and learning-rate policy.

Counterpart of ``scl_deepfake_audio_detection_tpu/train/optim.py``: AdamW
(b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay, which equals optax's
``adamw``) with the learning rate set once per epoch from the reference's
``CyclicLR(mode='exp_range')`` in closed form, behind optax's
``MultiSteps(chain(clip_by_global_norm, adamw))``:

- clipping scales g by min(1, max_norm / ||g||) over all gradients together
  (optax's rule, not ``torch.nn.utils.clip_grad_norm_``, which divides by
  ||g|| + 1e-6);
- with ``grad_accum_steps`` k > 1 the gradients are averaged (Welford, as
  optax) and the update is applied on every k-th call, none in between.

Over a mesh (``parallel/mesh.MeshContext``) the gradients are first
averaged over the data ranks (flat bucketed all-reduces), then accumulated
and clipped by the norm of the whole gradient (a tensor-parallel shard's
squares summed over the model ranks); with ``zero1`` each data rank keeps
the AdamW moments of its slice of every larger leaf (``zero1_spec``),
updates that slice with the same AdamW arithmetic, and the slices are
all-gathered into the parameters.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import torch

from scl_deepfake_audio_detection_torch.parallel.mesh import (
    ZERO1_MIN_SIZE,
    MeshContext,
    zero1_spec,
)


def cyclic_exp_lr(epoch: int, base_lr: float = 1e-8, max_lr: float = 1e-5,
                  step_size: int = 3, gamma: float = 0.85) -> float:
    """``torch.optim.lr_scheduler.CyclicLR`` 'exp_range' value at ``epoch``:
    base + (max - base) * max(0, 1 - |x|) * gamma^epoch over a 2*step_size
    triangular cycle."""
    cycle = math.floor(1 + epoch / (2 * step_size))
    x = abs(epoch / step_size - 2 * cycle + 1)
    return base_lr + (max_lr - base_lr) * max(0.0, 1.0 - x) * (gamma ** epoch)


class Optimizer:
    """AdamW over named parameters with optax's clipping and accumulation.
    ``step()`` consumes the gradients in ``p.grad`` and clears them; a
    parameter without a gradient counts as a zero gradient (optax updates
    every leaf: its moments decay and weight decay still applies)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 weight_decay: float = 1e-4, grad_clip_norm: Optional[float] = None,
                 grad_accum_steps: int = 1, mesh: Optional[MeshContext] = None,
                 tensor_parallel=None, zero1: bool = False,
                 zero1_min_size: int = ZERO1_MIN_SIZE):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.mesh = mesh or MeshContext()
        self.tp = tensor_parallel
        tp_dims = {} if tensor_parallel is None else tensor_parallel.dims
        self.tp_dims = [tp_dims.get(n) for n in self.names]
        # ZeRO-1: the axis of each parameter whose slices the data ranks own
        # (None: every rank updates all of it), and the tensor AdamW updates
        self.zero_axes = [
            zero1_spec(p.shape, self.mesh.dp, d, zero1_min_size,
                       p.numel() * (1 if d is None else self.mesh.tp)) if zero1 else None
            for p, d in zip(self.params, self.tp_dims)]
        self.targets = [p if ax is None else self._slice(p.detach(), ax).clone()
                        .requires_grad_(True) for p, ax in zip(self.params, self.zero_axes)]
        self.adamw = torch.optim.AdamW(self.targets, lr=0.0, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)
        self.grad_clip_norm = grad_clip_norm
        self.accum_steps = max(int(grad_accum_steps), 1)
        self.mini_step = 0
        self.acc = None  # running mean of the gradients of this cycle
        # a resumed JAX train state's PRNG key data, written back on save
        # (train/checkpoint); the port draws nothing from it
        self.rng_key_data = None

    @property
    def lr(self) -> float:
        return self.adamw.param_groups[0]["lr"]

    @property
    def weight_decay(self) -> float:
        return self.adamw.param_groups[0]["weight_decay"]

    def set_hyperparams(self, lr: float, weight_decay: float) -> None:
        for group in self.adamw.param_groups:
            group["lr"], group["weight_decay"] = float(lr), float(weight_decay)

    def _slice(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """This data rank's ZeRO-1 slice of ``t`` on ``axis``."""
        n = t.shape[axis] // self.mesh.dp
        return t.narrow(axis, self.mesh.data_rank * n, n)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        for t in self.targets:
            t.grad = None

    def step(self) -> bool:
        """Apply (or accumulate) the current gradients; True when the
        parameters were updated."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        grads = self.mesh.mean_over_data(grads)
        if self.accum_steps > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.accum_steps:
                self.zero_grad()
                return False
            self.mini_step = 0
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.grad_clip_norm is not None:
            grads = clip_by_global_norm(grads, self.grad_clip_norm, self._norm)
        with torch.no_grad():
            for p, t, g, ax in zip(self.params, self.targets, grads, self.zero_axes):
                if ax is None:
                    p.grad = g
                else:  # this rank's slice, from the parameter as it is now
                    t.copy_(self._slice(p.detach(), ax))
                    t.grad = self._slice(g, ax).contiguous()
            self.adamw.step()
            for p, t, ax in zip(self.params, self.targets, self.zero_axes):
                if ax is not None:
                    p.copy_(self.mesh.gather_data(t, ax))
        self.zero_grad()
        return True

    def _norm(self, grads) -> torch.Tensor:
        """The norm of the whole gradient: the squares of tensor-parallel
        shards summed over the model ranks."""
        if self.tp is None or self.mesh.tp == 1:
            return _global_norm(grads)
        zero = torch.zeros((), device=grads[0].device)
        own = [g for g, d in zip(grads, self.tp_dims) if d is not None]
        rep = [g for g, d in zip(grads, self.tp_dims) if d is None]
        sq = self.mesh.sum_over_model(_global_norm(own) ** 2 if own else zero)
        return torch.sqrt((_global_norm(rep) ** 2 if rep else zero) + sq)

    def _full(self, i: int, t: torch.Tensor, zero: bool = True) -> torch.Tensor:
        """A per-parameter state tensor whole: the ZeRO-1 slices gathered
        over 'data', then the tensor-parallel shards over 'model'."""
        if zero and self.zero_axes[i] is not None:
            t = self.mesh.gather_data(t, self.zero_axes[i])
        if self.tp is not None:
            t = self.tp.full(self.names[i], t)
        return t

    def _local(self, i: int, t: torch.Tensor, zero: bool = True) -> torch.Tensor:
        """Inverse of ``_full``: this rank's part of a whole state tensor."""
        if self.tp is not None:
            t = self.tp.local(self.names[i], t)
        if zero and self.zero_axes[i] is not None:
            t = self._slice(t, self.zero_axes[i])
        return t.clone()

    def state_arrays(self) -> Dict[str, torch.Tensor]:
        """The moments, the step count and the accumulation state, keyed
        ``exp_avg//<name>``, ``exp_avg_sq//<name>``, ``step``, ``mini_step``
        and ``acc//<name>``; whole tensors (over a mesh a collective, which
        every rank calls)."""
        out: Dict[str, torch.Tensor] = {"mini_step": torch.tensor(self.mini_step)}
        step = 0
        for i, (n, t) in enumerate(zip(self.names, self.targets)):
            st = self.adamw.state.get(t)
            if st:
                step = int(st["step"])
                out[f"exp_avg//{n}"] = self._full(i, st["exp_avg"])
                out[f"exp_avg_sq//{n}"] = self._full(i, st["exp_avg_sq"])
        out["step"] = torch.tensor(step)
        if self.acc is not None:
            out.update({f"acc//{n}": self._full(i, a, zero=False)
                        for i, (n, a) in enumerate(zip(self.names, self.acc))})
        return out

    def load_state_arrays(self, arrays: Dict[str, object]) -> None:
        """Inverse of ``state_arrays`` (numpy or tensors)."""
        step = int(arrays["step"])
        self.mini_step = int(arrays.get("mini_step", 0))
        for i, (n, p, t) in enumerate(zip(self.names, self.params, self.targets)):
            if f"exp_avg//{n}" not in arrays:
                continue
            self.adamw.state[t] = {
                "step": torch.tensor(float(step)),
                "exp_avg": self._local(i, torch.as_tensor(
                    arrays[f"exp_avg//{n}"]).to(p.device, p.dtype)),
                "exp_avg_sq": self._local(i, torch.as_tensor(
                    arrays[f"exp_avg_sq//{n}"]).to(p.device, p.dtype)),
            }
        if f"acc//{self.names[0]}" in arrays:
            self.acc = [self._local(i, torch.as_tensor(arrays[f"acc//{n}"]).to(p.device, p.dtype),
                                    zero=False)
                        for i, (n, p) in enumerate(zip(self.names, self.params))]


def _global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def clip_by_global_norm(grads, max_norm: float, norm_fn=_global_norm):
    """optax ``clip_by_global_norm``: g where ||g|| < max_norm, else
    g / ||g|| * max_norm, with ||g|| over all gradients together
    (``norm_fn``).  Stays on the device (no sync)."""
    norm = norm_fn(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm) for g in grads]


def make_optimizer(named_params, weight_decay: float = 1e-4,
                   grad_clip_norm: Optional[float] = None,
                   grad_accum_steps: int = 1, **mesh_kw) -> Optimizer:
    """AdamW at learning rate 0 until ``set_learning_rate``; ``mesh_kw``
    are ``Optimizer``'s mesh arguments."""
    return Optimizer(named_params, weight_decay, grad_clip_norm, grad_accum_steps, **mesh_kw)


def set_learning_rate(opt: Optimizer, lr: float) -> Optimizer:
    for group in opt.adamw.param_groups:
        group["lr"] = float(lr)
    return opt


class EarlyStop:
    """Early stopping on a validation metric (reference ``main.py:23-45``):
    patience 10, delta 0.01, initial best 90.0.  ``mode`` 'max' (accuracy,
    higher is better) or 'min' (dev EER)."""

    def __init__(self, patience: int = 10, delta: float = 0.01,
                 init_best: float = 90.0, mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.patience = patience
        self.delta = delta
        self.best = init_best
        self.mode = mode
        self.counter = 0
        self.early_stop = False

    def is_better(self, score: float, than: float) -> bool:
        """Direction-aware strict improvement beyond delta."""
        if self.mode == "min":
            return score < than - self.delta
        return score > than + self.delta

    def __call__(self, score: float) -> bool:
        """True when ``score`` is a new best (the caller saves)."""
        if self.is_better(score, self.best):
            self.best = score
            self.counter = 0
            return True
        self.counter += 1
        if self.counter >= self.patience:
            self.early_stop = True
        return False
