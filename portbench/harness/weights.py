"""Seeded weights, made on the device in a few large calls.

One ``torch.rand`` over every element of the reference's parameter spec,
then one affine map whose scale and offset are set per leaf by its rule:

- ``fan_in``: uniform in +-1/sqrt(fan in), fan in = the product of the
  shape past the first axis; ``fan_in:<weight>`` takes that weight's;
- ``xavier``: uniform in +-sqrt(6 / (rows + cols));
- ``unit``: uniform in +-sqrt(3) (unit variance);
- ``one``, ``zero``: constants (norm scales and shifts, batch-norm
  statistics).

A configuration's ``init_scale`` ({name prefix: factor}) narrows the draw
of the leaves under a prefix.

The same (spec, seed, device type) gives the same values, so the reference
makes them again after the program's state is freed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch


def _bound(rule: str, shape: Tuple[int, ...], shapes: Dict[str, Tuple[int, ...]]) -> Tuple[float, float]:
    """(half-width, centre) of a leaf's uniform draw."""
    if rule == "one":
        return 0.0, 1.0
    if rule == "zero":
        return 0.0, 0.0
    if rule == "unit":
        return math.sqrt(3.0), 0.0
    if rule == "xavier":
        return math.sqrt(6.0 / (shape[0] + shape[1])), 0.0
    if rule.startswith("fan_in"):
        ref = shapes[rule.split(":", 1)[1]] if ":" in rule else shape
        return 1.0 / math.sqrt(math.prod(ref[1:])), 0.0
    raise ValueError(f"unknown init rule {rule!r}")


def make(spec: List[Tuple[str, Tuple[int, ...], str]], seed: int, device,
         scale: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """name -> fp32 tensor on ``device``, views of one buffer."""
    device = torch.device(device)
    shapes = {n: tuple(s) for n, s, _ in spec}
    counts = [math.prod(s) for _, s, _ in spec]
    total = sum(counts)
    halves, centres = zip(*(_bound(r, tuple(s), shapes) for _, s, r in spec))
    factor = [next((f for p, f in (scale or {}).items() if n.startswith(p)), 1.0)
              for n, _, _ in spec]
    halves = [h * f for h, f in zip(halves, factor)]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device)
    reps = torch.tensor(counts, device=device)
    half = torch.repeat_interleave(torch.tensor(halves, device=device), reps, output_size=total)
    centre = torch.repeat_interleave(torch.tensor(centres, device=device), reps,
                                     output_size=total)
    flat = (u * 2.0 - 1.0) * half + centre
    return {n: t.view(s) for (n, s, _), t in zip(spec, flat.split(counts))}


def load_into(model: torch.nn.Module, values: Dict[str, torch.Tensor]) -> None:
    """Copy ``values`` into the model's parameters and buffers, which must
    be exactly the spec's names and shapes."""
    own = dict(model.named_parameters())
    own.update(dict(model.named_buffers()))
    if set(own) != set(values):
        missing, extra = sorted(set(own) - set(values)), sorted(set(values) - set(own))
        raise ValueError(f"the reference spec does not match the model: missing {missing[:5]}, "
                         f"extra {extra[:5]}")
    names = sorted(own)
    for n in names:
        if tuple(own[n].shape) != tuple(values[n].shape):
            raise ValueError(f"{n}: model {tuple(own[n].shape)} vs spec {tuple(values[n].shape)}")
    with torch.no_grad():
        torch._foreach_copy_([own[n].data for n in names], [values[n] for n in names])
