"""Seeded parameters for the zoo's tiny goldens, the same on every machine.

``seeded_tree(model, seed)`` is a JAX-layout parameter tree for a port
model drawn from numpy's default generator, where a ``torch.Generator``
init differs by device type.  The goldens under ``tests/golden/`` hold only
buffers and scores; their parameters are ``seeded_tree(model,
meta["param_seed"])``.  Used by the tests and by ``chip_smoke.py``."""

from typing import Iterator, Tuple

import numpy as np

from scl_deepfake_audio_detection_torch.models.params import is_stacked, to_jax
from scl_deepfake_audio_detection_torch.utils.tree import SEP, unflatten


def seeded_tree(model, seed: int):
    """Kernels ``w`` uniform in +-1/sqrt(fan_in), ``b`` and ``bias`` leaves
    in +-0.1, ``scale`` in [0.5, 1.5], every other leaf standard normal;
    the leaves drawn in ``jax.tree_util`` order.  Only the model's shapes
    are read, so a model on ``meta`` will do."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, shape in _shapes(to_jax(model, host=False)):
        key, leaf = SEP.join(path), path[-1]
        if leaf == "w":
            fan_in = int(np.prod(shape[1:-1] if is_stacked(key) else shape[:-1]))
            bound = 1.0 / np.sqrt(fan_in)
            arr = rng.uniform(-bound, bound, shape)
        elif leaf in ("b", "bias"):
            arr = rng.uniform(-0.1, 0.1, shape)
        elif leaf == "scale":
            arr = rng.uniform(0.5, 1.5, shape)
        else:
            arr = rng.standard_normal(shape)
        flat[key] = arr.astype(np.float32)
    return unflatten(flat)


def _shapes(tree, path=()) -> Iterator[Tuple[tuple, tuple]]:
    """(path, shape) of every leaf, in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _shapes(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _shapes(v, path + (str(i),))
    else:
        yield path, tuple(int(d) for d in tree.shape)
