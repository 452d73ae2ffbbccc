"""Name -> object registries for models, datasets and augmentations.

Counterpart of ``scl_deepfake_audio_detection_tpu/utils/registry.py``: every
pluggable component registers itself under the reference's names and
aliases, so config names resolve uniformly and an unknown name fails with
the list of valid choices.  A name the JAX package knows but the port does
not have yet raises "not ported yet" with the slice that brings it.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Iterable, Optional


class Registry:
    """A name -> object registry with a decorator-style ``register``."""

    def __init__(self, kind: str, not_ported: Optional[Dict[str, str]] = None):
        self.kind = kind
        self._items: Dict[str, Any] = {}
        self._not_ported = dict(not_ported or {})  # name -> the slice that ports it

    def register(self, name: Optional[str] = None, *, aliases: Iterable[str] = ()):
        """Decorator: ``@MODELS.register("xlsr_linear_nll")``."""

        def deco(obj: Any) -> Any:
            key = name or getattr(obj, "__name__", None)
            if key is None:
                raise ValueError(f"cannot infer a registry name for {obj!r}")
            for k in (key, *aliases):
                if k in self._items and self._items[k] is not obj:
                    raise KeyError(f"duplicate {self.kind} registration: {k!r}")
                self._items[k] = obj
            return obj

        return deco

    def get(self, name: str) -> Any:
        if name not in self._items:
            _populate(self.kind)  # importing the module registers its items
        if name in self._items:
            return self._items[name]
        if name in self._not_ported:
            raise NotImplementedError(
                f"{self.kind} {name!r} not ported yet ({self._not_ported[name]})")
        raise KeyError(f"unknown {self.kind} {name!r}; available: {sorted(self._items)}")

    def names(self):
        _populate(self.kind)
        return sorted(self._items)


MODELS = Registry("model", not_ported={
    n: "Slice G2" for n in ("xlsr_btse", "wav2vec2_btse")})
DATASETS = Registry("dataset")
AUGMENTATIONS = Registry("augmentation")

_POPULATORS = {
    "model": ("scl_deepfake_audio_detection_torch.models.linear_nll",
              "scl_deepfake_audio_detection_torch.models.aasist",
              "scl_deepfake_audio_detection_torch.models.resnet"),
    "dataset": ("scl_deepfake_audio_detection_torch.data.datasets",),
    "augmentation": ("scl_deepfake_audio_detection_torch.data.augment_registry",),
}


def _populate(kind: str) -> None:
    """Import the modules whose import registers ``kind`` items; their
    import errors propagate."""
    for mod in _POPULATORS[kind]:
        importlib.import_module(mod)
