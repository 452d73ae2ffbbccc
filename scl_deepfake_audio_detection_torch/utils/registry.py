"""Name -> object registries for models, datasets and augmentations.

Counterpart of ``scl_deepfake_audio_detection_tpu/utils/registry.py``: every
pluggable component registers itself under the reference's names and
aliases, so config names resolve uniformly and an unknown name fails with
the list of valid choices.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Iterable, Optional


class Registry:
    """A name -> object registry with a decorator-style ``register``."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

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
        raise KeyError(f"unknown {self.kind} {name!r}; available: {sorted(self._items)}")

    def names(self):
        _populate(self.kind)
        return sorted(self._items)


MODELS = Registry("model")
DATASETS = Registry("dataset")
AUGMENTATIONS = Registry("augmentation")

_POPULATORS = {
    "model": ("scl_deepfake_audio_detection_torch.models.linear_nll",
              "scl_deepfake_audio_detection_torch.models.aasist",
              "scl_deepfake_audio_detection_torch.models.resnet",
              "scl_deepfake_audio_detection_torch.models.btse"),
    "dataset": ("scl_deepfake_audio_detection_torch.data.datasets",),
    "augmentation": ("scl_deepfake_audio_detection_torch.data.augment_registry",),
}


def _populate(kind: str) -> None:
    """Import the modules whose import registers ``kind`` items; their
    import errors propagate."""
    for mod in _POPULATORS[kind]:
        importlib.import_module(mod)


def resolve_augmentation(name: str) -> Callable:
    """An augmentation method by its YAML name.  The reference's
    ``augmentation_methods`` list holds function names looked up in the
    dataset module's globals (``RawBoost12``, ``background_noise_wrapper``,
    ``configs/conf-3-linear.yaml:12``), which stay the registry's keys."""
    return AUGMENTATIONS.get(name)
