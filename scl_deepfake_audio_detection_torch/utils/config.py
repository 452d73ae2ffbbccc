"""The part of a YAML experiment config that eval scoring reads.

Same schema as the reference configs (``configs/conf-3-linear.yaml``):
``model:`` names the model and carries its settings, ``data:`` names the
dataset module, which decides the database layout
(``data/datasets.layout``).  The ``train:`` and ``rawboost:`` sections
belong to training and are not read here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import yaml

# reference model names -> registry names
_MODEL_NAMES = {
    "wav2vec2_linear_nll": "xlsr_linear_nll",
    "wav2vec2_aasist": "xlsr_aasist",
    "wav2vec2_resnet": "xlsr_resnet",
    "wav2vec2_resnet_nll": "xlsr_resnet_nll",
    "wav2vec2_btse": "xlsr_btse",
}


@dataclass
class ModelConfig:
    name: str = "xlsr_linear_nll"
    flag_fix_ssl: bool = False
    contra_mode: str = "all"
    loss_type: int = 1


@dataclass
class DataConfig:
    name: str = "eval_only"
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Config:
    model: ModelConfig
    data: DataConfig


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    m = dict(raw.get("model") or {})
    name = m.get("name", ModelConfig.name)
    model = ModelConfig(
        name=_MODEL_NAMES.get(name, name),
        flag_fix_ssl=bool(m.get("flag_fix_ssl", False)),
        contra_mode=m.get("contra_mode", "all"),
        loss_type=int(m.get("loss_type", 1)),
    )
    d = raw.get("data") or {}
    data = DataConfig(name=d.get("name", "eval_only"), kwargs=dict(d.get("kwargs") or {}))
    return Config(model=model, data=data)
