"""Experiment configuration.

A YAML experiment config in the schema of the reference configs
(``configs/conf-3-linear.yaml``): ``model:`` names the model and carries its
settings, ``data:`` names the dataset (``utils/registry.DATASETS``: the
database layout and the SCL view recipe) and its kwargs, and the optional
``rawboost:`` section sets the RawBoost knobs, which the CLI's flags then
override.  The JAX package's ``train:`` section is not read: the CLI builds
the ``TrainConfig`` from its flags.

``TrainConfig`` is the port's copy of the JAX package's, with the same
fields and defaults; ``train/engine.Engine`` reads it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml

# reference model names -> registry names
_MODEL_NAMES = {
    "wav2vec2_linear_nll": "xlsr_linear_nll",
    "wav2vec2_aasist": "xlsr_aasist",
    "wav2vec2_resnet": "xlsr_resnet",
    "wav2vec2_resnet_nll": "xlsr_resnet_nll",
    "wav2vec2_btse": "xlsr_btse",
}


@dataclass(frozen=True)
class RawBoostConfig:
    """RawBoost DSP knobs, with the names and defaults of the reference CLI
    flags (``main.py:258-298``)."""

    algo: int = 5
    # LnL convolutive noise
    nBands: int = 5
    minF: int = 20
    maxF: int = 8000
    minBW: int = 100
    maxBW: int = 1000
    minCoeff: int = 10
    maxCoeff: int = 100
    minG: int = 0
    maxG: int = 0
    minBiasLinNonLin: int = 5
    maxBiasLinNonLin: int = 20
    N_f: int = 5
    # ISD impulsive noise
    P: int = 10
    g_sd: int = 2
    # SSI additive noise
    SNRmin: int = 10
    SNRmax: int = 40


@dataclass
class ModelConfig:
    """``model:`` section.  Keys other than these four land in ``extra``
    (the ``aasist:`` and ``resnet:`` blocks), as the JAX package keeps them;
    the models' ``from_config`` read their block from there."""

    name: str = "xlsr_linear_nll"
    flag_fix_ssl: bool = False
    contra_mode: str = "all"
    loss_type: int = 1
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DataConfig:
    name: str = "eval_only"
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TrainConfig:
    """Hyperparameters the reference takes on the CLI (``main.py:226-241``).
    ``compute_dtype`` and ``remat`` are read by whoever builds the model
    (the XLS-R config carries them); ``mesh_shape`` beyond one device and
    ``zero1`` are not ported yet (``Engine`` raises)."""

    batch_size: int = 1  # anchor groups per step (each group is V views)
    num_epochs: int = 100
    start_epoch: int = 0
    min_lr: float = 1e-8
    max_lr: float = 1e-5
    weight_decay: float = 1e-4
    loss: str = "weighted_CCE"  # only used in the output dir tag
    padding_type: str = "zero"  # 'zero' or 'repeat'
    seed: int = 1234
    comment: Optional[str] = None
    compute_dtype: str = "bfloat16"  # matmul dtype; layer norm and softmax stay fp32
    remat: bool = True  # recompute encoder layers in the backward
    mesh_shape: Optional[List[int]] = None  # (data, model); None = one device here
    loss_scope: str = "group"  # 'group': SupCon per anchor group; 'global': one batch
    grad_clip_norm: Optional[float] = None  # optax clip_by_global_norm
    grad_accum_steps: int = 1  # optax MultiSteps
    zero1: bool = False
    zero1_min_size: int = 1 << 16
    check_numerics: bool = False  # per-step host check for non-finite metrics
    ckpt_every: int = 1  # save last.ckpt every N epochs (plus best and final)
    async_ckpt: bool = True  # write checkpoints on a background thread
    early_metric: str = "acc"  # 'acc' (dev accuracy) or 'eer' (dev EER)
    es_patience: int = 10
    es_delta: float = 0.01

    def model_tag(self) -> str:
        """model_{loss}_{epochs}_{bs}_{minlr}[_{comment}] (reference
        ``main.py:310-313``)."""
        tag = f"model_{self.loss}_{self.num_epochs}_{self.batch_size}_{self.min_lr}"
        if self.comment:
            tag += f"_{self.comment}"
        return tag


@dataclass
class Config:
    model: ModelConfig
    data: DataConfig
    rawboost: RawBoostConfig = field(default_factory=RawBoostConfig)


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
        extra={k: v for k, v in m.items()
               if k not in ("name", "flag_fix_ssl", "contra_mode", "loss_type")},
    )
    d = raw.get("data") or {}
    data = DataConfig(name=d.get("name", "eval_only"), kwargs=dict(d.get("kwargs") or {}))
    rawboost = RawBoostConfig()
    if "rawboost" in raw:  # the port's own schema: an unknown key is a typo
        entries = raw["rawboost"] or {}
        known = {f.name for f in dataclasses.fields(RawBoostConfig)}
        unknown = sorted(set(entries) - known)
        if unknown:
            raise ValueError(f"unknown rawboost: config keys {unknown}; "
                             f"valid keys: {sorted(known)}")
        rawboost = RawBoostConfig(**entries)
    return Config(model=model, data=data, rawboost=rawboost)
