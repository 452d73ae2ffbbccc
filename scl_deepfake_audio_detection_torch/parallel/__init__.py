"""Multi-rank training and scoring over ``torch.distributed``: the
('data', 'model') mesh and its sharding rules (``mesh``), the per-card
memory estimate (``memory``), a GPipe schedule (``pipeline``) and a
one-step multi-rank dry run (``dryrun``).

Counterpart of ``scl_deepfake_audio_detection_tpu/parallel``; its names
where the port has a counterpart."""

from scl_deepfake_audio_detection_torch.parallel.dryrun import dryrun_multichip
from scl_deepfake_audio_detection_torch.parallel.memory import estimate_train_memory
from scl_deepfake_audio_detection_torch.parallel.mesh import (
    MeshContext,
    gather_params,
    make_mesh,
    param_pspecs,
    shard_batch,
    shard_params,
    zero1_spec,
)
from scl_deepfake_audio_detection_torch.parallel.pipeline import pipeline_apply

__all__ = [
    "MeshContext",
    "dryrun_multichip",
    "estimate_train_memory",
    "gather_params",
    "make_mesh",
    "param_pspecs",
    "pipeline_apply",
    "shard_batch",
    "shard_params",
    "zero1_spec",
]
