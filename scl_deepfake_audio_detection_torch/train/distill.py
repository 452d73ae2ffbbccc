"""Teacher-student distillation trainer.

Counterpart of ``scl_deepfake_audio_detection_tpu/train/distill.py``:
compress the 315M XLS-R + head countermeasure into a small student (by
default ``XLSRConfig.student_base``, 12 x 768) for serving, where the eval
path's throughput scales inversely with the student's FLOPs.

One step runs the frozen teacher's forward (eval mode, no gradient), the
student's training forward, and one update of the student:

    alpha * CE(student, labels) + (1 - alpha) * KLD(teacher -> student)
      [+ emb_loss_weight * (1 - cos(student emb, teacher emb))]

The models return log-softmax outputs; feeding them to the temperature KLD
is exact, since ``log_softmax(log_probs / T) == log_softmax(logits / T)``.
It runs on one device: the teacher's parameters are frozen
(``requires_grad`` False) and never change, the student's go through the
port's ``train/optim`` AdamW, at learning rate 0 until the caller sets one
(``set_learning_rate``).  A student with batch-norm buffers is refused, as
in the JAX package: its running statistics would need the ``Engine``'s
state handling.  ``DistillConfig`` has no ``grad_clip_norm``: no caller of
the JAX one sets it (its CLI does not forward ``--grad_clip_norm``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models.base import model_buffers
from scl_deepfake_audio_detection_torch.models.params import load_jax_params
from scl_deepfake_audio_detection_torch.ops.losses import kld_distill
from scl_deepfake_audio_detection_torch.train.engine import (
    Batch,
    MetricMean,
    place_batch,
    step_generator,
)
from scl_deepfake_audio_detection_torch.train.optim import make_optimizer


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    temperature: float = 20.0  # reference kld default (loss_metrics.py:263)
    alpha: float = 0.5  # CE weight; (1 - alpha) weighs the KLD
    emb_loss_weight: float = 0.0  # cosine embedding match (0 = off)
    weight_decay: float = 1e-4


def _cosine_emb_loss(emb_s: torch.Tensor, emb_t: torch.Tensor) -> torch.Tensor:
    """1 - mean cosine similarity between student and teacher embeddings."""
    s = emb_s / torch.clamp(torch.linalg.vector_norm(emb_s, dim=-1, keepdim=True), min=1e-8)
    t = emb_t / torch.clamp(torch.linalg.vector_norm(emb_t, dim=-1, keepdim=True), min=1e-8)
    return 1.0 - torch.mean(torch.sum(s * t, dim=-1))


def _distill_loss(student: nn.Module, teacher: nn.Module, batch: Batch, cfg: DistillConfig,
                  generator: Optional[torch.Generator] = None, dropout_masks=None):
    """-> (total loss, metrics).  ``batch`` holds ``wav`` [N, T] or [G, V, T]
    (flattened to G*V views, as the engine does) and ``labels``; the
    student's dropout draws from ``generator``, or takes ``dropout_masks``."""
    wav = batch["wav"]
    labels = batch["labels"].reshape(-1).long()
    if wav.dim() == 3:
        wav = wav.reshape(-1, wav.shape[-1])
    with torch.no_grad():
        t_out = teacher.apply(wav, train=False)
    t_logp = t_out.log_probs
    s_out = student.apply(wav, train=True, generator=generator, dropout_masks=dropout_masks)

    ce = -s_out.log_probs.gather(1, labels[:, None]).mean()
    kld = kld_distill(s_out.log_probs, t_logp, temp=cfg.temperature)
    total = cfg.alpha * ce + (1.0 - cfg.alpha) * kld
    metrics = {"loss_ce": ce, "loss_kld": kld}
    if cfg.emb_loss_weight > 0.0:
        emb_l = _cosine_emb_loss(s_out.emb, t_out.emb)
        total = total + cfg.emb_loss_weight * emb_l
        metrics["loss_emb"] = emb_l

    pred = s_out.log_probs.argmax(dim=-1)
    metrics.update(
        loss=total,
        accuracy=(pred == labels).float().mean(),
        teacher_agreement=(pred == t_logp.argmax(dim=-1)).float().mean(),
    )
    return total, metrics


def _distill_step(student: nn.Module, teacher: nn.Module, optimizer, batch: Batch,
                  cfg: DistillConfig, generator: Optional[torch.Generator] = None,
                  dropout_masks=None) -> Dict[str, torch.Tensor]:
    """One update of the student; its metrics (of the forward before the
    update) as device scalars."""
    total, metrics = _distill_loss(student, teacher, batch, cfg, generator, dropout_masks)
    total.backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


class DistillEngine:
    """Owns the frozen teacher, the student, the student's optimizer and the
    epoch loop.  The student is any registered model without batch-norm
    buffers; the teacher is typically the full XLS-R + head loaded from a
    checkpoint.  The student's dropout draws come from a generator seeded
    from (``seed``, epoch, step), as ``Engine``'s."""

    def __init__(self, teacher: nn.Module, student: nn.Module,
                 cfg: Optional[DistillConfig] = None, seed: int = 0):
        self.teacher = teacher
        self.student = student
        self.cfg = cfg or DistillConfig()
        if not (0.0 <= self.cfg.alpha <= 1.0):
            raise ValueError(f"alpha must be in [0, 1], got {self.cfg.alpha}")
        if model_buffers(student):
            # a BN student needs its running statistics threaded through the
            # step (Engine's semantics); distil to a stateless head instead
            raise ValueError(
                "DistillEngine supports stateless students only; "
                f"{type(student).__name__} carries BN buffers"
            )
        self.seed = seed
        self.device = next(student.parameters()).device
        self.optimizer = None

    def init_state(self, teacher_params=None, student_params=None, teacher_buffers=None):
        """Optionally load JAX parameter trees (numpy leaves) into the
        teacher (with a BN teacher's ``teacher_buffers``; their initial
        values without) and the student, freeze the teacher, and make the
        student's optimizer.  Returns (student, optimizer)."""
        if teacher_params is not None:
            load_jax_params(self.teacher, teacher_params, teacher_buffers or None)
        if student_params is not None:
            load_jax_params(self.student, student_params)
        self.teacher.eval().requires_grad_(False)
        self.optimizer = make_optimizer(self.student.named_parameters(), self.cfg.weight_decay)
        return self.student, self.optimizer

    def place_batch(self, batch: Batch) -> Batch:
        return place_batch(batch, self.device)

    def step_generator(self, epoch: int, step: int) -> torch.Generator:
        return step_generator(self.seed, epoch, step, self.device)

    def step(self, batch: Batch, generator: Optional[torch.Generator] = None,
             dropout_masks=None) -> Dict[str, torch.Tensor]:
        """One distillation step on a placed batch."""
        return _distill_step(self.student, self.teacher, self.optimizer, batch, self.cfg,
                             generator, dropout_masks)

    def run_epoch(self, batches: Iterable[Batch], epoch: int = 0) -> Dict[str, float]:
        """One pass over {'wav': [N, T] or [G, V, T], 'labels'} batches; the
        metric means come back to the host once, at the end."""
        if self.optimizer is None:
            self.init_state()
        agg = MetricMean()
        for i, batch in enumerate(batches):
            agg.add(self.step(self.place_batch(batch), self.step_generator(epoch, i)))
        return agg.result()
