"""Training and eval engine.

Counterpart of ``scl_deepfake_audio_detection_tpu/train/engine.py``.  A step
takes a super-batch of G anchor groups ``{"wav": [G, V, T], "labels": [G,
V]}``, runs one forward over all G*V views, computes the loss per group (the
reference's loss unit; the JAX package ``vmap``s it) or over the whole batch,
and takes one AdamW step.  Per-step metrics stay on the device;
``MetricMean.result()`` is the one host sync per epoch.  ``fit`` drives
epochs as the reference does (``main.py:397-423``): per-epoch cyclic LR,
early stop on dev accuracy (or dev EER), checkpoints on a new best.

The engine owns the model's parameters, its batch-norm statistics and the
optimizer state, on the device the model was built on (the card unless the
caller asked for the CPU).  A train step's one forward over the G*V views
normalises with their statistics and moves the running ones once (the JAX
package's sync-BN); eval and scoring read them and leave them.  Dropout
draws come from a ``torch.Generator`` seeded from (``cfg.seed``, epoch,
step), so a run is reproducible on one device type.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from scl_deepfake_audio_detection_torch.models.base import ModelOutput, eval_scores
from scl_deepfake_audio_detection_torch.models.params import load_jax_params
from scl_deepfake_audio_detection_torch.ops.layers import dewire_pcm16
from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
from scl_deepfake_audio_detection_torch.train.metrics import compute_eer
from scl_deepfake_audio_detection_torch.train.optim import (
    EarlyStop,
    cyclic_exp_lr,
    make_optimizer,
    set_learning_rate,
)
from scl_deepfake_audio_detection_torch.train.tblog import ScalarWriter, trace_epoch
from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

Batch = Dict[str, Any]


def score_step(model: nn.Module, wav) -> torch.Tensor:
    """wav [B, T] (numpy or tensor; fp32, or int16 PCM wire) -> the eval
    score columns [B, 2] on the model's device.  The result is not copied
    to the host, so the caller can keep the next batch in flight."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        wav = torch.as_tensor(wav).to(device, non_blocking=True)
        return eval_scores(model, model.apply(dewire_pcm16(wav), train=False))


class MetricMean:
    """Streaming mean of per-step metric dicts of device scalars; the sums
    stay on the device and ``result()`` reads them back in one copy."""

    def __init__(self) -> None:
        self._agg: Dict[str, torch.Tensor] = {}
        self._n = 0

    def add(self, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            v = torch.as_tensor(v).detach().float()
            self._agg[k] = v if k not in self._agg else self._agg[k] + v
        self._n += 1

    def result(self) -> Dict[str, float]:
        if not self._agg:
            return {}
        vals = torch.stack(list(self._agg.values())).cpu().tolist()
        return {k: v / max(self._n, 1) for k, v in zip(self._agg, vals)}


def _group(out: ModelOutput, g: int, v: int, i: int) -> ModelOutput:
    """Group i of an output over G*V views."""
    return ModelOutput(*(None if x is None else x.reshape(g, v, *x.shape[1:])[i]
                         for x in out))


def _loss_and_metrics(model, batch: Batch, train: bool, loss_scope: str,
                      generator: Optional[torch.Generator] = None,
                      dropout_masks=None):
    """-> (total loss, metrics, model output)."""
    wav, labels = batch["wav"], batch["labels"]
    g, v = wav.shape[0], wav.shape[1]
    out = model.apply(wav.reshape(g * v, -1), train=train, generator=generator,
                      dropout_masks=dropout_masks)
    if loss_scope == "global":
        terms = model.loss(out, labels.reshape(-1))
    else:  # per anchor group, then the mean over groups
        per = [model.loss(_group(out, g, v, i), labels[i]) for i in range(g)]
        terms = {k: torch.stack([p[k] for p in per]).mean() for k in per[0]}
    total = sum(terms.values())
    pred = out.log_probs.argmax(dim=-1)
    acc = (pred == labels.reshape(-1).to(pred.dtype)).float().mean()
    return total, {"loss": total, "accuracy": acc, **terms}, out


def _dev_eer_pct(scores: np.ndarray, labels: np.ndarray) -> float:
    """Dev EER in percent from per-view bonafide scores (label 1 bonafide,
    0 spoof); NaN when a class is absent."""
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores).reshape(-1)
    tgt, non = scores[labels == 1], scores[labels == 0]
    if tgt.size == 0 or non.size == 0:
        return float("nan")
    return compute_eer(tgt, non)[0] * 100.0


def step_seed(seed: int, epoch: int, step: int) -> int:
    """A well-mixed 64-bit seed for one step's dropout draws."""
    return int(np.random.SeedSequence([seed, epoch, step]).generate_state(1, np.uint64)[0])


def step_generator(seed: int, epoch: int, step: int, device) -> torch.Generator:
    """The generator of one step's dropout draws on ``device``."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, epoch, step))


def place_batch(batch: Batch, device) -> Batch:
    """The numeric fields on the device; metadata (utt ids) stays out."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}


class Engine:
    """Owns the model, its optimizer and the epoch loop."""

    def __init__(self, model: nn.Module, train_cfg: Optional[TrainConfig] = None):
        self.cfg = cfg = train_cfg or TrainConfig()
        if cfg.mesh_shape is not None and int(np.prod(cfg.mesh_shape)) != 1:
            raise NotImplementedError(f"mesh_shape={cfg.mesh_shape} not ported yet "
                                      "(the port trains on one device)")
        if cfg.zero1:
            raise NotImplementedError("zero1=True not ported yet")
        if cfg.loss_scope not in ("group", "global"):
            raise ValueError(f"loss_scope must be 'group' or 'global', got {cfg.loss_scope!r}")
        self.model = model
        self.device = next(model.parameters()).device
        self.optimizer = None

    # ----------------------------------------------------------- state setup
    def init_state(self, params=None, buffers=None):
        """Optionally load a JAX parameter tree (numpy leaves), and its
        batch-norm buffers tree, into the model and make the optimizer
        (learning rate 0 until ``set_learning_rate``).  Returns (model,
        optimizer)."""
        if params is not None:
            load_jax_params(self.model, params, buffers)
        self.optimizer = make_optimizer(
            self.model.named_parameters(), self.cfg.weight_decay,
            grad_clip_norm=self.cfg.grad_clip_norm,
            grad_accum_steps=self.cfg.grad_accum_steps)
        return self.model, self.optimizer

    def place_batch(self, batch: Batch) -> Batch:
        return place_batch(batch, self.device)

    def step_generator(self, epoch: int, step: int) -> torch.Generator:
        return step_generator(self.cfg.seed, epoch, step, self.device)

    # ----------------------------------------------------------------- steps
    def train_step(self, batch: Batch, generator: torch.Generator,
                   dropout_masks=None) -> Dict[str, torch.Tensor]:
        """Forward, backward and one optimizer call on a placed batch.  The
        dropout draws come from ``generator`` (``step_generator``), as the
        JAX step's from its key; ``dropout_masks`` replaces the head's draws.
        Returns the step's metrics as device scalars (of the forward before
        the update)."""
        total, metrics, _ = _loss_and_metrics(
            self.model, batch, True, self.cfg.loss_scope, generator, dropout_masks)
        total.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    def eval_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            return _loss_and_metrics(self.model, batch, False, self.cfg.loss_scope)[1]

    def eval_step_scored(self, batch: Batch):
        """Eval step that also returns the per-view bonafide score column and
        the labels (``--early_metric eer``)."""
        with torch.inference_mode():
            _, metrics, out = _loss_and_metrics(self.model, batch, False,
                                                self.cfg.loss_scope)
            cols = eval_scores(self.model, out)
            score = cols[:, 1] if cols.dim() == 2 else cols.reshape(-1)
            return metrics, score.float(), batch["labels"].reshape(-1)

    def score_step(self, wav) -> torch.Tensor:
        return score_step(self.model, wav)

    # ---------------------------------------------------------------- epochs
    def run_epoch(self, batches: Iterable[Batch], epoch: int = 0) -> Dict[str, float]:
        """One training epoch over {'wav': [G, V, T], 'labels': [G, V]}
        batches; the metric means come back to the host once, at the end."""
        agg = MetricMean()
        for i, batch in enumerate(batches):
            metrics = self.train_step(self.place_batch(batch),
                                      self.step_generator(epoch, i))
            agg.add(metrics)
            if self.cfg.check_numerics:
                bad = {k: float(v) for k, v in metrics.items()
                       if not np.isfinite(float(v))}
                if bad:
                    raise FloatingPointError(f"non-finite metrics at step {i}: {bad} "
                                             f"(utts={batch.get('utts')})")
        return agg.result()

    def run_validation(self, batches: Iterable[Batch], collect_scores: bool = False):
        """Dev pass -> metrics, or with ``collect_scores`` (metrics, scores,
        labels) as host arrays."""
        agg = MetricMean()
        scores, labels = [], []
        for batch in batches:
            placed = self.place_batch(batch)
            if collect_scores:
                m, s, l = self.eval_step_scored(placed)
                scores.append(s)
                labels.append(l)
            else:
                m = self.eval_step(placed)
            agg.add(m)
        if not collect_scores:
            return agg.result()
        s = torch.cat(scores).cpu().numpy() if scores else np.zeros(0, np.float32)
        l = torch.cat(labels).float().cpu().numpy() if labels else np.zeros(0, np.float32)
        return agg.result(), s, l

    def fit(self, train_batches: Callable[[], Iterable[Batch]],
            dev_batches: Callable[[], Iterable[Batch]],
            save_dir: Optional[str] = None,
            log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
            tensorboard_dir: Optional[str] = None, profile_dir: Optional[str] = None,
            resume_best: Optional[float] = None,
            resume_counter: Optional[int] = None) -> List[Dict[str, Any]]:
        """Training run: per-epoch cyclic LR, early stop on dev accuracy (or
        dev EER with ``cfg.early_metric='eer'``), ``last.ckpt`` every
        ``ckpt_every`` epochs and at the last or early-stop epoch,
        ``epoch_{n}.ckpt`` on each new best, one ``metrics.jsonl`` line per
        epoch, the same record as tensorboard scalars under
        ``tensorboard_dir`` (when tensorboard imports), and a
        ``torch.profiler`` trace of the first epoch under ``profile_dir``.
        Returns the epoch records."""
        if self.optimizer is None:
            self.init_state()
        cfg = self.cfg
        es_metric = cfg.early_metric
        es_kw = dict(patience=int(cfg.es_patience), delta=float(cfg.es_delta))
        # dev EER in percent, lower is better; init 100 lets the first
        # measured epoch set the watermark
        stopper = (EarlyStop(init_best=100.0, mode="min", **es_kw) if es_metric == "eer"
                   else EarlyStop(**es_kw))
        if resume_best is not None and stopper.is_better(float(resume_best), stopper.best):
            stopper.best = float(resume_best)  # direction-aware watermark restore
        if resume_counter:
            # resume stops at exactly the epoch an uninterrupted run would
            stopper.counter = max(int(resume_counter), 0)
            if stopper.counter >= stopper.patience:
                stopper.early_stop = True
                print("resume: EarlyStop patience already exhausted at save "
                      "time; nothing to train")
        ckpt_every = max(int(cfg.ckpt_every), 1)
        writer = ckpt.AsyncWriter() if cfg.async_ckpt else None
        last_epoch = cfg.start_epoch + cfg.num_epochs - 1
        metrics_path = os.path.join(save_dir, "metrics.jsonl") if save_dir else None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        tb = ScalarWriter(tensorboard_dir)

        def save(name: str, epoch: int) -> None:
            ckpt.save_train_state(os.path.join(save_dir, name), self.model,
                                  self.optimizer, epoch, cfg.seed, stopper.best,
                                  writer=writer, es_counter=stopper.counter,
                                  es_metric=es_metric)

        records = []
        for epoch in range(cfg.start_epoch, cfg.start_epoch + cfg.num_epochs):
            if stopper.early_stop:  # patience exhausted before this run
                break
            lr = cyclic_exp_lr(epoch, cfg.min_lr, cfg.max_lr)
            set_learning_rate(self.optimizer, lr)
            t0 = time.time()
            with trace_epoch(profile_dir if epoch == cfg.start_epoch else None):
                train_m = self.run_epoch(train_batches(), epoch)
            val_eer = None
            if es_metric == "eer":
                val_m, dev_scores, dev_labels = self.run_validation(
                    dev_batches(), collect_scores=True)
                val_eer = _dev_eer_pct(dev_scores, dev_labels)
            else:
                val_m = self.run_validation(dev_batches())
            record = {"epoch": epoch, "lr": lr, "seconds": time.time() - t0,
                      **{f"train_{k}": v for k, v in train_m.items()},
                      **{f"val_{k}": v for k, v in val_m.items()}}
            if val_eer is not None:
                # a single-class dev set has no EER: JSON null, not NaN
                record["val_eer"] = val_eer if np.isfinite(val_eer) else None
            records.append(record)
            if metrics_path:
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            tb.scalars(record, epoch)
            if log_fn:
                log_fn(epoch, record)

            if es_metric == "eer":
                is_best = stopper(val_eer) if np.isfinite(val_eer) else False
            elif val_m:
                is_best = stopper(val_m.get("accuracy", 0.0) * 100.0)
            else:  # no dev batches: no signal, never stop or crown a best on it
                is_best = False
            if save_dir:
                if ((epoch - cfg.start_epoch) % ckpt_every == ckpt_every - 1
                        or epoch == last_epoch or stopper.early_stop):
                    save("last.ckpt", epoch)
                if is_best:
                    save(f"epoch_{epoch}.ckpt", epoch)
            if stopper.early_stop:
                break
        if writer is not None:
            writer.wait()
        tb.close()
        return records
