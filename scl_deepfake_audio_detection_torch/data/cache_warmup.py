"""Offline-augmentation cache warm-up (``--warm_cache``).

Counterpart of ``scl_deepfake_audio_detection_tpu/data/cache_warmup.py``.
The reference fills ``aug_dir/<method>/<utt>`` lazily during the first
epoch; this fills the same cache ahead of time on a thread pool, for
exactly the (file, method) pairs each dataset variant can ask for:

  augall_3 / augall_5   bonafide x all methods; vocoded x methods[0]
  aug_2                 bonafide x all methods; vocoded x all methods
  xinwang               bonafide x all methods; vocoded x all methods
  scl_normal            bonafide x all methods; spoof x all methods

The jobs run through the registry's cached wrappers
(``data/augment_registry._cached``), so training reads a warmed cache as it
reads a lazily grown one.  Each job draws from ``SeedSequence([seed,
job_idx])`` over the sorted job list, so a warmed entry is another
deterministic stream than a lazily grown one, as in the JAX package.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from scl_deepfake_audio_detection_torch.data.datasets import SCLViewBatchBuilder
from scl_deepfake_audio_detection_torch.utils.audio_io import load_audio
from scl_deepfake_audio_detection_torch.utils.registry import AUGMENTATIONS


@dataclass
class WarmupStats:
    total: int = 0
    written: int = 0
    existing: int = 0
    failed: int = 0
    seconds: float = 0.0

    def __str__(self) -> str:
        return (f"{self.total} cache entries: {self.written} written, "
                f"{self.existing} already present, {self.failed} failed "
                f"({self.seconds:.1f}s)")


def enumerate_cache_jobs(builder: SCLViewBatchBuilder) -> List[Tuple[str, str]]:
    """Every (audio_path, method) pair the builder's variant can ask for."""
    spec = builder.spec
    # only methods with an offline cache: a job for any other would
    # recompute on every run and write nothing
    methods = [m for m in spec.augmentation_methods
               if getattr(AUGMENTATIONS.get(m), "cache_method", None) is not None]
    jobs: List[Tuple[str, str]] = []
    for u in builder.files:  # anchors and additional reals share the list
        p = os.path.join(builder.bonafide_dir, u)
        jobs += [(p, m) for m in methods]

    if spec.variant in ("augall_3", "augall_5"):
        voc_methods = methods[:1]  # the first method only
    elif spec.variant in ("aug_2", "xinwang"):
        voc_methods = methods
    else:  # scl_normal has no vocoded views
        voc_methods = []
    for u in builder.files if voc_methods else ():
        for v in spec.vocoders:
            p = os.path.join(builder.vocoded_dir, f"{v}_{u}")
            jobs += [(p, m) for m in voc_methods]

    if spec.variant == "scl_normal":  # spoof views take a random method
        for d, f in builder.spoof_list:
            jobs += [(os.path.join(d, f), m) for m in methods]
    return sorted(set(jobs))


def warm_aug_cache(builder: SCLViewBatchBuilder, num_workers: int = 8,
                   seed: Optional[int] = None, verbose: bool = False) -> WarmupStats:
    """Fill the offline augmentation cache of one builder.  Deterministic
    given ``seed`` (the builder's by default); entries already there stay
    untouched, so a rerun or a partly grown cache is safe."""
    res = builder.res
    if res.online or not res.aug_dir:
        raise ValueError("cache warm-up needs offline resources (online_aug: false and an "
                         "aug_dir in the config's data kwargs)")
    jobs = enumerate_cache_jobs(builder)
    seed = builder.seed if seed is None else seed
    stats = WarmupStats(total=len(jobs))
    t0 = time.perf_counter()

    def run(job_idx: int) -> str:
        path, method = jobs[job_idx]
        fn = AUGMENTATIONS.get(method)
        if os.path.exists(os.path.join(res.aug_dir, fn.__name__, os.path.basename(path))):
            return "existing"
        try:
            wav = load_audio(path, res.sample_rate)
            rng = np.random.default_rng(np.random.SeedSequence([seed, job_idx]))
            fn(wav, rng, res, utt_id=path)  # the full path: the collision guard
            return "written"
        except Exception as e:  # noqa: BLE001 -- one bad file must not stop the pool
            if verbose:
                print(f"warm_aug_cache: {method}({path}) failed: {e}")
            return "failed"

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for outcome in pool.map(run, range(len(jobs))):
            setattr(stats, outcome, getattr(stats, outcome) + 1)
    stats.seconds = time.perf_counter() - t0
    return stats
