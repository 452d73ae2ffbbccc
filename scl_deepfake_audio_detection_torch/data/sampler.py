"""Samplers: the length-bucketed block shuffle and the length buckets of
bucketed scoring.  The port's copy of
``scl_deepfake_audio_detection_tpu/data/sampler.py`` (NII
``SamplerBlockShuffleByLen``, ``core_scripts/data_io/customize_sampler.py:34``).

Train inputs are fixed-length (``trim_length``), so the buckets serve
variable-length eval scoring (``train/scoring.bucketed_batches``): grouping
utterances of similar length lets each batch pad to its own bucket instead
of one global maximum.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


def block_shuffle_by_length(
    lengths: Sequence[int],
    block_size: int,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """Return item indices: length-sorted, then blocks of ``block_size``
    shuffled as units (NII's f_shuffle_blocks semantics)."""
    rng = rng or np.random.default_rng()
    order = np.argsort(np.asarray(lengths), kind="stable")
    n_blocks = (len(order) + block_size - 1) // block_size
    blocks = [order[i * block_size : (i + 1) * block_size] for i in range(n_blocks)]
    rng.shuffle(blocks)
    return [int(i) for b in blocks for i in b]


def length_buckets(
    lengths: Sequence[int],
    batch_size: int,
    bucket_boundaries: Optional[Sequence[int]] = None,
) -> Iterator[List[int]]:
    """Yield batches of indices grouped by padded length.

    Without explicit boundaries, items are length-sorted and chunked — each
    batch pads to its own max (static per-batch shapes; at most
    ceil(N/batch_size) distinct shapes, typically far fewer after the
    scorer's round-up-to-multiple policy).
    """
    order = np.argsort(np.asarray(lengths), kind="stable")
    if bucket_boundaries is None:
        for i in range(0, len(order), batch_size):
            yield [int(j) for j in order[i : i + batch_size]]
        return
    buckets: dict = {b: [] for b in bucket_boundaries}
    bounds = sorted(bucket_boundaries)
    for idx in order:
        for b in bounds:
            if lengths[idx] <= b:
                buckets[b].append(int(idx))
                break
        else:
            buckets[bounds[-1]].append(int(idx))
    for b in bounds:
        items = buckets[b]
        for i in range(0, len(items), batch_size):
            yield items[i : i + batch_size]
