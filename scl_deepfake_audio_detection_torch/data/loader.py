"""Host data pipeline: batches built ahead of the device in a producer
thread.

Counterpart of ``TrainLoader``, ``DeviceAugTrainLoader`` and ``EvalLoader`` in
``scl_deepfake_audio_detection_tpu/data/loader.py``.  Items (audio IO and
DSP; numpy releases the GIL) are built in a thread pool and assembled in
index order, ``prefetch`` batches ahead of the consumer.  Batches stay
numpy; ``Engine.place_batch`` moves them to the card.  A worker's error is
raised in the consumer, and a consumer that leaves early stops the
producer.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator

import numpy as np

from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset, SCLViewBatchBuilder
from scl_deepfake_audio_detection_torch.utils.audio_io import pcm16_encode


def _put_or_stop(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Blocking put that gives up once ``stop`` is set; True iff enqueued.
    A plain ``put`` would park the producer forever on a full queue when
    the consumer leaves early."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _prefetched(produce: Callable[[ThreadPoolExecutor, threading.Event], Iterator],
                num_workers: int, prefetch: int) -> Iterator:
    """Run the generator ``produce(pool, stop)`` in a producer thread and
    yield its items from a queue of ``prefetch``."""
    out_q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        try:
            with ThreadPoolExecutor(num_workers) as pool:
                items = produce(pool, stop)
                try:
                    for item in items:
                        if stop.is_set() or not _put_or_stop(out_q, item, stop):
                            return
                finally:
                    items.close()
            _put_or_stop(out_q, None, stop)
        except BaseException as e:  # handed to the consumer, which raises it
            _put_or_stop(out_q, e, stop)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = out_q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


class TrainLoader:
    """Yields {'wav': [G, V, T], 'labels': [G, V], 'utts': list} per step."""

    def __init__(self, builder: SCLViewBatchBuilder, groups_per_step: int = 1,
                 shuffle: bool = True, drop_last: bool = True, num_workers: int = 4,
                 seed: int = 1234, prefetch: int = 2, shard_index: int = 0,
                 num_shards: int = 1):
        """``shard_index``/``num_shards``: every process draws the same
        seeded global order and keeps its stride slice."""
        self.builder = builder
        self.groups = groups_per_step
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = max(1, num_shards)

    def __len__(self) -> int:
        n = len(self.builder) // self.num_shards
        return n // self.groups if self.drop_last else -(-n // self.groups)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        """The seeded global order, this shard's stride slice of it, cut to
        floor(N / num_shards) so that every shard takes the same number of
        steps."""
        order = np.arange(len(self.builder))
        if self.shuffle:
            np.random.default_rng(np.random.SeedSequence([self.seed, epoch])).shuffle(order)
        if self.num_shards > 1:
            common = len(order) // self.num_shards
            order = order[self.shard_index :: self.num_shards][:common]
        if self.drop_last:
            order = order[: len(order) - len(order) % self.groups]
        return order

    # what a loader flavour overrides: the builder call and the batch
    def _build_one(self, i: int, epoch: int):
        return self.builder.build(int(i), epoch)

    def _assemble(self, items) -> Dict:
        return {"wav": np.stack([w for _, w, _ in items]),
                "labels": np.stack([l for _, _, l in items]),
                "utts": [u for u, _, _ in items]}

    def epoch(self, epoch: int = 0) -> Iterator[Dict]:
        order = self._epoch_order(epoch)
        steps = [order[i : i + self.groups] for i in range(0, len(order), self.groups)]

        def produce(pool, stop):
            for step_idx in steps:
                if stop.is_set():
                    return
                yield self._assemble(list(pool.map(lambda i: self._build_one(i, epoch),
                                                   step_idx)))

        return _prefetched(produce, self.num_workers, self.prefetch)


class DeviceAugTrainLoader(TrainLoader):
    """``TrainLoader`` for the on-device composer: the workers only decode
    and co-crop (``SCLViewBatchBuilder.build_raw``), and a batch is
    {'anchors', 'reals', 'vocoded', 'spoofs', 'utts'} raw stacks for
    ``data/device_pipeline.DeviceViewComposer``.  ``wire_dtype='int16'``
    ships PCM16, half the host -> device bytes."""

    def __init__(self, *args, wire_dtype: str = "float32", **kw):
        super().__init__(*args, **kw)
        if wire_dtype not in ("float32", "int16"):
            raise ValueError(f"wire_dtype must be float32 or int16, got {wire_dtype}")
        self.wire_dtype = wire_dtype

    def _wire(self, x: np.ndarray) -> np.ndarray:
        return pcm16_encode(x) if self.wire_dtype == "int16" else x

    def _build_one(self, i: int, epoch: int):
        return self.builder.build_raw(int(i), epoch)

    def _assemble(self, items) -> Dict:
        return {"utts": [d["utt"] for d in items],
                **{k: self._wire(np.stack([d[role] for d in items]))
                   for k, role in (("anchors", "anchor"), ("reals", "reals"),
                                   ("vocoded", "vocoded"), ("spoofs", "spoofs"))}}


class EvalLoader:
    """Yields (wav [B, cut], utt_ids) at a fixed batch shape: the final
    short batch is padded with zero rows, which the writer drops through the
    length of the utt list.  ``wire_dtype='int16'`` ships PCM16, half the
    host -> device bytes and lossless for 16-bit audio."""

    def __init__(self, dataset: EvalDataset, batch_size: int = 32,
                 num_workers: int = 4, pad_final: bool = True,
                 prefetch: int = 2, wire_dtype: str = "float32"):
        if wire_dtype not in ("float32", "int16"):
            raise ValueError(f"wire_dtype must be float32 or int16, got {wire_dtype}")
        self.ds = dataset
        self.bs = batch_size
        self.num_workers = max(1, num_workers)
        self.pad_final = pad_final
        self.prefetch = prefetch
        self.wire_dtype = wire_dtype

    def __len__(self) -> int:
        return -(-len(self.ds) // self.bs)

    def __iter__(self):
        def produce(pool, stop):
            for i in range(0, len(self.ds), self.bs):
                if stop.is_set():
                    return
                chunk = range(i, min(i + self.bs, len(self.ds)))
                items = list(pool.map(self.ds.get, chunk))
                wav = np.stack([w for w, _ in items])
                if self.pad_final and len(chunk) < self.bs:
                    pad = np.zeros((self.bs - len(chunk), wav.shape[1]), wav.dtype)
                    wav = np.concatenate([wav, pad])
                if self.wire_dtype == "int16":
                    wav = pcm16_encode(wav)
                yield wav, [u for _, u in items]

        return _prefetched(produce, self.num_workers, self.prefetch)
