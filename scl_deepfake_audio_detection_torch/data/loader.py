"""Eval batches built ahead of the device in a producer thread.

Counterpart of ``EvalLoader`` in
``scl_deepfake_audio_detection_tpu/data/loader.py``: fixed batch shape (the
final short batch is padded with zero rows, which the writer drops through
the utt list length) and an optional int16 PCM wire format, which halves
the host -> device bytes and is lossless for 16-bit audio.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
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


class EvalLoader:
    """Yields (wav [B, cut], utt_ids)."""

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
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for i in range(0, len(self.ds), self.bs):
                        if stop.is_set():
                            return
                        chunk = range(i, min(i + self.bs, len(self.ds)))
                        items = list(pool.map(self.ds.get, chunk))
                        wav = np.stack([w for w, _ in items])
                        utts = [u for _, u in items]
                        if self.pad_final and len(chunk) < self.bs:
                            pad = np.zeros((self.bs - len(chunk), wav.shape[1]), wav.dtype)
                            wav = np.concatenate([wav, pad])
                        if self.wire_dtype == "int16":
                            wav = pcm16_encode(wav)
                        if not _put_or_stop(out_q, (wav, utts), stop):
                            return
                _put_or_stop(out_q, None, stop)
            except BaseException as e:  # handed to the consumer, which raises it
                _put_or_stop(out_q, e, stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
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
