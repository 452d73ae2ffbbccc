"""Score-file writers, byte-compatible with the JAX package's
(``scl_deepfake_audio_detection_tpu/train/scoring.py``) and the reference's
three formats (``main.py:120-214``):

  eval  ``utt cm0 cm1``    the two log-softmax outputs
  pred  ``utt score pred`` score = cm1 (bonafide log-prob), pred = argmax
  emb   one ``<utt>.npy`` embedding per utterance and a ``scores.txt`` in
        eval format

Files are truncated unless ``append`` is set (``--resume_eval``); the
reference appends with ``'a+'``, so its reruns double a file.  Floats print
as ``str(float(x))`` of the float32 value.  Every ``score_fn`` may return a
device tensor: it is read back after the ``_pipelined`` lag, so the card
computes the next batch while the host writes the last.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from scl_deepfake_audio_detection_torch.data.generic_io import pad_to_bucket
from scl_deepfake_audio_detection_torch.data.sampler import length_buckets
from scl_deepfake_audio_detection_torch.dsp.pad import pad_eval


def _fmt(x: float) -> str:
    return str(float(x))


def read_valid_rows(path: str, n_tokens: int = 3) -> Tuple[list, set]:
    """The rows of an existing score file that ``--resume_eval`` keeps ->
    ``(valid_lines, scored_utts)``: lines of exactly ``n_tokens`` tokens
    whose columns past the utt id parse as numbers.  A torn final line (a
    run killed mid-write) is dropped, and so is a repeated utt (the first
    row wins, as downstream joins read the file)."""
    valid, seen = [], set()
    if not os.path.exists(path):
        return valid, seen
    with open(path) as f:
        for line in f:
            if not line.endswith("\n"):
                break  # torn final line: the write was interrupted
            toks = line.split()
            if len(toks) != n_tokens or toks[0] in seen:
                continue
            try:
                for t in toks[1:]:
                    float(t)
            except ValueError:
                continue
            valid.append(line)
            seen.add(toks[0])
    return valid, seen


def _pipelined(batches, launch, depth: int = 2):
    """Keep ``depth`` scoring calls in flight before reading results back.

    ``launch(wav)`` returns a device tensor while the card still computes;
    reading with a lag overlaps the next batch's host work and transfer
    with the previous batch's compute."""
    pending = deque()
    for wav, utts in batches:
        pending.append((utts, launch(wav)))
        if len(pending) > depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _open_out(out_path: str, append: bool):
    os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".", exist_ok=True)
    return open(out_path, "a" if append else "w")


def produce_evaluation_file(
    batches: Iterable[Tuple[np.ndarray, list]],
    score_fn: Callable,
    out_path: str,
    progress: Optional[Callable[[int], None]] = None,
    append: bool = False,
) -> None:
    """``utt cm0 cm1`` lines.  ``score_fn`` maps wav [B, T] -> log_probs
    [B, 2]; padded tail rows (beyond len(utts)) are dropped."""
    done = 0
    with _open_out(out_path, append) as f:
        for utts, lp_dev in _pipelined(batches, score_fn):
            lp = _to_numpy(lp_dev)[: len(utts)]
            for utt, row in zip(utts, lp):
                f.write(f"{utt} {_fmt(row[0])} {_fmt(row[1])}\n")
            done += len(utts)
            if progress:
                progress(done)


def produce_prediction_file(
    batches: Iterable[Tuple[np.ndarray, list]],
    score_fn: Callable,
    out_path: str,
    progress: Optional[Callable[[int], None]] = None,
    append: bool = False,
) -> None:
    """``utt score pred`` lines: score = bonafide log-prob, pred = argmax."""
    done = 0
    with _open_out(out_path, append) as f:
        for utts, lp_dev in _pipelined(batches, score_fn):
            lp = _to_numpy(lp_dev)[: len(utts)]
            pred = np.argmax(lp, axis=-1)
            for utt, row, p in zip(utts, lp, pred):
                f.write(f"{utt} {_fmt(row[1])} {int(p)}\n")
            done += len(utts)
            if progress:
                progress(done)


def bucketed_batches(
    wavs: Iterable[np.ndarray],
    utts: Iterable[str],
    batch_size: int,
    bucket_multiple: int = 16000,
    padding_type: str = "repeat",
    max_len: Optional[int] = None,
):
    """Yield ``(wav [B, L_bucket], utts)`` batches grouped by length.

    Items are length-sorted (``data/sampler.length_buckets``) and each batch
    pads to its longest item rounded up to ``bucket_multiple`` (0: no
    rounding), so a sweep meets few distinct shapes.  Not the parity path:
    the reference scores fixed 64600-sample crops and mean-pooled scores
    depend on length.  Short items tile-repeat (``padding_type='repeat'``)
    or zero-pad; ``max_len`` truncates long items and caps the bucket; a
    short final batch repeats its rows up to ``batch_size``."""
    wavs = list(wavs)
    utts = list(utts)
    if len(wavs) != len(utts):
        raise ValueError("wavs and utts length mismatch")
    lengths = [min(w.shape[0], max_len) if max_len else w.shape[0] for w in wavs]
    for idx_batch in length_buckets(lengths, batch_size):
        target = max(lengths[i] for i in idx_batch)
        if bucket_multiple:
            target = pad_to_bucket(target, bucket_multiple)
        if max_len is not None:
            target = min(target, max_len)
        batch = np.stack(
            [pad_eval(wavs[i], padding_type, target) for i in idx_batch]
        ).astype(np.float32)
        if batch.shape[0] < batch_size:
            reps = batch_size // batch.shape[0] + 1
            batch = np.concatenate([batch] * reps)[:batch_size]
        yield batch, [utts[i] for i in idx_batch]


def long_audio_starts(n: int, window: int = 64600, hop: Optional[int] = None) -> list:
    """Start samples of the ``window``-sample crops that cover ``n`` samples
    at ``hop`` (window / 2 by default); the last crop ends at ``n``."""
    hop = hop or window // 2
    if n <= window:
        return [0]
    starts = list(range(0, n - window + 1, hop))
    if starts[-1] + window < n:
        starts.append(n - window)
    return starts


def _launch_long_audio(wav: np.ndarray, score_fn: Callable, window: int,
                       hop: Optional[int], batch: int) -> list:
    """Launch the chunk batches of one utterance -> [(scores, rows kept)]."""
    chunks = []
    for s in long_audio_starts(wav.shape[0], window, hop):
        c = wav[s : s + window]
        if c.shape[0] < window:  # tile-pad the tail crop
            reps = window // max(c.shape[0], 1) + 1
            c = np.tile(c, reps)[:window]
        chunks.append(c)
    chunks_a = np.stack(chunks).astype(np.float32)
    launched = []
    for i in range(0, len(chunks_a), batch):
        block = chunks_a[i : i + batch]
        if block.shape[0] < batch:  # keep one batch shape
            pad = np.zeros((batch - block.shape[0], window), np.float32)
            block = np.concatenate([block, pad])
        launched.append((score_fn(block), min(batch, len(chunks_a) - i)))
    return launched


def _long_audio_mean(launched: list) -> np.ndarray:
    return np.concatenate([_to_numpy(lp)[:k] for lp, k in launched]).mean(axis=0)


def score_long_audio(
    wav: np.ndarray,
    score_fn: Callable,
    window: int = 64600,
    hop: Optional[int] = None,
    batch: int = 8,
) -> np.ndarray:
    """Score audio of any length as overlapping ``window``-sample crops
    (``long_audio_starts``; a short crop is tile-padded), ``batch`` crops
    a call, and return the mean log-prob pair [2].  The reference
    truncates to 64600 samples and so discards the rest of a long clip."""
    return _long_audio_mean(_launch_long_audio(wav, score_fn, window, hop, batch))


def produce_long_audio_evaluation_file(
    dataset,
    score_fn: Callable,
    out_path: str,
    window: int = 64600,
    hop: Optional[int] = None,
    batch: int = 8,
    progress: Optional[Callable[[int], None]] = None,
    append: bool = False,
) -> None:
    """``utt cm0 cm1`` lines from :func:`score_long_audio` on the full
    length of each utterance (``--eval --long_audio``).  An utterance of at
    most ``window`` samples scores as one tile-padded crop.  ``dataset``
    needs ``get_raw(idx) -> (wav, utt)`` (``data.datasets.EvalDataset``)."""
    raw = map(dataset.get_raw, range(len(dataset)))
    done = 0
    with _open_out(out_path, append) as f:
        for utt, launched in _pipelined(
                raw, lambda wav: _launch_long_audio(wav, score_fn, window, hop, batch)):
            row = _long_audio_mean(launched)
            f.write(f"{utt} {_fmt(row[0])} {_fmt(row[1])}\n")
            done += 1
            if progress:
                progress(done)


def produce_emb_file(
    batches: Iterable[Tuple[np.ndarray, list]],
    emb_fn: Callable,
    out_dir: str,
    progress: Optional[Callable[[int], None]] = None,
) -> None:
    """One ``<utt>.npy`` embedding per utterance and ``scores.txt`` in eval
    format.  ``emb_fn`` maps wav [B, T] -> (log_probs [B, 2], emb [B, D])."""
    os.makedirs(out_dir, exist_ok=True)
    done = 0
    with open(os.path.join(out_dir, "scores.txt"), "w") as f:
        for utts, (lp, emb) in _pipelined(batches, emb_fn):
            lp, emb = _to_numpy(lp)[: len(utts)], _to_numpy(emb)[: len(utts)]
            for utt, row, e in zip(utts, lp, emb):
                base = os.path.splitext(os.path.basename(utt))[0]
                np.save(os.path.join(out_dir, base + ".npy"), e)
                f.write(f"{utt} {_fmt(row[0])} {_fmt(row[1])}\n")
            done += len(utts)
            if progress:
                progress(done)
