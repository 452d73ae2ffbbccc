"""The one generator of the benchmark's inputs, from a seed and a traffic
file's parameters (numpy only, so that the load generator's process stays
light).

Every seed gets the same set of sizes and gaps in another order: lengths
and inter-arrival gaps are the quantiles of their distributions, permuted
by the seed, so that a seed changes what is sent and not how much.
"""

from __future__ import annotations

import io
import wave

import numpy as np

SR = 16000


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def clips(seed: int, lengths, stream: int = 0) -> list:
    """Non-silent int16 clips: three seeded tones under a slow envelope, with
    noise 30 dB below, at a seeded peak of 0.1-0.6 of full scale."""
    g = rng(seed, stream)
    out = []
    for n in lengths:
        t = np.arange(int(n), dtype=np.float32) / SR
        x = np.zeros(int(n), np.float32)
        for f, a, ph in zip(g.uniform(80, 4000, 3), g.uniform(0.2, 1.0, 3), g.uniform(0, 6.28, 3)):
            x += np.float32(a) * np.sin(np.float32(2 * np.pi * f) * t + np.float32(ph))
        env = 0.55 + 0.45 * np.sin(np.float32(2 * np.pi * g.uniform(0.5, 3.0)) * t)
        x = x * env.astype(np.float32)
        x += g.standard_normal(int(n)).astype(np.float32) * np.float32(0.03 * np.abs(x).max())
        x *= np.float32(g.uniform(0.1, 0.6) / max(np.abs(x).max(), 1e-6))
        out.append(np.round(x * 32767.0).astype(np.int16))
    return out


def quantiles_uniform(n: int, lo: int, hi: int) -> np.ndarray:
    return np.round(lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(np.int64)


def order(seed: int, n: int, stream: int) -> np.ndarray:
    return rng(seed, stream).permutation(n)


def batch_stream(seed: int, pool: int, batch: int):
    """Endless rows of ``batch`` clip ids: successive seeded permutations of
    the pool, cut into batches."""
    k, buf = 0, np.zeros(0, np.int64)
    while True:
        while len(buf) < batch:
            buf = np.concatenate([buf, order(seed, pool, 100 + k)])
            k += 1
        row, buf = buf[:batch], buf[batch:]
        yield row


def arrivals(seed: int, rate: float, n: int) -> np.ndarray:
    """Open-loop Poisson arrival times (s): the n quantiles of the
    exponential gap at ``rate``, in a seeded order, summed."""
    gaps = (-np.log1p(-(np.arange(n) + 0.5) / n) / rate)[order(seed, n, 7)]
    return np.cumsum(gaps) - gaps[0]


def http_plan(seed: int, traffic: dict, seconds: float):
    """(clip lengths of the pool, [(due s, clip id)]) of an open-loop mix."""
    pool = int(traffic["pool"])
    lengths = quantiles_uniform(pool, traffic["min_samples"], traffic["max_samples"])
    lengths = lengths[order(seed, pool, 5)]
    n = max(int(round(traffic["rate_per_s"] * seconds)), 1)
    due = arrivals(seed, traffic["rate_per_s"], n)
    ids = np.concatenate([order(seed, pool, 200 + k) for k in range(n // pool + 1)])[:n]
    return lengths, list(zip(due.tolist(), ids.tolist()))


def wav_bytes(x: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(x.astype("<i2").tobytes())
    return buf.getvalue()
