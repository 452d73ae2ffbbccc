#!/usr/bin/env python
"""Time the port's scoring path end to end for several checkouts, in turns,
on one card.

Usage:
    python scripts/compare_torch_scoring.py --trees A=DIR,B=DIR \
        [--order A,B,B,A] [--out FILE.json]
    python scripts/compare_torch_scoring.py --dispatch

Each turn is a process of its own that imports
``scl_deepfake_audio_detection_torch`` from its tree (an unpacked
``git archive``, or ``.``) and, at XLS-R 300M + LinearNLL with seeded random
weights (seed 1234), bf16, on the card:

- ``score_step`` on one [16, 64600] batch: five blocks of 10 forwards, each
  timed on the host clock to a synchronize (ms a forward, utt/s), and the
  median host ms to issue one forward onto an idle card (20 of them);
- ``--serve`` through the CLI, twice, on a pipe of 96 WAV requests at
  ``--serve_batch 16`` (the 32-utterance database ``chip_smoke.py``'s eval
  modes use, three times): utt/s from the first forward's start to the
  last one's end, as ``chip_smoke.py``'s serving phase reads it, each
  forward's ms and the host gaps between forwards;
- ``serving.make_server`` on 127.0.0.1:0, three rounds of 16 client threads
  of 4 JSON requests, each after one warm-up request: utt/s and p50 / p99
  request latency.

``--dispatch`` times, for this checkout alone, the host's cost of calling
the flash forward and ``linear``'s product through their registered ops
(``ops/custom_ops``) against calling the functions behind them.

A tree's first turn builds its kernels before anything is timed.  The
parent prints one JSON line per turn, then a summary of each tree's range.
It needs one card and imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

SEED, BATCH, CUT = 1234, 16, 64600


def _database(root):
    """32 utterances in the eval-only layout: 28 of 20000-64600 samples and
    four of 150000-260000 (``chip_smoke.py``'s ``_eval_modes_database``)."""
    import numpy as np

    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

    rng = np.random.default_rng(4321)
    long = {5: 150000, 13: 190000, 21: 225000, 29: 260000}
    paths = []
    for i in range(32):
        n = long.get(i, int(rng.integers(20000, 64600, endpoint=True)))
        paths.append(os.path.join(root, f"m{i:03d}.wav"))
        save_wav(paths[-1], (0.1 * rng.normal(size=n)).astype(np.float32))
    return paths


def _stdin_serve(cli, serve_mod, config, requests):
    """``--serve`` in-process on a pipe of ``requests``: utt/s from the
    first forward's start to the last one's end, each forward's ms and the
    host gaps between them (the next group's decode)."""
    import torch

    forwards = []
    real = serve_mod.score_step

    def spy(*args):
        t0 = time.perf_counter()
        res = real(*args)
        torch.cuda.synchronize()
        forwards.append((t0, time.perf_counter()))
        return res

    r, w = os.pipe()
    with os.fdopen(w, "w") as f:
        f.write("".join(f"{os.path.basename(p)}\t{p}\n" for p in requests))
    text, stdin = io.StringIO(), sys.stdin
    serve_mod.score_step = spy
    try:
        with os.fdopen(r) as pipe, contextlib.redirect_stdout(text):
            sys.stdin = pipe
            rc = cli.main(["--config", config, "--ssl_preset", "xlsr_300m",
                           "--compute_dtype", "bfloat16", "--seed", str(SEED),
                           "--device", "cuda", "--serve", "--serve_batch", str(BATCH)])
    finally:
        sys.stdin = stdin
        serve_mod.score_step = real
    replies = [ln for ln in text.getvalue().splitlines() if "\t" in ln]
    if rc != 0 or len(replies) != len(requests) or len(forwards) != len(requests) // BATCH:
        raise RuntimeError(f"--serve: exit {rc}, {len(replies)} replies, "
                           f"{len(forwards)} forwards")
    return {"utt_s": len(requests) / (forwards[-1][1] - forwards[0][0]),
            "fwd_ms": [(b - a) * 1e3 for a, b in forwards],
            "gap_ms": [(forwards[i + 1][0] - forwards[i][1]) * 1e3
                       for i in range(len(forwards) - 1)]}


def _http_round(server, paths):
    """16 client threads of 4 JSON requests: utt/s and latencies in ms."""
    base = "http://%s:%d" % server.server_address[:2]

    def post(path):
        t0 = time.perf_counter()
        req = urllib.request.Request(base + "/score", data=json.dumps({"path": path}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            json.loads(resp.read())
        return time.perf_counter() - t0

    latencies, failures, lock = [], [], threading.Lock()

    def client(t):
        try:
            for k in range(4):
                dt = post(paths[(4 * t + k) % len(paths)])
                with lock:
                    latencies.append(dt * 1e3)
        except Exception as e:  # noqa: BLE001 -- reported below
            with lock:
                failures.append(repr(e))

    post(paths[0])  # warm-up
    threads = [threading.Thread(target=client, args=(t,)) for t in range(16)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if failures or len(latencies) != 64:
        raise RuntimeError(f"HTTP clients failed: {failures[:3]}")
    return 64 / wall, latencies


def _one(tree: str) -> dict:
    """One turn: the readings for the package in ``tree``."""
    import tempfile

    import numpy as np
    import torch

    import scl_deepfake_audio_detection_torch as port
    from scl_deepfake_audio_detection_torch import cli, serving
    from scl_deepfake_audio_detection_torch.cli import serve as serve_mod
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.config import load_config

    if not os.path.abspath(port.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {port.__file__}, not the package in {tree}")
    config = os.path.join(tree, "configs", "conf-eval-only.yaml")
    cfg = load_config(config)
    model = cast_matmul_params(LinearNLL.from_config(
        cfg.model, ssl=XLSRConfig.xlsr_300m(compute_dtype="bfloat16"), device="cuda",
        seed=SEED).eval(), torch.bfloat16)
    wav = 0.1 * torch.randn(BATCH, CUT, generator=torch.Generator(device="cuda").manual_seed(9),
                            device="cuda")
    for _ in range(3):  # builds the kernels on a tree's first turn
        first = score_step(model, wav).float().cpu().numpy()
    blocks = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            score_step(model, wav)
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t0) / 10 * 1e3)
    issue = []  # host ms to issue one forward onto an idle card
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score_step(model, wav)
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    out = {"score_step_ms": blocks, "score_step_utt_s": BATCH / min(blocks) * 1e3,
           "issue_ms": float(np.median(issue)), "scores": first[:4].tolist()}

    with tempfile.TemporaryDirectory() as tmp:
        paths = _database(tmp)
        runs = [_stdin_serve(cli, serve_mod, config, paths * 3) for _ in range(2)]
        out["stdin_utt_s"] = [r["utt_s"] for r in runs]
        out["stdin_fwd_ms"] = [r["fwd_ms"] for r in runs]
        out["stdin_gap_ms"] = [r["gap_ms"] for r in runs]

        server = serving.make_server(lambda block: score_step(model, block), cut=CUT, port=0,
                                     batch_size=BATCH, max_wait_ms=5.0, max_queue=None,
                                     padding_type="zero", model_tag=cfg.model.name)
        runner = threading.Thread(target=server.serve_forever, daemon=True)
        runner.start()
        try:
            rounds = [_http_round(server, paths) for _ in range(3)]
        finally:
            server.shutdown()
            server.close()
            runner.join(timeout=60)
        out["http_utt_s"] = [r[0] for r in rounds]
        out["http_p50_ms"] = [float(np.percentile(r[1], 50)) for r in rounds]
        out["http_p99_ms"] = [float(np.percentile(r[1], 99)) for r in rounds]
    return out


def _dispatch() -> dict:
    """Host µs a call of a registered ``scl_port`` op against the function
    behind it, for this checkout, at shapes small enough that the card
    finishes each call before the host issues the next: 2000 calls back to
    back, in turns direct, op, op, direct, three times."""
    import torch

    from scl_deepfake_audio_detection_torch.ops import _kernels, custom_ops  # noqa: F401
    from scl_deepfake_audio_detection_torch.ops.layers import _mm_f32

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 1, 201, 64, device="cuda", dtype=torch.bfloat16, generator=g)
               for _ in range(3))
    x = torch.randn(64, 1024, device="cuda", dtype=torch.bfloat16, generator=g)
    w_t = torch.randn(1024, 1024, device="cuda", dtype=torch.bfloat16, generator=g)
    pairs = {"flash_attn_fwd": (lambda: _kernels.flash_attn_fwd(q, k, v, 190),
                                lambda: torch.ops.scl_port.flash_attn_fwd(q, k, v, 190)),
             "mm_f32": (lambda: _mm_f32(x, w_t), lambda: torch.ops.scl_port.mm_f32(x, w_t))}

    def host_us(fn, n=2000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    out = {}
    for name, (direct, op) in pairs.items():
        turns = {"direct": [], "op": []}
        for _ in range(3):
            for label in ("direct", "op", "op", "direct"):
                turns[label].append(host_us(direct if label == "direct" else op))
        out[name] = turns
    _kernels.reset_launches()
    return out


def main(argv) -> int:
    if argv[:1] == ["--dispatch"]:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        print(json.dumps(_dispatch()))
        return 0
    if argv[:1] == ["--one"]:
        tree = os.path.abspath(argv[1])
        sys.path.insert(0, tree)
        print(json.dumps(_one(tree)))
        return 0
    opts = dict(zip(argv[::2], argv[1::2]))
    trees = dict(t.split("=", 1) for t in opts["--trees"].split(","))
    order = opts.get("--order", ",".join(trees)).split(",")
    turns = []
    for label in order:
        tree = os.path.abspath(trees[label])
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                           cwd=tree, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-4000:] + r.stderr[-4000:], file=sys.stderr)
            return 1
        turn = dict(json.loads(r.stdout.strip().splitlines()[-1]), tree=label,
                    wall_s=time.perf_counter() - t0)
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    d = max(abs(x - y) for t in turns for rt, r0 in zip(t["scores"], turns[0]["scores"])
            for x, y in zip(rt, r0))
    print(f"max |d score| of any turn's first four rows against the first turn's: {d}")
    keys = ("score_step_utt_s", "issue_ms", "stdin_utt_s", "http_utt_s", "http_p50_ms",
            "http_p99_ms")
    for label in trees:
        mine = [t for t in turns if t["tree"] == label]
        parts = []
        for k in keys:
            vals = sorted(v for t in mine for v in (t[k] if isinstance(t[k], list) else [t[k]]))
            parts.append(f"{k} {vals[0]}-{vals[-1]} (median {vals[len(vals) // 2]}, "
                         f"n {len(vals)})")
        print(f"{label}: " + "; ".join(parts))
    if "--out" in opts:
        with open(opts["--out"], "w") as f:
            json.dump(turns, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
