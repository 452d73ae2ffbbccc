#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the script with a non-zero exit:

1. card: a CUDA device must be present; prints its name and power limit;
2. build: compiles every kernel of ``scl_deepfake_audio_detection_torch/csrc``
   with nvcc and prints the ``-Xptxas -v`` report;
3. kernel vs plain: the flash-attention forward against its plain PyTorch
   version at [2, 16, T, 64], T in {199, 201, 1024}, kv_len in {None, T-13},
   bf16 and fp32, O and LSE within stated tolerances;
4. golden: the committed golden checkpoint scored on the card through the
   kernel (tiny config, fp32, TF32 off) reproduces
   ``tests/golden/expected_scores.txt`` within 1e-4;
5. main path: ``--eval`` through the port's CLI with XLS-R 300M + LinearNLL
   (seeded random init, bf16) at [16, 64600]; the kernel must launch 24
   times per forward, every log-prob row must be finite and normalised,
   and the scores must agree with the same forward at impl='reference';
6. times: at the main-path shape [16, 16, 201, 64] bf16 the kernel is
   checked against its plain version once more, then CUDA-event times of
   the kernel, its plain version and ``F.scaled_dot_product_attention`` (a
   yardstick only; the port never calls it), eval utt/s and peak memory.

The line before the last is a JSON object with one entry per kernel, the
line before it the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_CKPT = os.path.join(ROOT, "tests", "golden", "mini_linear_nll.ckpt")
GOLDEN_SCORES = os.path.join(ROOT, "tests", "golden", "expected_scores.txt")
EVAL_CONFIG = os.path.join(ROOT, "configs", "conf-eval-only.yaml")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, dense bf16 rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# Kernel vs plain version.  fp32: the same fp32 arithmetic summed in another
# order.  bf16: P is rounded to bf16 at the kernel's running max, the plain
# version rounds it at the final max, and O is rounded to bf16, so O may
# differ by a few bf16 ulps of |O| <= ~3.  LSE comes from the same fp32
# scores in both, up to summation order.
TOL = {torch.float32: {"o": 2e-5, "lse": 1e-5},
       torch.bfloat16: {"o": 3e-2, "lse": 1e-4}}
GOLDEN_ATOL = 1e-4  # as tests/test_golden_pipeline.py
# Main path, kernel vs impl='reference' over 24 bf16 layers: the two cores
# round P at different points, and the bf16 residual stream carries that on.
MAIN_PATH_ATOL = 5e-2
MAIN_SHAPE = (16, 16, 201, 64)  # XLS-R 300M at [16, 64600]: B, H, T, D


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def golden_wavs(t: int = 16000):
    """The utterances of tests/test_golden_pipeline.py: tone, noise, chirp
    and a short tone that takes the repeat-pad branch."""
    rng = np.random.default_rng(20240817)
    tt = np.arange(t) / 16000.0
    return [
        (0.3 * np.sin(2 * np.pi * 440.0 * tt)).astype(np.float32),
        (0.2 * rng.normal(size=t)).astype(np.float32),
        (0.3 * np.sin(2 * np.pi * (200 + 800 * tt) * tt)).astype(np.float32),
        (0.25 * np.sin(2 * np.pi * 333.0 * tt[: t // 3])).astype(np.float32),
    ]


def read_scores(path):
    rows = {}
    with open(path) as f:
        for ln in f:
            utt, a, b = ln.split()
            rows[utt] = (float(a), float(b))
    return rows


def phase_build(K):
    t0 = time.perf_counter()
    info = K.build()
    print(f"[build] {len(info)} kernel(s) in {time.perf_counter() - t0:.2f}s")
    for name, rec in info.items():
        print(f"[build] {name}: {rec['path']}")
        print(rec["log"].strip())


def phase_kernel_vs_plain(K, A):
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for t in (199, 201, 1024):
            for kv_len in (None, t - 13):
                shape = (2, 16, t, 64)
                q = (torch.randn(shape, device="cuda", generator=g) / 8).to(dtype)
                k = torch.randn(shape, device="cuda", generator=g).to(dtype)
                v = torch.randn(shape, device="cuda", generator=g).to(dtype)
                o, lse = K.flash_attn_fwd(q, k, v, kv_len)
                torch.cuda.synchronize()
                ro, rlse = A.flash_attention_forward_reference(q, k, v, kv_len)
                eo = (o.float() - ro.float()).abs().max().item()
                el = (lse - rlse).abs().max().item()
                tol = TOL[dtype]
                ok = eo <= tol["o"] and el <= tol["lse"]
                print(f"[kernel] {str(dtype):15s} T={t:5d} kv_len={kv_len!s:5s} "
                      f"O err {eo:.3e} (tol {tol['o']:.0e})  LSE err {el:.3e} "
                      f"(tol {tol['lse']:.0e})  {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with its plain version "
                                         f"({dtype}, T={t}, kv_len={kv_len})")
                worst = max(worst, eo)
    return worst


def phase_golden(K):
    from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
    from scl_deepfake_audio_detection_torch.data.loader import EvalLoader
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.params import load_jax_params
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train import scoring
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

    with tempfile.TemporaryDirectory() as tmp:
        utts = []
        for i, w in enumerate(golden_wavs()):
            save_wav(os.path.join(tmp, "eval", f"g{i}.wav"), w, 16000)
            utts.append(f"g{i}.wav")
        cfg = XLSRConfig.tiny()
        model = LinearNLL(ssl=cfg, emb_dim=16, device="cuda")
        tree, _ = ckpt.load(GOLDEN_CKPT)
        load_jax_params(model, tree["params"]).eval()
        loader = EvalLoader(EvalDataset(utts, tmp, padding_type="repeat", cut=16000),
                            batch_size=2, num_workers=1)
        out = os.path.join(tmp, "scores.txt")
        K.reset_launches()
        scoring.produce_evaluation_file(loader, lambda w: score_step(model, w), out)
        launches = K.LAUNCHES["flash_attn_fwd"]
        got = read_scores(out)
    want = read_scores(GOLDEN_SCORES)
    err = max(abs(a - b) for u in want for a, b in zip(got[u], want[u]))
    print(f"[golden] T={cfg.num_frames(16000)} D={cfg.head_dim} fp32 on the card: "
          f"max |score - golden| = {err:.3e} (tol {GOLDEN_ATOL:.0e}), "
          f"{launches} kernel launches")
    if sorted(got) != sorted(want) or err > GOLDEN_ATOL:
        raise AssertionError("golden scores not reproduced on the card")
    expect = cfg.encoder_layers * math.ceil(len(utts) / 2)
    if launches != expect:
        raise AssertionError(f"golden run launched the kernel {launches} times, "
                             f"expected {expect}")


def phase_main_path(K, tmp):
    """--eval through the CLI at XLS-R 300M, then the same forward at
    impl='reference' on the first batch."""
    from scl_deepfake_audio_detection_torch import cli
    from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav
    from scl_deepfake_audio_detection_torch.utils.config import load_config

    n_utts, batch, cut, seed = 32, 16, 64600, 1234
    rng = np.random.default_rng(seed)
    db = os.path.join(tmp, "db")
    utts = [f"utt{i:03d}.wav" for i in range(n_utts)]
    for i, u in enumerate(utts):
        n = cut if i % 4 else cut // 3  # every fourth one short: zero-pad branch
        save_wav(os.path.join(db, u), (0.1 * rng.normal(size=n)).astype(np.float32))
    with open(os.path.join(db, "protocol.txt"), "w") as f:
        f.writelines(f"{u} eval {'bonafide' if i % 2 else 'spoof'}\n"
                     for i, u in enumerate(utts))
    out = os.path.join(tmp, "scores.txt")
    argv = ["--eval", "--config", EVAL_CONFIG, "--database_path", db,
            "--eval_output", out, "--ssl_preset", "xlsr_300m",
            "--compute_dtype", "bfloat16", "--batch_size", str(batch),
            "--num_workers", "4", "--wire_dtype", "int16", "--seed", str(seed),
            "--device", "cuda"]
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.LAUNCHES["flash_attn_fwd"]
    if rc != 0:
        raise AssertionError(f"--eval exited {rc}")
    forwards = math.ceil(n_utts / batch)
    layers = XLSRConfig.xlsr_300m().encoder_layers
    print(f"[main] --eval scored {n_utts} utts in {wall:.2f}s (CLI wall clock "
          f"incl. model build), kernel launches {launches} for {forwards} forwards")
    if launches != layers * forwards:
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"{layers} x {forwards}")
    rows = read_scores(out)
    lp = np.array([rows[u] for u in utts], np.float64)
    lse = np.logaddexp(lp[:, 0], lp[:, 1])
    if lp.shape != (n_utts, 2) or not np.isfinite(lp).all() or np.abs(lse).max() > 1e-4:
        raise AssertionError(f"bad score rows: shape {lp.shape}, max |logsumexp| "
                             f"{np.abs(lse).max()}")

    cfg = load_config(EVAL_CONFIG)
    ds = EvalDataset(utts, db, padding_type="zero", use_eval_subdir=False)
    wav = np.stack([ds.get(i)[0] for i in range(batch)])
    scores = {}
    for impl in ("auto", "reference"):
        ssl = XLSRConfig.xlsr_300m(compute_dtype="bfloat16", attention_impl=impl)
        model = LinearNLL.from_config(cfg.model, ssl=ssl, device="cuda", seed=seed)
        cast_matmul_params(model.eval(), torch.bfloat16)
        scores[impl] = score_step(model, wav).float().cpu().numpy()
        del model
    torch.cuda.empty_cache()
    vs_file = np.abs(scores["auto"] - lp[:batch]).max()
    vs_ref = np.abs(scores["auto"] - scores["reference"]).max()
    print(f"[main] in-process kernel forward vs --eval file: {vs_file:.3e}; "
          f"kernel vs impl='reference': max |d log-prob| = {vs_ref:.3e} "
          f"(tol {MAIN_PATH_ATOL:.0e})")
    if vs_file > 1e-5 or vs_ref > MAIN_PATH_ATOL:
        raise AssertionError("main-path scores disagree")
    return launches


def phase_times(K, A, card):
    import torch.nn.functional as F

    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.engine import score_step

    g = torch.Generator(device="cuda").manual_seed(1)
    q = (torch.randn(MAIN_SHAPE, device="cuda", generator=g) / 8).bfloat16()
    k = torch.randn(MAIN_SHAPE, device="cuda", generator=g).bfloat16()
    v = torch.randn(MAIN_SHAPE, device="cuda", generator=g).bfloat16()
    o, lse = K.flash_attn_fwd(q, k, v)
    ro, rlse = A.flash_attention_forward_reference(q, k, v)
    err = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    tol = TOL[torch.bfloat16]
    print(f"[kernel] main-path shape {list(MAIN_SHAPE)} bf16: O err {err:.3e} "
          f"(tol {tol['o']:.0e})  LSE err {err_lse:.3e} (tol {tol['lse']:.0e})")
    if err > tol["o"] or err_lse > tol["lse"]:
        raise AssertionError("kernel disagrees with its plain version at the "
                             "main-path shape")
    plain1 = cuda_ms(lambda: A.flash_attention_forward_reference(q, k, v))
    kern1 = cuda_ms(lambda: K.flash_attn_fwd(q, k, v))
    kern2 = cuda_ms(lambda: K.flash_attn_fwd(q, k, v))
    plain2 = cuda_ms(lambda: A.flash_attention_forward_reference(q, k, v))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
    b, h, t, d = MAIN_SHAPE
    nbytes = 4 * q.numel() * q.element_size() + b * h * t * 4  # q, k, v, O + LSE
    flops = 4 * b * h * t * t * d
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    kern_ms, plain_ms = min(kern1, kern2), min(plain1, plain2)
    print(f"[times] {card}: flash_attn_fwd {list(MAIN_SHAPE)} bf16: kernel "
          f"{kern1:.4f}/{kern2:.4f} ms, plain {plain1:.4f}/{plain2:.4f} ms, "
          f"sdpa {lib:.4f} ms, bound {max(bytes_ms, flops_ms):.4f} ms "
          f"({nbytes / 1e6:.2f} MB -> {bytes_ms:.4f} ms, {flops / 1e9:.3f} GFLOP "
          f"-> {flops_ms:.4f} ms)")

    model = LinearNLL(ssl=XLSRConfig.xlsr_300m(compute_dtype="bfloat16"),
                      device="cuda", seed=0)
    cast_matmul_params(model.eval(), torch.bfloat16)
    wav = torch.randn(16, 64600, device="cuda", generator=g) * 0.1
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        score_step(model, wav)
    torch.cuda.synchronize()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        score_step(model, wav)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[times] {card}: eval [16, 64600] bf16 score_step, batch on the card: "
          f"{16 * iters / dt:.2f} utt/s ({dt / iters * 1e3:.2f} ms/forward), "
          f"peak memory {peak / 2**30:.3f} GiB")
    return {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": lib}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's card path needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from scl_deepfake_audio_detection_torch.ops import _kernels as K
    from scl_deepfake_audio_detection_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    phase_build(K)
    phase_kernel_vs_plain(K, A)
    phase_golden(K)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(K, tmp)
    times = phase_times(K, A, card)
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f}s")
    kernel = {
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "scl_deepfake_audio_detection_torch/csrc/flash_attn_fwd.cu",
        "replaces": "scl_deepfake_audio_detection_tpu/ops/attention.py:144",
        "launches": launches,
        **times,
    }
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
