#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the script with a non-zero exit:

1. card: a CUDA device must be present; prints its name and power limit;
2. build: compiles every kernel source of
   ``scl_deepfake_audio_detection_torch/csrc`` with nvcc, one process per
   source, all at once, and prints the ``-Xptxas -v`` reports; fails if
   ptxas serialized the ``wgmma`` of a kernel (its warning C7513);
3. kernels vs plain: the flash-attention forward (O and LSE) and the two
   backward kernels (dq and D = rowsum(dO * O) from the dq kernel, dk and
   dv from the dk/dv kernel fed that D) against their plain PyTorch
   versions at
   [2, 16, T, 64] and [2, 8, T, 96] (the distillation student's heads), T in
   {199, 201, 1024}, kv_len in {None, T-13}, bf16 and fp32, within stated
   tolerances; dk and dv rows at keys >= kv_len must be
   exactly 0; autograd through ``self_attention`` against autograd through
   ``attention_reference``; and at [1, 16, 4096, 64] bf16 the peak memory
   of forward plus backward must stay below one fp32 [T, T] score tensor;
4. golden: the committed golden checkpoint scored on the card through the
   kernel (tiny config, fp32, TF32 off) reproduces
   ``tests/golden/expected_scores.txt`` within 1e-4; then three training
   steps from it through the kernels match the same steps at
   impl='reference', and a train-state save and load gives identical scores;
5. main paths: ``--eval`` through the port's CLI with XLS-R 300M + LinearNLL
   (seeded random init, bf16) at [16, 64600], with 24 forward launches per
   forward, finite normalised log-probs and scores that agree with
   impl='reference'; then ``Engine.fit`` of the conf-3 model (bf16, remat
   'attn') for one epoch of three [2, 11, 64000] steps and one dev batch,
   with every metric finite and the launch counts the remat policy implies;
   then the training CLI (no mode flag) in-process at XLS-R 300M's widths
   and ``EARLY_LAYERS`` (4) encoder layers (``cut_depth``; ``phase_zoo``
   trains through the CLI at all 24) with
   ``configs/conf-3-linear.yaml`` verbatim but for its three paths, on a
   database written in a temporary directory (8 train and 2 dev anchors of
   48000-80000 samples, three vocoded copies each, noise and RIR files):
   4 train steps and 1 dev step with host augmentation, launches 9 / 4 / 4
   a layer, finite ``metrics.jsonl``, and ``last.ckpt`` loaded into a fresh
   model scoring exactly as the trained one; it prints the CLI's wall time
   and ms per step, the host's ms per 11-view group, peak memory and each
   checkpoint's size and write time.  Then ``--device_aug``
   (``phase_device_aug``): the view composer on the card against the
   composer on the CPU on the same inputs and draws at [2, 11, 64000],
   nb 1024 (FFT length 65024), augall_3 in both SNR modes, int16-amplitude
   rows within 4 LSB and signal rows within 1e-5, launching no
   hand-written kernel; the training CLI with ``--device_aug`` on the same
   database, config and depth, 4 train steps and 1 dev step, launches 9 /
   4 / 4 a layer and a finite ``metrics.jsonl``, its dev views composed again by a
   fresh composer and found identical; it prints the CLI's ms per step
   beside the host path's, the host's ms per group through
   ``DeviceAugTrainLoader`` and the composer's ms per step.  Then remat
   (``phase_remat``): two train steps at [2, 11, 64000] bf16 under
   'attn', 'attn_ffn', 'dots' and 'full', and two steps with bf16
   weight-grad stacks under fp32 compute (``--bf16_grads``), each with
   48 / 24 / 24 launches per step, ms of the second step and peak memory.
   Then the model zoo (``phase_zoo``), AASIST with ``configs/conf-aasist.yaml``,
   ResNet-18 (a YAML the phase writes) and BTSE with
   ``configs/conf-5-btse-trans64.yaml`` at XLS-R 300M bf16 on a
   database of 4 train and 2 dev anchors and 16 eval clips (with quiet
   and silent stretches, so that BTSE's bio tokens take all three values;
   the card's tokens equal the CPU's): 2 train steps
   and 1 dev step through the training CLI (120 / 48 / 48 launches), the
   running statistics (where the head has them) finite and moved, ``last.ckpt`` in a fresh model
   scoring exactly as the trained one, ``--eval`` from it at [16, 64600]
   (24 launches), ``--serve`` replies equal to its cm1 to 6 decimals,
   ``--export_model`` fp (and int8 for AASIST, its buffers bit-equal to
   the fp artifact's) of the trained checkpoint cut to ``EARLY_LAYERS`` (4)
   encoder layers and ``--eval --from_export`` within 1e-3 of ``--eval``
   of that checkpoint (4 launches a forward each), ``score_step``'s utt/s
   from ``last.ckpt``; then the committed tiny goldens
   of the three (``tests/golden/mini_{aasist,resnet,btse}``) through the
   kernel and at impl='reference', fp32, within 1e-4 (BTSE's tokens on the
   card equal the golden's).
   Then distillation (``phase_distill``): a seeded ``wav2vec2_linear_nll``
   teacher at XLS-R 300M written once as a ``.ckpt``, then ``--distill_from``
   through the port's CLI with ``--ssl_preset student_base`` (12 layers, 8
   heads of 96) and conf-3's YAML on the training CLI's database, 3 steps of
   [2, 11, 64000] bf16: launches exact (24 teacher forwards, 2 x 12 student
   forwards under remat 'attn', 12 dq and 12 dk/dv a step), the teacher's
   parameters bit-unchanged (sha256), the student moved and equal to
   ``student_last.ckpt``, every metric finite, the step's ms and the
   teacher forward's share of it (CUDA events) and peak memory; ``--eval
   --model_path student_last.ckpt --ssl_preset student_base`` on 16 clips
   (12 launches a forward, finite rows); the committed tiny distillation
   golden (``tests/golden/mini_distill*``: two steps' metrics and the
   student's scores, student head dim 96) within 1e-4 through the kernels;
   and which path the codec augmentations take on the host (reported).
   Between ``--eval`` and ``fit``, the
   eval modes at XLS-R 300M bf16 on a 32-utterance database with four
   clips of 150000-260000 samples (``phase_eval_modes``): ``--eval``, then
   ``--predict`` and ``--emb`` (held to its rows within 1e-5),
   ``--long_audio`` (held to ``score_long_audio`` in-process within 1e-5
   and to impl='reference' within 5e-2) and ``--resume_eval`` on the file
   cut after 11 rows and half a row, each with the exact forward launches
   its file list implies; bucketed scoring in-process, whose batches reach
   T > 256, each batch held against impl='reference'; and ``--analyze``,
   ``--compare``, ``--fuse`` and ``--fit_calibration``, which must exit 0,
   print the EER that ``compute_eer`` gives, and show no CUDA activity in
   ``torch.profiler`` and no launch.  Then serving (``phase_serve``) at
   XLS-R 300M bf16, batches of [16, 64600]: ``--serve`` through the CLI on
   a pipe of 48 WAV requests (the first 16 replies equal ``--eval
   --batch_size 16``'s cm1 to the printed 6 decimals), ``--calibrate a,b``
   (a * raw + b, a missing file replying ``ERROR`` between scored lines),
   the same requests as FLAC where the codec library builds (replies equal
   the WAV ones); ``serving.make_server`` on 127.0.0.1:0 with 16 client
   threads of 4 requests (JSON paths, uploads, one ``/score_batch``), its
   replies within 1e-6 of the stdin ones, ``/metrics`` counting the
   batches and the forward launched 24 times per batch from the
   MicroBatcher's worker thread; utt/s, p50 and p99 request latency and
   rows per batch; and ``--eval --decode_cache`` twice, each score file
   equal to the run without a cache.  Then the scoring artifact
   (``phase_export``) at XLS-R 300M's widths and 4 encoder layers
   (``cut_depth``; ``phase_zoo`` exports its heads at that depth too) bf16 on the same
   database:
   ``--export_model`` (fp and int8, a ``torch.export`` program recorded on
   the card, no weight in it), ``--verify_export`` (the fp artifact
   passes), ``--eval --from_export`` with cm1 within 1e-3 of ``--eval``,
   ``--serve --from_export`` on 48 requests, the flash forward launched
   exactly once a layer per forward of the exported program, and the
   artifact's utt/s beside ``score_step``'s on a batch on the card; the
   reference checkpoint (``phase_reference_ckpt``, at the same cut
   depth): the seeded model as a ``.ckpt``, ``--export_reference_ckpt`` to a ``.pth`` whose leaves
   are the ``.ckpt``'s (the positional conv's kernel within one fp32 ulp),
   ``--eval`` from each with scores within 1e-4, ``--parity_check``
   against the ``.pth``'s scores (exit 0) and a perturbed copy (exit 1);
   and the feature encoder's ``conv_impl``s (``phase_conv_impls``): each
   of the 7 convs under 'conv', 'gemm' and 'phase', forward and data
   gradient ms at [16, 64600] and [22, 64000], outputs within 1e-2 of
   'conv' relative to its largest, scores within 5e-2, ms a forward, and
   one conf-3 step with 'conv', ``fuse_qkv``, 'gemm' and 'phase', 48 / 24
   / 24 launches each.  Then the parallel path (``phase_parallel``, after
   ``--device_aug``, on the training CLI's database at the cut depth):
   (a) the training CLI under ``--mesh 1,1 --zero1``, a process group of
   one over NCCL, whose ``last.ckpt`` leaves are the plain CLI run's
   within 1e-6 (cuDNN deterministic for both runs), 36 / 16 / 16 launches
   each; (b) two ranks started on the one card over gloo (NCCL refuses two
   ranks a card), one [2, 11, 64000] bf16 step of XLS-R 300M's widths at 4
   layers under (2, 1) and under (1, 2) (8 heads of 64 a rank through the
   kernels) against the one-process step: metrics within MAIN_PATH_ATOL of
   their size, each leaf's first moment within a cosine of 0.99 and 5 % in
   norm of the one-process one, all leaves jointly within 2^-5,
   8 / 4 / 4 launches per rank per step, the second step's ms and peak
   memory per rank, and the one-process peak against
   ``parallel/memory``'s analytic sum (``[memory]``; after ``phase_remat``
   a second ``[memory]`` line gives the conf-3 'attn' peak over the sum,
   the estimator's overhead); (c) ``--multihost --eval`` from two ranks at full depth,
   whose ``.part0`` and ``.part1`` rows together equal the one-process
   rows to 6 decimals.  Then the measurement tools and the NII trainers
   (``phase_tools``, after distillation): the attainable bf16 GEMM rate
   (a chained ``torch.matmul`` of [16384, 4096] x [4096, 4096]);
   ``utils/measure.chained_eval_throughput`` at XLS-R 300M + LinearNLL bf16
   [16, 64600], 24 layers (24 launches a forward, warmup and iterations
   alike), and ``utils/measure.train_ms_per_step`` on the conf-3 ``Engine``
   (48 / 24 / 24 launches a step over its 2 k1 + k2 steps, the engine's
   state digest unchanged), each with its MFU against the H100's published
   989.4 TFLOP/s and against the measured rate, in (0, 1.05]; a
   ``DataProbe`` of card tensors dumping what one of their CPU copies
   dumps; ``al_loop`` over 32 clips scored by that engine's model (24
   launches a batch of 16), one train step a cycle, two cycles with the
   second resumed from the cache file, its picks equal to the CPU's loop
   over the card's log-probs; and ``GANEngine`` (the JAX package's test
   MLPs) in non-saturating, WGAN and aux mode, 3 steps on the card within
   1e-5 of the CPU's (fp32, TF32 off), its ``gan_last.ckpt`` loading to
   identical parameters.  Then Slice G3 (``phase_g3``, after the tools),
   each part against the same module on the CPU on the same weights and
   inputs (fp32, TF32 off), launching none of the three kernels: the
   conformer (``models/conformer``, the JAX ``ConformerConfig`` defaults at
   dim 1024, depth 2) over XLS-R 300M's scoring frames [16, 201, 1024], a
   training forward and backward (output, moved batch-norm statistics,
   parameter and input gradients) and an eval forward, with the forward's
   and the backward's ms; VITS's coupling block (four mean-only
   ``ResidualCoupling(192, 192, 5, 4 layers)`` with flips) and its duration
   predictor's ``ConvFlow(2, 192, 3, 3 layers, 10 bins, tail 5.0)``
   conditioned on [16, 201, 192], ragged masks: outputs, log-dets and
   gradients, the reverse undoing the forward, forward + reverse ms; and
   ``dsp/spectral.melspec`` on [16, 64600]; its figures on ``[g3]`` lines
   and as ``[g3-json]``;
6. times: CUDA-event times of each kernel at the distillation student's
   shape [22, 8, 199, 96] and at the training shape [22, 16, 199, 64] bf16
   (the forward also at the eval shape [16, 16, 201, 64]
   and at bucketed scoring's longest batch [16, 16, 349, 64]), replayed
   from a CUDA graph, best of two, with its eager time beside it; of its
   plain version; and of the PyTorch yardstick
   (``F.scaled_dot_product_attention`` pinned to its flash backend, timed
   the same way; its backward for the backward kernels; the port never
   calls it), each kernel's bound, eval utt/s, ms per train step and peak
   memory.  The dq kernel's time includes its D; torch's D alone
   (``(dO.float() * O.float()).sum(-1)``) is timed beside it.

``python3 chip_smoke.py --before DIR`` also builds the kernels of another
checkout of the repo at DIR (an earlier commit, unpacked with ``git
archive``) and times them on the same inputs, in turns with this tree's
(before, now, now, before); each entry's ``ms_before`` holds that time, and
is null without ``--before``.  Where the earlier dq kernel took D as an
input, its ``ms_before`` is that kernel and torch's D as one graphed
callable, so that both times cover the same work.

The JSON object with one entry per kernel comes two lines before the last
(launches counted on the parallel path, ``phase_parallel`` (a)'s ``--mesh
1,1 --zero1`` CLI run, with each path's counts under
``launches_by_path``: ``eval``, ``eval_modes``, ``serve`` (the stdin
runs), ``serve_http``, ``eval_from_export``, ``serve_from_export``,
``train``, ``train_cli``,
``train_cli_device_aug``, ``remat_<policy>_per_step`` and
``zoo_<aasist|resnet|btse>_<train_cli|eval|serve|eval_from_export>``,
``zoo`` (the zoo's total), ``distill``, ``distill_student_eval``,
``tools`` (``phase_tools``' total), ``g3`` (``phase_g3``'s, 0) and
``parallel_<run>``
(``phase_parallel``'s CLI runs, each rank's step under dp and tp, the
one-process ``--eval`` of (c)); the
zoo's utt/s, ms per step and peak memory under the forward's ``zoo``, the
distillation step's under ``distill``, ``phase_tools``' readings (eval
utt/s, ms per step, MFU, the GEMM rate) under ``tools``;
the forward's times at bucketed scoring's longest batch [16, 16, 349, 64]
under ``eval_modes``; times at the training shape [22, 16, 199, 64],
``ms`` = ``graph_ms``, with ``eager_ms`` and ``ms_before``, as before
distillation was ported, at the student's shape [22, 8, 199, 96] under
``student_shape`` and at a tensor-parallel rank's [22, 8, 199, 64] under
``tp_shape``; the forward's eval-shape times under
``eval``, the artifact's under ``export``; before it the per-conv table
as ``[conv-json]``, the reference checkpoint's as ``[refckpt-json]`` and
``phase_parallel``'s times and memory as ``[parallel-json]`` and
``phase_g3``'s figures as ``[g3-json]``),
then the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

import argparse
import concurrent.futures
import contextlib
import copy
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_CKPT = os.path.join(ROOT, "tests", "golden", "mini_linear_nll.ckpt")
GOLDEN_SCORES = os.path.join(ROOT, "tests", "golden", "expected_scores.txt")
EVAL_CONFIG = os.path.join(ROOT, "configs", "conf-eval-only.yaml")
CONF3_CONFIG = os.path.join(ROOT, "configs", "conf-3-linear.yaml")
AASIST_CONFIG = os.path.join(ROOT, "configs", "conf-aasist.yaml")
BTSE_CONFIG = os.path.join(ROOT, "configs", "conf-5-btse-trans64.yaml")
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")

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
# Backward kernels vs their plain versions.  fp32: the same fp32 arithmetic,
# summed in another order.  bf16: both round P and dS to bf16 at the same
# points, from fp32 sums taken in another order, and round the results to
# bf16, so a value may land one bf16 step away: each of dq, dk and dv is held
# to one bf16 ulp of its largest magnitude (2^-7 of max |x|), plus the fp32
# tolerance for gradients that are zero up to rounding (T = 1).
TOL_BWD = {torch.float32: lambda ref: 2e-5,
           torch.bfloat16: lambda ref: 2e-5 + 2.0 ** -7 * ref.abs().max().item()}


def tol_delta(o, do):
    """D = rowsum(dO * O), the dq kernel's fp32 sum against torch's over the
    same products in another order.  A sum of n terms in fp32 is off by at
    most about n 2^-24 times the sum of their magnitudes; 1e-5 of the
    largest row's sum of |dO * O| covers n up to 128 (the largest head
    dimension) with room to spare."""
    return 1e-5 * (do.float() * o.float()).abs().sum(-1).max().item()

# Autograd through the kernels vs autograd through attention_reference: in
# bf16 the reference rounds P after normalising and rounds dP to bf16 in the
# cast's backward, where the kernels keep dP in fp32: 4 bf16 ulps of max |g|.
TOL_GRAD = {torch.float32: lambda ref: 2e-5,
            torch.bfloat16: lambda ref: 2.0 ** -5 * ref.abs().max().item()}
GOLDEN_ATOL = 1e-4  # as tests/test_golden_pipeline.py
# Golden train steps, kernels vs impl='reference', fp32 with TF32 off: the
# same arithmetic in another summation order.  The attention key bias is
# left out of the parameter check: its true gradient is 0 (the softmax
# removes a per-row constant), so Adam turns rounding noise into full steps.
TRAIN_ATOL = 1e-5
# Main path, kernel vs impl='reference' over 24 bf16 layers: the two cores
# round P at different points, and the bf16 residual stream carries that on.
MAIN_PATH_ATOL = 5e-2
MAIN_SHAPE = (16, 16, 201, 64)  # XLS-R 300M at [16, 64600]: B, H, T, D
TRAIN_SHAPE = (22, 16, 199, 64)  # XLS-R 300M at [2 x 11, 64000]
BUCKET_SHAPE = (16, 16, 349, 64)  # bucketed scoring's longest batch, [16, 112000]
# the distillation student (XLSRConfig.student_base: 768 wide, 8 heads) at [2 x 11, 64000]
STUDENT_SHAPE = (22, 8, 199, 96)
# the kernel-vs-plain phases' shapes at a given T: XLS-R 300M's heads and the student's
HEAD_SHAPES = ((2, 16, 64), (2, 8, 96))
# The artifact, reference-checkpoint, training-CLI and --device_aug phases,
# and phase_zoo's exports, run XLS-R 300M's widths at this many encoder
# layers: phase_zoo drives the CLI's training again at all 24, and the cost
# of these paths (the export trace, ~1 s a layer; checkpoints of 1.3 and
# 3.5 GB) grows with depth.
EARLY_LAYERS = 4


@contextlib.contextmanager
def cut_depth(layers=EARLY_LAYERS):
    """``XLSRConfig.xlsr_300m``, and so ``--ssl_preset xlsr_300m``, at its
    full width with ``layers`` encoder layers while the block runs."""
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig

    full = XLSRConfig.__dict__["xlsr_300m"]
    XLSRConfig.xlsr_300m = classmethod(
        lambda cls, **kw: full.__func__(cls, **{"encoder_layers": layers, **kw}))
    try:
        yield
    finally:
        XLSRConfig.xlsr_300m = full
CONF3 = dict(groups=2, views=11, samples=64000, steps=3, seed=1234)
REPLACES = {
    "flash_attn_fwd": "scl_deepfake_audio_detection_tpu/ops/attention.py:144",
    "flash_attn_bwd_dq": "scl_deepfake_audio_detection_tpu/ops/attention.py:305",
    "flash_attn_bwd_dkv": "scl_deepfake_audio_detection_tpu/ops/attention.py:328",
}


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


def graph_ms(fn, iters: int = 50) -> float:
    """CUDA-event time of ``fn`` captured once in a CUDA graph and replayed:
    the device's time without the host's dispatch, which at these shapes
    outlasts the library's kernels and varies with the host's load."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def time_kernel(kern, before=None) -> dict:
    """The kernel's graphed time (best of two) and eager time; with
    ``before`` (an earlier build of the same kernel on the same inputs) also
    its graphed time, measured in turns: before, now, now, before."""
    b1 = graph_ms(before) if before else None
    k1, k2 = graph_ms(kern), graph_ms(kern)
    b2 = graph_ms(before) if before else None
    ms = min(k1, k2)
    return {"ms": ms, "graph_ms": ms, "eager_ms": cuda_ms(kern),
            "ms_before": min(b1, b2) if before else None}


def timing_line(times: dict) -> str:
    before = (f", before {times['ms_before']:.4f} ms" if times["ms_before"] is not None
              else "")
    return (f"kernel {times['graph_ms']:.4f} ms graphed (eager {times['eager_ms']:.4f} ms)"
            f"{before}")


def load_before(path: str):
    """The kernel module of another checkout at ``path``, loaded under its
    own name; its kernels build into that checkout's ``_build/``."""
    src = os.path.join(path, "scl_deepfake_audio_detection_torch", "ops", "_kernels.py")
    spec = importlib.util.spec_from_file_location("before_kernels", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    print(f"[build] {len(info)} kernels from {len(set(K.SOURCES.values()))} sources "
          f"in {time.perf_counter() - t0:.2f}s")
    shown = set()
    for name, rec in info.items():
        print(f"[build] {name}: {rec['path']}")
        if rec["path"] not in shown:
            shown.add(rec["path"])
            print(rec["log"].strip())
        # ptxas serialized the wgmmas of a kernel in this source
        if "C7513" in rec["log"]:
            raise AssertionError(f"{name}: ptxas reports C7513 (serialized wgmma)")


def phase_kernel_vs_plain(K, A):
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for (b, h, d), t in ((bhd, t) for bhd in HEAD_SHAPES for t in (199, 201, 1024)):
            for kv_len in (None, t - 13):
                shape = (b, h, t, d)
                q = (torch.randn(shape, device="cuda", generator=g) * d ** -0.5).to(dtype)
                k = torch.randn(shape, device="cuda", generator=g).to(dtype)
                v = torch.randn(shape, device="cuda", generator=g).to(dtype)
                o, lse = K.flash_attn_fwd(q, k, v, kv_len)
                torch.cuda.synchronize()
                ro, rlse = A.flash_attention_forward_reference(q, k, v, kv_len)
                eo = (o.float() - ro.float()).abs().max().item()
                el = (lse - rlse).abs().max().item()
                tol = TOL[dtype]
                ok = eo <= tol["o"] and el <= tol["lse"]
                print(f"[kernel] {str(dtype):15s} H={h:2d} D={d:3d} T={t:5d} kv_len={kv_len!s:5s} "
                      f"O err {eo:.3e} (tol {tol['o']:.0e})  LSE err {el:.3e} "
                      f"(tol {tol['lse']:.0e})  {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with its plain version "
                                         f"({dtype}, {shape}, kv_len={kv_len})")
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
    launches = dict(K.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"--eval exited {rc}")
    forwards = math.ceil(n_utts / batch)
    layers = XLSRConfig.xlsr_300m().encoder_layers
    want = {name: 0 for name in K.KERNELS}
    want["flash_attn_fwd"] = layers * forwards
    print(f"[main] --eval scored {n_utts} utts in {wall:.2f}s (CLI wall clock "
          f"incl. model build), kernel launches {launches} for {forwards} forwards")
    if launches != want:
        raise AssertionError(f"kernels launched {launches}, expected {want}")
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


EVAL_MODES = dict(n=32, long={5: 150000, 13: 190000, 21: 225000, 29: 260000},
                  short=(20000, 64600), batch=16, long_batch=8, resume_rows=11,
                  bucketed=48, bucketed_len=(40000, 112000), bucket_multiple=16000,
                  boot=200, seed=4321)


def n_crops(n: int, window: int = 64600) -> int:
    """Crops ``--long_audio`` scores for n samples: windows at hops of
    window / 2 from 0, plus one that ends at n when the hops fall short."""
    if n <= window:
        return 1
    hop = window // 2
    k = (n - window) // hop + 1
    return k + int((k - 1) * hop + window < n)


def _eval_modes_database(root):
    """32 utterances in the eval-only layout, half of them bonafide: 28 of
    20000-64600 samples and four long ones of 150000-260000."""
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

    c = EVAL_MODES
    rng = np.random.default_rng(c["seed"])
    utts = [f"m{i:03d}.wav" for i in range(c["n"])]
    lengths = [c["long"].get(i, int(rng.integers(*c["short"], endpoint=True)))
               for i in range(c["n"])]
    for u, n in zip(utts, lengths):
        save_wav(os.path.join(root, u), (0.1 * rng.normal(size=n)).astype(np.float32))
    with open(os.path.join(root, "protocol.txt"), "w") as f:
        f.writelines(f"{u} eval {'bonafide' if i % 2 else 'spoof'}\n"
                     for i, u in enumerate(utts))
    return utts, lengths


def _read_rows(path):
    with open(path) as f:
        return [ln.split() for ln in f]


def phase_eval_modes(K, card, tmp):
    """The eval modes and the score analysis through the port's CLI at
    XLS-R 300M bf16 (int16 wire, the seed of ``phase_main_path``, so every
    call builds the same random weights) on a 32-utterance database with
    four long clips: ``--eval`` and then ``--predict``, ``--emb``,
    ``--long_audio`` and ``--resume_eval`` beside it, each held to the
    exact forward-kernel launches its file list implies; bucketed scoring
    in-process, whose batches reach T > 256, held against
    impl='reference'; then ``--analyze``, ``--compare``, ``--fuse`` and
    ``--fit_calibration``, which must launch nothing on the card."""
    import contextlib
    import io
    import re

    from torch.profiler import ProfilerActivity, profile

    from scl_deepfake_audio_detection_torch import cli
    from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
    from scl_deepfake_audio_detection_torch.dsp.pad import pad_eval
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import scoring
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.train.metrics import compute_eer
    from scl_deepfake_audio_detection_torch.utils.config import load_config

    c = EVAL_MODES
    seed = 1234  # phase_main_path's
    t_phase = time.perf_counter()
    db = os.path.join(tmp, "db")
    utts, lengths = _eval_modes_database(db)
    n_utts, batch = len(utts), c["batch"]
    layers = XLSRConfig.xlsr_300m().encoder_layers
    common = ["--config", EVAL_CONFIG, "--database_path", db, "--ssl_preset", "xlsr_300m",
              "--compute_dtype", "bfloat16", "--batch_size", str(batch), "--num_workers", "4",
              "--wire_dtype", "int16", "--seed", str(seed), "--device", "cuda"]
    path_launches = {name: 0 for name in K.KERNELS}

    def drive(label, argv, forwards, n_scored):
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(common + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        want = {name: 0 for name in K.KERNELS}
        want["flash_attn_fwd"] = layers * forwards
        print(f"[eval-modes] {card}: {label}: {n_scored} utts in {wall:.2f}s wall (model "
              f"build included), {n_scored / wall:.2f} utt/s; launches {launches}, "
              f"expected {want}")
        if rc != 0:
            raise AssertionError(f"{label} exited {rc}")
        if launches != want:
            raise AssertionError(f"{label} launched {launches}, expected {want}")
        for name in K.KERNELS:
            path_launches[name] += launches[name]

    # 1. --eval, the file every other mode is held to
    ev_path = os.path.join(tmp, "eval.txt")
    drive("--eval", ["--eval", "--eval_output", ev_path], math.ceil(n_utts / batch), n_utts)
    ev = _read_rows(ev_path)
    lp = np.array([r[1:] for r in ev], np.float64)
    if [r[0] for r in ev] != utts or not np.isfinite(lp).all():
        raise AssertionError("--eval wrote bad rows")
    ev_rows = {r[0]: (float(r[1]), float(r[2])) for r in ev}

    # 2. --eval --predict: score = cm1 of --eval, pred its argmax
    pred_path = os.path.join(tmp, "pred.txt")
    drive("--eval --predict", ["--eval", "--predict", "--eval_output", pred_path],
          math.ceil(n_utts / batch), n_utts)
    pred = _read_rows(pred_path)
    err = max(abs(float(s) - ev_rows[u][1]) for u, s, _ in pred)
    argmax_ok = all(int(p) == int(ev_rows[u][1] > ev_rows[u][0]) for u, _, p in pred)
    print(f"[eval-modes] --predict vs --eval: max |score - cm1| {err:.3e} (tol 1e-05), "
          f"pred = argmax {argmax_ok}")
    if [r[0] for r in pred] != utts or err > 1e-5 or not argmax_ok:
        raise AssertionError("--predict disagrees with --eval")

    # 3. --eval --emb: scores.txt as --eval, one finite [128] embedding per utt
    emb_dir = os.path.join(tmp, "emb")
    drive("--eval --emb", ["--eval", "--emb", "--eval_output", emb_dir],
          math.ceil(n_utts / batch), n_utts)
    emb_rows = _read_rows(os.path.join(emb_dir, "scores.txt"))
    err = max(max(abs(float(a) - ev_rows[u][0]), abs(float(b) - ev_rows[u][1]))
              for u, a, b in emb_rows)
    embs = [np.load(os.path.join(emb_dir, u[:-4] + ".npy")) for u in utts]
    emb_ok = all(e.shape == (128,) and np.isfinite(e).all() for e in embs)
    print(f"[eval-modes] --emb scores.txt vs --eval: max |d| {err:.3e} (tol 1e-05); "
          f"{len(embs)} embeddings of shape [128], all finite: {emb_ok}")
    if [r[0] for r in emb_rows] != utts or err > 1e-5 or not emb_ok:
        raise AssertionError("--emb disagrees with --eval")

    # 4. --eval --long_audio: overlapping crops, 8 a forward
    long_path = os.path.join(tmp, "long.txt")
    crops = [n_crops(n) for n in lengths]
    drive("--eval --long_audio", ["--eval", "--long_audio", "--padding_type", "repeat",
                                  "--batch_size", str(c["long_batch"]),
                                  "--eval_output", long_path],
          sum(math.ceil(k / c["long_batch"]) for k in crops), n_utts)
    print(f"[eval-modes] --long_audio crops per utt {crops}")

    # 5. --eval --resume_eval on the --eval file cut after 11 rows and half a row
    resume_path = os.path.join(tmp, "resume.txt")
    with open(ev_path) as f:
        lines = f.readlines()
    keep = c["resume_rows"]
    torn = lines[keep][: len(lines[keep]) // 2]
    with open(resume_path, "w") as f:
        f.write("".join(lines[:keep]) + torn)
    remaining = n_utts - keep
    drive("--eval --resume_eval", ["--eval", "--resume_eval", "--eval_output", resume_path],
          math.ceil(remaining / batch), remaining)
    with open(resume_path) as f:
        resumed = f.readlines()
    rows = [ln.split() for ln in resumed]
    # the torn row is gone: every line whole, every utt once
    whole = all(ln.endswith("\n") and len(r) == 3 for ln, r in zip(resumed, rows))
    once = sorted(r[0] for r in rows) == sorted(utts)
    if not (whole and once):
        raise AssertionError(f"--resume_eval left a torn or repeated row: {resumed}")
    err = max(max(abs(float(a) - ev_rows[u][0]), abs(float(b) - ev_rows[u][1]))
              for u, a, b in rows[keep:])
    print(f"[eval-modes] --resume_eval: {keep} rows kept byte-identical "
          f"{resumed[:keep] == lines[:keep]}, torn row dropped, {len(rows) - keep} rows "
          f"appended, each utt once; new rows vs --eval max |d| {err:.3e} "
          f"(tol {MAIN_PATH_ATOL:.0e}: other batches)")
    if resumed[:keep] != lines[:keep] or err > MAIN_PATH_ATOL:
        raise AssertionError("--resume_eval did not resume the file")

    # the same weights in-process: the kernel path and impl='reference'
    cfg = load_config(EVAL_CONFIG)
    models = {}
    for impl in ("auto", "reference"):
        ssl = XLSRConfig.xlsr_300m(compute_dtype="bfloat16", attention_impl=impl)
        models[impl] = cast_matmul_params(
            LinearNLL.from_config(cfg.model, ssl=ssl, device="cuda", seed=seed).eval(),
            torch.bfloat16)

    # --long_audio rows against score_long_audio through score_step
    ds = EvalDataset(utts, db, padding_type="repeat", use_eval_subdir=False)
    long_rows = {r[0]: np.array(r[1:], np.float64) for r in _read_rows(long_path)}
    err_file = err_ref = 0.0
    for i, u in enumerate(utts):
        wav, _ = ds.get_raw(i)
        got = {impl: scoring.score_long_audio(wav, lambda b, m=m: score_step(m, b),
                                              batch=c["long_batch"])
               for impl, m in models.items()}
        err_file = max(err_file, np.abs(long_rows[u] - got["auto"]).max())
        err_ref = max(err_ref, np.abs(got["auto"] - got["reference"]).max())
    print(f"[eval-modes] --long_audio rows vs score_long_audio in-process: max |d| "
          f"{err_file:.3e} (tol 1e-05); kernel vs impl='reference' {err_ref:.3e} "
          f"(tol {MAIN_PATH_ATOL:.0e})")
    if sorted(long_rows) != sorted(utts) or err_file > 1e-5 or err_ref > MAIN_PATH_ATOL:
        raise AssertionError("--long_audio rows disagree")

    # 6. bucketed scoring in-process: pads to multiples of 16000 samples
    rng = np.random.default_rng(c["seed"] + 1)
    b_wavs = [(0.1 * rng.normal(size=int(n))).astype(np.float32)
              for n in rng.integers(*c["bucketed_len"], size=c["bucketed"], endpoint=True)]
    b_utts = [f"b{i:03d}" for i in range(len(b_wavs))]
    batches = list(scoring.bucketed_batches(b_wavs, b_utts, batch,
                                            bucket_multiple=c["bucket_multiple"]))
    frames = [XLSRConfig.xlsr_300m().num_frames(w.shape[1]) for w, _ in batches]
    K.reset_launches()
    torch.cuda.synchronize()
    outs = [score_step(models["auto"], w) for w, _ in batches]
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = {name: 0 for name in K.KERNELS}
    want["flash_attn_fwd"] = layers * len(batches)
    for name in K.KERNELS:
        path_launches[name] += launches[name]
    errs = [(o.float() - score_step(models["reference"], w).float()).abs().max().item()
            for o, (w, _) in zip(outs, batches)]
    print(f"[eval-modes] bucketed scoring of {len(b_wavs)} utts of "
          f"{c['bucketed_len'][0]}-{c['bucketed_len'][1]} samples, batch {batch}, "
          f"multiple {c['bucket_multiple']}: batches {[list(w.shape) for w, _ in batches]}, "
          f"T {frames}; kernel vs impl='reference' max |d log-prob| per batch "
          f"{[f'{e:.3e}' for e in errs]} (tol {MAIN_PATH_ATOL:.0e}); launches {launches}, "
          f"expected {want}")
    if launches != want or max(frames) <= 256 or max(errs) > MAIN_PATH_ATOL:
        raise AssertionError("bucketed scoring: launches, T or scores wrong")

    # bucketed against fixed 64600-sample crops of the same utterances
    fixed = [np.stack([pad_eval(w, "zero", 64600) for w in b_wavs[i : i + batch]])
             for i in range(0, len(b_wavs), batch)]
    runs = {"bucketed": [w for w, _ in batches], "fixed": fixed}
    for w in fixed:  # the bucketed shapes ran above
        score_step(models["auto"], w)
    rates = {"bucketed": [], "fixed": []}
    for name in ("bucketed", "fixed", "fixed", "bucketed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in runs[name]:
            score_step(models["auto"], w).cpu()
        rates[name].append(len(b_wavs) / (time.perf_counter() - t0))
    print(f"[eval-modes] {card}: bucketed scoring {max(rates['bucketed']):.2f} utt/s "
          f"against fixed [{batch}, 64600] crops {max(rates['fixed']):.2f} utt/s on the same "
          f"{len(b_wavs)} utts (score_step, read back each batch, best of 2)")
    del models, outs
    torch.cuda.empty_cache()

    # 7. score analysis: nothing on the card
    proto = os.path.join(db, "protocol.txt")
    analyses = [
        ("--analyze", ["--analyze", ev_path]),
        ("--compare", ["--compare", f"{ev_path},{long_path}"]),
        ("--fuse", ["--fuse", f"{ev_path},{long_path}"]),
        ("--fit_calibration", ["--fit_calibration", ev_path]),
    ]
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as control:
        torch.ones(8, device="cuda").add_(1)
        torch.cuda.synchronize()
    seen_control = sum(e.device_type == torch.autograd.DeviceType.CUDA
                       for e in control.events())
    allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    reports = {}
    K.reset_launches()
    with profile(activities=activities) as prof:
        for label, argv in analyses:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv + ["--protocol", proto, "--bootstrap_ci", str(c["boot"])])
            wall = time.perf_counter() - t0
            reports[label] = out.getvalue()
            print(f"[eval-modes] {card}: {label}: exit {rc} in {wall:.3f}s wall; "
                  + " | ".join(reports[label].strip().splitlines()))
            if rc != 0:
                raise AssertionError(f"{label} exited {rc}")
        torch.cuda.synchronize()
    seen = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    allocs_after = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    launches = dict(K.LAUNCHES)
    labels = {u: i % 2 for i, u in enumerate(utts)}
    cm1 = {u: s[1] for u, s in ev_rows.items()}
    eer, _ = compute_eer([cm1[u] for u in utts if labels[u]],
                         [cm1[u] for u in utts if not labels[u]])
    printed = re.search(r"EER: ([0-9.]+)%", reports["--analyze"]).group(1)
    print(f"[eval-modes] analysis: CUDA activity {seen} events (a one-op control "
          f"window saw {seen_control}), card allocations {allocs_after - allocs}, kernel "
          f"launches {launches}; --analyze EER {printed}% against compute_eer "
          f"{100 * eer:.4f}%")
    if (seen or not seen_control or allocs_after != allocs or any(launches.values())
            or printed != f"{100 * eer:.4f}"):
        raise AssertionError("score analysis touched the card or misreports the EER")
    print(f"[eval-modes] phase in {time.perf_counter() - t_phase:.2f}s; launches {path_launches}")
    return path_launches


SERVE = dict(batch=16, clients=16, per_client=4, calibrate=(2.0, 0.5), wait_ms=5.0)


def _stdin_serve(K, cli, serve_mod, argv, lines, target=None):
    """``--serve`` through the port's CLI in-process, its stdin a pipe that
    holds ``lines``: (reply lines, wall s, forwards, launches, forward
    window s).  Forwards are counted at ``target``, an (object, attribute)
    pair: by default ``cli.serve``'s ``score_step``."""
    import contextlib
    import io

    forwards = []
    owner, attr = target or (serve_mod, "score_step")
    real = getattr(owner, attr)

    def spy(*args):
        t0 = time.perf_counter()
        out = real(*args)
        torch.cuda.synchronize()
        forwards.append((t0, time.perf_counter()))
        return out

    r, w = os.pipe()
    with os.fdopen(w, "w") as f:
        f.write("".join(ln + "\n" for ln in lines))
    out = io.StringIO()
    stdin = sys.stdin
    setattr(owner, attr, spy)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with os.fdopen(r) as pipe, contextlib.redirect_stdout(out):
            sys.stdin = pipe
            rc = cli.main(argv)
    finally:
        sys.stdin = stdin
        setattr(owner, attr, real)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"--serve exited {rc}")
    replies = [ln.split("\t", 1) for ln in out.getvalue().splitlines()
               if not ln.startswith("loaded checkpoint")]
    window = forwards[-1][1] - forwards[0][0] if forwards else 0.0
    return replies, wall, len(forwards), launches, window


def phase_serve(K, card, tmp):
    """The serving path at XLS-R 300M + LinearNLL, seeded random init, bf16,
    [16, 64600] batches: ``--serve`` through the CLI on a pipe of 48 WAV
    requests from ``phase_eval_modes``' database (its replies for the first
    16 equal ``--eval --batch_size 16``'s cm1 to the printed 6 decimals),
    ``--calibrate`` (a * raw + b) with a missing file among the lines (an
    ``ERROR`` reply, the lines around it scored), the same utterances as
    FLAC where the codec library builds; then ``serving.make_server`` on
    127.0.0.1:0 with 16 client threads of 4 requests (JSON paths, uploads,
    one ``/score_batch``), its replies within 1e-6 of the stdin replies and
    ``flash_attn_fwd`` launched exactly 24 times per batch that the
    MicroBatcher counted, from its worker thread; then ``--eval
    --decode_cache`` twice, each score file equal to the run without it."""
    import urllib.request

    from scl_deepfake_audio_detection_torch import cli, native, serving
    from scl_deepfake_audio_detection_torch.cli import serve as serve_mod
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.audio_io import load_audio
    from scl_deepfake_audio_detection_torch.utils.config import load_config

    c = SERVE
    seed, sb = 1234, c["batch"]  # phase_main_path's seed: the same weights
    t_phase = time.perf_counter()
    layers = XLSRConfig.xlsr_300m().encoder_layers
    db = os.path.join(tmp, "db")
    utts, _ = _eval_modes_database(db)
    paths = [os.path.join(db, u) for u in utts]
    requests = paths + paths[:16]  # 48 requests
    model_flags = ["--config", EVAL_CONFIG, "--ssl_preset", "xlsr_300m",
                   "--compute_dtype", "bfloat16", "--seed", str(seed), "--device", "cuda"]
    by_path = {"serve": {n: 0 for n in K.KERNELS}, "serve_http": {n: 0 for n in K.KERNELS}}

    def expect(label, launches, forwards, path):
        want = {name: 0 for name in K.KERNELS}
        want["flash_attn_fwd"] = layers * forwards
        if launches != want:
            raise AssertionError(f"{label}: launched {launches}, expected {want}")
        if path:
            for name in K.KERNELS:
                by_path[path][name] += launches[name]

    # the reference: --eval --batch_size 16 (int16 wire, as phase_eval_modes)
    eval_flags = model_flags + ["--eval", "--database_path", db, "--batch_size", str(sb),
                                "--num_workers", "4", "--wire_dtype", "int16"]
    ev_path = os.path.join(tmp, "eval.txt")
    K.reset_launches()
    t0 = time.perf_counter()
    if cli.main(eval_flags + ["--eval_output", ev_path]) != 0:
        raise AssertionError("--eval exited non-zero")
    torch.cuda.synchronize()
    ev_wall = time.perf_counter() - t0
    expect("--eval", dict(K.LAUNCHES), math.ceil(len(utts) / sb), None)
    with open(ev_path) as f:
        ev_text = f.read()
    cm1 = {ln.split()[0]: float(ln.split()[2]) for ln in ev_text.splitlines()}

    # 1. --serve on a pipe: 48 WAV requests, 16 a batch
    lines = [f"{os.path.basename(p)}\t{p}" for p in requests]
    serve_flags = model_flags + ["--serve", "--serve_batch", str(sb)]
    replies, wall, fwd, launches, window = _stdin_serve(K, cli, serve_mod, serve_flags, lines)
    expect("--serve", launches, fwd, "serve")
    stdin_score = {k: float(v) for k, v in replies}
    first = [f"{cm1[u]:.6f}" for u in utts[:sb]]
    equal_eval = [v for _, v in replies[:sb]] == first
    print(f"[serve] {card}: --serve on a pipe: {len(requests)} WAV requests in {wall:.2f}s "
          f"wall (model build included), {fwd} forwards of [{sb}, 64600] from the first "
          f"to the last in {window:.3f}s ({len(requests) / window:.2f} utt/s); the first "
          f"{sb} replies equal --eval --batch_size {sb}'s cm1 to 6 decimals: {equal_eval}; "
          f"launches {launches}; --eval itself {ev_wall:.2f}s wall")
    if (len(replies) != len(requests) or [k for k, _ in replies] != [os.path.basename(p)
                                                                       for p in requests]
            or fwd != len(requests) // sb or not equal_eval):
        raise AssertionError(f"--serve replies wrong: {replies[:3]}..., {fwd} forwards")

    # 2. --calibrate a,b, with a missing file among the lines
    a, b = c["calibrate"]
    missing = os.path.join(db, "missing.wav")
    cal_lines = lines[:sb] + [lines[sb], f"missing\t{missing}", lines[sb + 1]]
    cal_replies, _, fwd, launches, _ = _stdin_serve(
        K, cli, serve_mod, serve_flags + ["--calibrate", f"{a},{b}"], cal_lines)
    expect("--serve --calibrate", launches, fwd, "serve")
    cal = dict((k, v) for k, v in cal_replies)
    err_cal = max(abs(float(cal[k]) - (a * stdin_score[k] + b)) for k, _ in replies[:sb])
    around = [os.path.basename(requests[i]) for i in (sb, sb + 1)]
    err_around = max(abs(float(cal[k]) - (a * stdin_score[k] + b)) for k in around)
    print(f"[serve] --calibrate {a},{b}: max |reply - (a * raw + b)| {err_cal:.3e} over the "
          f"first {sb} (tol 2e-6: 6 printed decimals); missing file replied "
          f"{cal['missing'][:40]!r}; the two lines around it within {err_around:.3e} "
          f"(tol {abs(a) * MAIN_PATH_ATOL:.0e}: another batch)")
    if (err_cal > 2e-6 or not cal["missing"].startswith("ERROR")
            or err_around > abs(a) * MAIN_PATH_ATOL or len(cal_replies) != len(cal_lines)):
        raise AssertionError("--serve --calibrate replies wrong")

    # 3. the same utterances as FLAC, where the codec library builds
    codec = native.codec_available()
    if codec:
        flac_dir = os.path.join(tmp, "flac")
        os.makedirs(flac_dir)
        flac = {}
        for p in paths:
            flac[p] = os.path.join(flac_dir, os.path.basename(p)[:-4] + ".flac")
            native.encode_audio(flac[p], load_audio(p), 16000, "flac")
        flac_lines = [f"{os.path.basename(p)}\t{flac[p]}" for p in requests]
        flac_replies, _, fwd, launches, _ = _stdin_serve(K, cli, serve_mod, serve_flags,
                                                         flac_lines)
        expect("--serve FLAC", launches, fwd, "serve")
        same = flac_replies == replies
        print(f"[serve] codec library built: --serve of the same {len(requests)} requests "
              f"as FLAC replies exactly as the WAV ones: {same}")
        if not same:
            raise AssertionError("FLAC replies differ from WAV replies")
    else:
        why = native.BUILD_ERRORS.get("scl_codec", "it built but did not load").replace(
            "\n", " | ")
        print(f"[serve] codec library did not build on this machine, so FLAC serving was "
              f"not run; g++ on native_src/scl_codec.cpp said: {why}")

    # 4. HTTP: make_server on 127.0.0.1:0, 16 client threads of 4 requests
    cfg = load_config(EVAL_CONFIG)
    model = cast_matmul_params(LinearNLL.from_config(
        cfg.model, ssl=XLSRConfig.xlsr_300m(compute_dtype="bfloat16"), device="cuda",
        seed=seed).eval(), torch.bfloat16)
    server = serving.make_server(lambda block: score_step(model, block), cut=64600, port=0,
                                 batch_size=sb, max_wait_ms=c["wait_ms"], max_queue=None,
                                 padding_type="zero", model_tag=cfg.model.name)
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    runner = threading.Thread(target=server.serve_forever, daemon=True)
    runner.start()

    def post(route, body, headers):
        t0 = time.perf_counter()
        req = urllib.request.Request(base + route, data=body, headers=headers)
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return out, time.perf_counter() - t0

    js = {"Content-Type": "application/json"}
    try:
        post("/score", json.dumps({"path": paths[0]}).encode(), js)  # warm-up
        K.reset_launches()
        b0 = server.batcher.batches
        got, latencies, failures = {}, [], []
        lock = threading.Lock()

        def client(t):
            try:
                for k in range(c["per_client"]):
                    p = requests[(t * c["per_client"] + k) % len(requests)]
                    if t == 0 and k == c["per_client"] - 1:  # one /score_batch
                        out, dt = post("/score_batch",
                                       json.dumps({"paths": requests[:sb]}).encode(), js)
                        scored = [(os.path.basename(r["path"]), r["score"])
                                  for r in out["results"]]
                    elif k == 0:  # an upload of the file's bytes
                        with open(p, "rb") as f:
                            body = f.read()
                        out, dt = post("/score", body, {"Content-Type": "audio/wav",
                                                        "X-Filename": os.path.basename(p)})
                        scored = [(out["id"], out["score"])]
                    else:
                        out, dt = post("/score", json.dumps(
                            {"path": p, "id": os.path.basename(p)}).encode(), js)
                        scored = [(out["id"], out["score"])]
                    with lock:
                        latencies.append(dt)
                        for name, score in scored:
                            got.setdefault(name, []).append(score)
            except Exception as e:  # noqa: BLE001 -- reported below
                with lock:
                    failures.append(repr(e))

        threads = [threading.Thread(target=client, args=(t,)) for t in range(c["clients"])]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        http_wall = time.perf_counter() - t0
        alive = any(t.is_alive() for t in threads)
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
    finally:
        server.shutdown()
        server.close()
        runner.join(timeout=60)
    torch.cuda.synchronize()
    batches = server.batcher.batches - b0
    launches = dict(K.LAUNCHES)
    if failures or alive or runner.is_alive():
        raise AssertionError(f"HTTP clients failed: {failures[:3]}, alive {alive}")
    expect("HTTP", launches, batches, "serve_http")
    n_scored = sum(len(v) for v in got.values())
    err_http = max(abs(s - stdin_score[name]) for name, v in got.items() for s in v)
    lat = np.array(latencies) * 1e3
    metric_batches = int(next(ln.split()[1] for ln in metrics.splitlines()
                              if ln.startswith("scl_serve_batches_total")))
    print(f"[serve] {card}: HTTP, {c['clients']} clients x {c['per_client']} requests "
          f"(JSON paths, uploads, one /score_batch of {sb}): {n_scored} utts in "
          f"{http_wall:.3f}s, {n_scored / http_wall:.2f} utt/s; request latency p50 "
          f"{np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} ms; "
          f"{batches} batches, {n_scored / batches:.2f} rows a batch (of {sb}); "
          f"/metrics batches {metric_batches}; the worker issued batches for "
          f"{server.batcher.dispatch_s:.3f}s and waited on readback for "
          f"{server.batcher.readback_s:.3f}s (warm-up included); replies vs --serve's max |d| "
          f"{err_http:.3e} (tol 1e-06: 6 printed decimals); launches {launches} from the "
          f"MicroBatcher's worker thread ({layers} x {batches} batches)")
    if err_http > 1e-6 or metric_batches != server.batcher.batches or n_scored != (
            c["clients"] * c["per_client"] - 1 + sb):
        raise AssertionError("HTTP replies or counters wrong")
    del model
    torch.cuda.empty_cache()

    # 5. --eval --decode_cache twice: both score files equal the run without it
    cache = os.path.join(tmp, "decode_cache")
    for run in (1, 2):
        out = os.path.join(tmp, f"eval_cache{run}.txt")
        K.reset_launches()
        t0 = time.perf_counter()
        if cli.main(eval_flags + ["--decode_cache", cache, "--eval_output", out]) != 0:
            raise AssertionError("--eval --decode_cache exited non-zero")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect("--eval --decode_cache", dict(K.LAUNCHES), math.ceil(len(utts) / sb), None)
        with open(out) as f:
            same = f.read() == ev_text
        print(f"[serve] --eval --decode_cache run {run}: {wall:.2f}s wall ("
              f"{'builds' if run == 1 else 'reads'} {sorted(os.listdir(cache))}); score file "
              f"equal to the run without a cache: {same}")
        if not same:
            raise AssertionError("--decode_cache changed the score file")
    print(f"[serve] phase in {time.perf_counter() - t_phase:.2f}s; launches {by_path}")
    return by_path, {"stdin_utt_s": len(requests) / window, "http_utt_s": n_scored / http_wall,
                     "p50_ms": float(np.percentile(lat, 50)),
                     "p99_ms": float(np.percentile(lat, 99)),
                     "rows_per_batch": n_scored / batches,
                     "dispatch_s": server.batcher.dispatch_s,
                     "readback_s": server.batcher.readback_s, "codec": codec}


# the feature encoder's shapes: eval and serving, and a conf-3 step's 2 x 11 views
CONV_SHAPES = ((16, 64600), (22, 64000))
CONV_IMPLS = ("conv", "gemm", "phase")


def _best_ms(fn, calls=2, iters=10):
    return min(cuda_ms(fn, iters=iters, warmup=3) for _ in range(calls))


def _grad_ms(fwd, x, params):
    """ms of the data gradient alone (``params`` frozen) and of the data
    and weight gradients together, for one output gradient."""
    out = {}
    for label, train in (("dgrad_ms", False), ("bwd_ms", True)):
        for p in params:
            p.requires_grad_(train)
        xg = x.detach().requires_grad_()
        y = fwd(xg)
        gy = torch.randn_like(y)
        wrt = [xg] + (list(params) if train else [])
        out[label] = _best_ms(lambda: torch.autograd.grad(y, wrt, gy, retain_graph=True))
        del xg, y, gy
    for p in params:
        p.requires_grad_(False)
    return out


def _conv_layer_times(X, block, x, k, s, bf16):
    """Forward, data-gradient and data-plus-weight-gradient ms of one
    feature-encoder conv under each impl, and each impl's output."""
    times, outs = {}, {}
    params = [p for p in block.conv.parameters()]
    for impl in CONV_IMPLS:
        fn = X.CONV_IMPLS[impl]

        def fwd(x=x, fn=fn):
            if fn is None:
                return block.conv(x, stride=s, compute_dtype=bf16)
            return fn(block.conv, x, k, s, bf16)

        with torch.no_grad():
            outs[impl] = fwd().float()
            f_ms = _best_ms(fwd)
        times[impl] = {"fwd_ms": f_ms, **_grad_ms(fwd, x, params)}
    return times, outs


def phase_conv_impls(K, card):
    """The feature encoder's convs under conv_impl 'conv' (cuDNN), 'gemm'
    (patches and one cuBLAS product) and 'phase' (k accumulated products)
    at XLS-R 300M bf16, seeded random weights: per conv, forward, data
    gradient and data-plus-weight gradient ms (CUDA events, best of two),
    at [16, 64600] and [22, 64000], and the positional conv's beside them;
    the three impls' outputs per conv and their scores at [16, 64600]
    (within 5e-2), with ms per forward; then one conf-3 step (remat 'attn')
    with 'conv', fuse_qkv, 'gemm' and 'phase', ms of the better of steps 2
    and 3 and 48 / 24 / 24 launches a step."""
    from scl_deepfake_audio_detection_torch.models import xlsr as X
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.ops.layers import gelu
    from scl_deepfake_audio_detection_torch.train.engine import Engine, score_step
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig, load_config

    t_phase = time.perf_counter()
    bf16, seed = torch.bfloat16, 1234
    cfg = load_config(EVAL_CONFIG)
    model = cast_matmul_params(LinearNLL.from_config(
        cfg.model, ssl=X.XLSRConfig.xlsr_300m(compute_dtype="bfloat16"), device="cuda",
        seed=seed).eval(), bf16)
    model.requires_grad_(False)
    ssl = model.ssl
    g = torch.Generator(device="cuda").manual_seed(5)
    table, pos_table = [], {}
    for b, n in CONV_SHAPES:
        x = (0.1 * torch.randn(b, n, generator=g, device="cuda"))[..., None].to(bf16)
        for i, (block, (_, k, s)) in enumerate(zip(ssl.feature_extractor.convs,
                                                   ssl.cfg.conv_layers)):
            times, outs = _conv_layer_times(X, block, x, k, s, bf16)
            scale = outs["conv"].abs().max().item()
            err = {impl: (outs[impl] - outs["conv"]).abs().max().item() / scale
                   for impl in ("gemm", "phase")}
            row = {"shape": [b, n], "layer": i, "kernel": k, "stride": s,
                   "in": list(x.shape), **times, "rel_err_vs_conv": err}
            table.append(row)
            print(f"[conv] {card}: [{b}, {n}] conv {i} (k {k}, s {s}, in {list(x.shape)}): "
                  + "; ".join(f"{impl} fwd {times[impl]['fwd_ms']:.4f} ms, dgrad "
                              f"{times[impl]['dgrad_ms']:.4f} ms, dgrad+wgrad "
                              f"{times[impl]['bwd_ms']:.4f} ms" for impl in CONV_IMPLS)
                  + f"; max |impl - conv| / max |conv|: gemm {err['gemm']:.2e}, phase "
                    f"{err['phase']:.2e}")
            if max(err.values()) > 1e-2:  # one bf16 rounding of the output, and the bias
                raise AssertionError(f"conv {i}: an impl disagrees with 'conv': {err}")
            with torch.no_grad():
                x = gelu(block.ln(block.conv(x, stride=s, compute_dtype=bf16)).to(bf16),
                         ssl.cfg.approx_gelu)
            del outs
        # the positional conv (k 128, 16 groups; no conv_impl applies to it)
        # on this shape's frames, for where the rest of the conv time goes
        with torch.no_grad():
            h = ssl.proj(ssl.post_extract_ln(x), bf16).to(bf16)
        pos = {}
        with torch.no_grad():
            pos["fwd_ms"] = _best_ms(lambda: ssl.pos_conv_embed(h))
        pos.update(_grad_ms(ssl.pos_conv_embed, h, list(ssl.pos_conv.parameters())))
        pos_table[f"{b}x{n}"] = pos
        print(f"[conv] {card}: [{b}, {n}] positional conv (k {ssl.cfg.pos_conv_kernel}, groups "
              f"{ssl.cfg.pos_conv_groups}, in {list(h.shape)}): fwd {pos['fwd_ms']:.4f} ms, "
              f"dgrad {pos['dgrad_ms']:.4f} ms, dgrad+wgrad {pos['bwd_ms']:.4f} ms")
        del h
        torch.cuda.empty_cache()
    totals = {f"{b}x{n}": {impl: {m: sum(r[impl][m] for r in table if r["shape"] == [b, n])
                                  for m in ("fwd_ms", "dgrad_ms", "bwd_ms")}
                           for impl in CONV_IMPLS}
              for b, n in CONV_SHAPES}
    print(f"[conv] {card}: sum over the 7 convs {json.dumps(totals)}")

    wav = 0.1 * torch.randn(16, 64600, generator=g, device="cuda")
    scores, fwd_ms = {}, {}
    for impl in CONV_IMPLS:
        ssl.cfg = ssl.cfg.with_(conv_impl=impl)
        scores[impl] = score_step(model, wav).float()
        fwd_ms[impl] = _best_ms(lambda: score_step(model, wav), iters=5)
    ssl.cfg = ssl.cfg.with_(conv_impl="conv")
    err = {impl: (scores[impl] - scores["conv"]).abs().max().item() for impl in ("gemm", "phase")}
    print(f"[conv] {card}: [16, 64600] score_step, ms a forward: "
          + ", ".join(f"{impl} {fwd_ms[impl]:.3f} ({16 / fwd_ms[impl] * 1e3:.2f} utt/s)"
                      for impl in CONV_IMPLS)
          + f"; scores vs 'conv': gemm {err['gemm']:.3e}, phase {err['phase']:.3e} "
            f"(tol {MAIN_PATH_ATOL:.0e})")
    if max(err.values()) > MAIN_PATH_ATOL or not torch.isfinite(scores["conv"]).all():
        raise AssertionError(f"conv impls' scores disagree: {err}")
    del model
    torch.cuda.empty_cache()

    c = CONF3
    layers = X.XLSRConfig.xlsr_300m().encoder_layers
    want = {"flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
            "flash_attn_bwd_dkv": layers}
    batch = conf3_batches(1, c["seed"])[0]
    steps = {}
    for label, kw in (("conv", {}), ("fuse_qkv", {"fuse_qkv": True}),
                      ("gemm", {"conv_impl": "gemm"}), ("phase", {"conv_impl": "phase"})):
        eng = Engine(LinearNLL(ssl=X.XLSRConfig.xlsr_300m(compute_dtype="bfloat16", remat=True,
                                                          **kw), device="cuda", seed=c["seed"]),
                     TrainConfig(seed=c["seed"]))
        eng.init_state()
        placed = eng.place_batch(batch)
        ms, losses = [], []
        for i in range(3):
            K.reset_launches()
            t0 = time.perf_counter()
            losses.append(float(eng.train_step(placed, eng.step_generator(0, i))["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            if dict(K.LAUNCHES) != want or not np.isfinite(losses[-1]):
                raise AssertionError(f"step '{label}': launches {dict(K.LAUNCHES)}, "
                                     f"loss {losses[-1]}")
        steps[label] = {"ms": min(ms[1:]), "losses": losses}
        print(f"[conv] {card}: conf-3 step [{c['groups']}, {c['views']}, {c['samples']}] bf16 "
              f"remat 'attn', {label}: steps 2 and 3 {ms[1]:.2f} / {ms[2]:.2f} ms (loss read "
              f"back), losses {', '.join(f'{v:.6g}' for v in losses)}, launches a step {want}")
        del eng, placed
        torch.cuda.empty_cache()
    print(f"[conv] phase in {time.perf_counter() - t_phase:.2f}s")
    return {"per_conv": table, "sums": totals, "pos_conv": pos_table, "forward_ms": fwd_ms,
            "score_err": err,
            "train_step_ms": {k: v["ms"] for k, v in steps.items()}}


def phase_export(K, card, tmp):
    """The scoring artifact at XLS-R 300M's widths bf16 (``main`` cuts the
    depth: ``cut_depth``), seeded random weights, on ``phase_eval_modes``'
    database: ``--export_model`` (fp and int8, the program recorded on the
    card), ``--verify_export`` (the fp artifact passes at --parity_tol),
    ``--eval --from_export`` with cm1 within 1e-3 of ``--eval``, ``--serve
    --from_export`` on 48 requests; the flash forward launched exactly once
    a layer per forward of the exported program
    in both, and in-process the artifact's utt/s beside ``score_step``'s on
    a [16, 64600] batch on the card."""
    from scl_deepfake_audio_detection_torch import cli
    from scl_deepfake_audio_detection_torch.cli import serve as serve_mod
    from scl_deepfake_audio_detection_torch.export import ExportedScorer, load_scorer
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.config import load_config

    t_phase = time.perf_counter()
    seed, sb = 1234, SERVE["batch"]
    layers = XLSRConfig.xlsr_300m().encoder_layers
    db = os.path.join(tmp, "db")
    utts, _ = _eval_modes_database(db)
    model_flags = ["--config", EVAL_CONFIG, "--ssl_preset", "xlsr_300m",
                   "--compute_dtype", "bfloat16", "--seed", str(seed), "--device", "cuda"]
    fwd_only = {name: 0 for name in K.KERNELS}
    by_path = {}

    def expect(label, forwards):
        want = dict(fwd_only, flash_attn_fwd=layers * forwards)
        if dict(K.LAUNCHES) != want:
            raise AssertionError(f"{label}: launched {dict(K.LAUNCHES)}, expected {want}")
        by_path[label] = dict(K.LAUNCHES)

    def run(label, argv):
        K.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        return rc, time.perf_counter() - t0

    arts = {"fp": os.path.join(tmp, "art"), "int8": os.path.join(tmp, "art8")}
    for tag, path in arts.items():
        quant = ["--export_quant", "int8"] if tag == "int8" else []
        rc, wall = run(tag, model_flags + ["--export_model", path] + quant)
        sizes = {f: os.path.getsize(os.path.join(path, f)) for f in sorted(os.listdir(path))}
        print(f"[export] {card}: --export_model ({tag}) in {wall:.2f}s (model build included): "
              f"{sizes} bytes, launches {dict(K.LAUNCHES)}")
        if rc != 0 or sizes["scorer.pt2"] > 64 * 2**20:
            raise AssertionError(f"--export_model ({tag}) exited {rc}, files {sizes}")
    verify = {}
    for tag, path in arts.items():
        rc, wall = run(tag, model_flags + ["--verify_export", path])
        verify[tag] = rc
        print(f"[export] --verify_export ({tag}) exit {rc} in {wall:.2f}s")
    if verify["fp"] != 0:
        raise AssertionError("--verify_export of the fp artifact failed")

    ev = {}
    forwards = math.ceil(len(utts) / sb)
    for tag, extra in (("model", model_flags), ("artifact", [
            "--from_export", arts["fp"], "--device", "cuda"])):
        out = os.path.join(tmp, f"eval_{tag}.txt")
        rc, wall = run(tag, extra + ["--eval", "--config", EVAL_CONFIG, "--database_path", db,
                                     "--batch_size", str(sb), "--num_workers", "4",
                                     "--eval_output", out])
        if rc != 0:
            raise AssertionError(f"--eval ({tag}) exited {rc}")
        expect(f"eval_{tag}", forwards)
        ev[tag] = {r[0]: float(r[2]) for r in _read_rows(out)}
        print(f"[export] --eval ({tag}) {len(utts)} utts in {wall:.2f}s wall, launches "
              f"{dict(K.LAUNCHES)} ({layers} x {forwards} forwards)")
    eval_err = max(abs(ev["artifact"][u] - ev["model"][u]) for u in utts)
    print(f"[export] --eval --from_export vs --eval: max |d cm1| {eval_err:.3e} (tol 1e-3)")
    if sorted(ev["artifact"]) != sorted(ev["model"]) or eval_err > 1e-3:
        raise AssertionError("--eval --from_export disagrees with --eval")

    paths = [os.path.join(db, u) for u in utts]
    requests = paths + paths[:16]
    lines = [f"{os.path.basename(p)}\t{p}" for p in requests]
    replies, wall, fwd, launches, window = _stdin_serve(
        K, cli, serve_mod, ["--from_export", arts["fp"], "--device", "cuda", "--config",
                            EVAL_CONFIG, "--serve", "--serve_batch", str(sb)], lines,
        target=(ExportedScorer, "score_tensor"))
    expect("serve_artifact", fwd)
    serve_err = max(abs(float(v) - ev["model"][k]) for k, v in replies)
    print(f"[export] {card}: --serve --from_export: {len(requests)} requests, {fwd} forwards "
          f"of [{sb}, 64600] in {window:.3f}s ({len(requests) / window:.2f} utt/s), "
          f"{wall:.2f}s wall; launches {launches}; replies vs --eval's cm1 max |d| "
          f"{serve_err:.3e} (tol 1e-3)")
    if (len(replies) != len(requests) or fwd != len(requests) // sb
            or serve_err > 1e-3):
        raise AssertionError("--serve --from_export replies wrong")

    # in-process: one [16, 64600] batch on the card through the artifact
    # and through score_step on the same weights
    cfg = load_config(EVAL_CONFIG)
    model = cast_matmul_params(LinearNLL.from_config(
        cfg.model, ssl=XLSRConfig.xlsr_300m(compute_dtype="bfloat16"), device="cuda",
        seed=seed).eval(), torch.bfloat16)
    scorers = {tag: load_scorer(path, device="cuda") for tag, path in arts.items()}
    wav = 0.1 * torch.randn(sb, 64600, generator=torch.Generator(device="cuda").manual_seed(9),
                            device="cuda")
    K.reset_launches()
    got = scorers["fp"].score_tensor(wav).float()
    torch.cuda.synchronize()
    expect("artifact_forward", 1)
    want = score_step(model, wav).float()
    q = scorers["int8"].score_tensor(wav).float()
    ms = {}
    for turn in ("model", "artifact", "artifact", "model"):
        fn = ((lambda: score_step(model, wav)) if turn == "model"
              else (lambda: scorers["fp"].score_tensor(wav)))
        ms[turn] = min(ms.get(turn, float("inf")), _best_ms(fn, calls=1, iters=10))
    in_err = (got - want).abs().max().item()
    q_err = (q - want).abs().max().item()
    stats = {"artifact_utt_s": sb / ms["artifact"] * 1e3, "score_step_utt_s": sb / ms["model"] * 1e3,
             "artifact_ms": ms["artifact"], "score_step_ms": ms["model"],
             "artifact_vs_score_step": in_err, "int8_vs_score_step": q_err,
             "verify_int8_rc": verify["int8"], "eval_err": eval_err, "serve_err": serve_err}
    print(f"[export] {card}: [{sb}, 64600] on the card: artifact {ms['artifact']:.3f} ms a "
          f"forward ({stats['artifact_utt_s']:.2f} utt/s), score_step {ms['model']:.3f} ms "
          f"({stats['score_step_utt_s']:.2f} utt/s), in turns; artifact vs score_step max |d| "
          f"{in_err:.3e}, int8 artifact {q_err:.3e}; {layers} launches per artifact forward")
    if in_err > 1e-3:
        raise AssertionError("the artifact disagrees with score_step on the card")
    del model, scorers
    torch.cuda.empty_cache()
    print(f"[export] phase in {time.perf_counter() - t_phase:.2f}s")
    return by_path, stats


def phase_reference_ckpt(K, card, tmp):
    """The reference ``epoch_N.pth`` surface at XLS-R 300M's widths (``main``
    cuts the depth: ``cut_depth``): the seeded
    model as a ``.ckpt``; ``--export_reference_ckpt`` of it; ``--eval``
    from the ``.pth``, from the ``.ckpt`` (every leaf equal but the
    positional conv's kernel, which the weight-norm split and contraction
    may move by one fp32 ulp; scores within 1e-4) and from a ``.ckpt`` of
    the ``.pth``'s own leaves (scores identical to the ``.pth``'s: the load
    is exact); ``--parity_check`` against
    the ``.pth``'s score file (PASS, exit 0), then against a copy with one
    row moved by 0.5 (FAIL, exit 1)."""
    from scl_deepfake_audio_detection_torch import cli
    from scl_deepfake_audio_detection_torch.models import convert
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.params import to_jax
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.utils.config import load_config
    from scl_deepfake_audio_detection_torch.utils.tree import flatten

    t_phase = time.perf_counter()
    seed, sb = 1234, SERVE["batch"]
    layers = XLSRConfig.xlsr_300m().encoder_layers
    db = os.path.join(tmp, "db")
    utts, _ = _eval_modes_database(db)
    cfg = load_config(EVAL_CONFIG)
    model = LinearNLL.from_config(cfg.model, ssl=XLSRConfig.xlsr_300m(), device="cuda",
                                  seed=seed)
    tree = to_jax(model)
    del model
    own = os.path.join(tmp, "model.ckpt")
    pth = os.path.join(tmp, "epoch_0.pth")
    ckpt.save(own, {"params": tree})
    flags = ["--config", EVAL_CONFIG, "--ssl_preset", "xlsr_300m", "--compute_dtype",
             "bfloat16", "--device", "cuda", "--database_path", db, "--batch_size", str(sb),
             "--num_workers", "4"]
    t0 = time.perf_counter()
    if cli.main(flags + ["--model_path", own, "--export_reference_ckpt", pth]) != 0:
        raise AssertionError("--export_reference_ckpt exited non-zero")
    print(f"[refckpt] --export_reference_ckpt of a {layers}-layer 300M-wide .ckpt "
          f"({os.path.getsize(own)} bytes) "
          f"-> {os.path.getsize(pth)} bytes in {time.perf_counter() - t0:.2f}s")
    back, _ = convert.from_reference_model_checkpoint(
        ckpt.load_reference_head_checkpoint(pth), like=XLSRConfig.xlsr_300m())
    a, b = flatten(tree), flatten(back)
    moved = {k: int((a[k] != b[k]).sum()) for k in a if not np.array_equal(a[k], b[k])}
    ulps = max((int(np.abs(a[k].view(np.int32).astype(np.int64)
                           - b[k].view(np.int32).astype(np.int64)).max()) for k in moved),
               default=0)
    print(f"[refckpt] leaves of the .pth vs the .ckpt: {len(a)} leaves, those that differ "
          f"{moved} (elements), by at most {ulps} fp32 ulp")
    if sorted(a) != sorted(b) or set(moved) - {"ssl//pos_conv//w"} or ulps > 1:
        raise AssertionError("the reference .pth does not give the .ckpt's weights back")
    own_of_pth = os.path.join(tmp, "pth_leaves.ckpt")
    ckpt.save(own_of_pth, {"params": back})
    del tree, back, a, b

    rows = {}
    for tag, path in (("ckpt", own), ("pth", pth), ("pth_leaves", own_of_pth)):
        out = os.path.join(tmp, f"{tag}.txt")
        K.reset_launches()
        t0 = time.perf_counter()
        if cli.main(flags + ["--eval", "--model_path", path, "--eval_output", out]) != 0:
            raise AssertionError(f"--eval --model_path {tag} exited non-zero")
        torch.cuda.synchronize()
        if K.LAUNCHES["flash_attn_fwd"] != layers * math.ceil(len(utts) / sb):
            raise AssertionError(f"--eval {tag}: launches {dict(K.LAUNCHES)}")
        rows[tag] = {r[0]: (float(r[1]), float(r[2])) for r in _read_rows(out)}
        print(f"[refckpt] --eval --model_path {os.path.basename(path)}: {len(rows[tag])} utts "
              f"in {time.perf_counter() - t0:.2f}s")
    d = max(abs(x - y) for u in utts for x, y in zip(rows["pth"][u], rows["ckpt"][u]))
    same = rows["pth"] == rows["ckpt"]
    exact = rows["pth"] == rows["pth_leaves"]
    print(f"[refckpt] scores from the .pth vs the .ckpt: identical {same}, max |d| {d:.3e} "
          f"(tol 1e-4); vs a .ckpt of the .pth's own leaves: identical {exact}")
    if d > 1e-4 or not exact:
        raise AssertionError("the reference .pth scores differently")

    scores = os.path.join(tmp, "pth.txt")
    check = flags + ["--model_path", pth, "--parity_tol", "1e-4", "--parity_check"]
    rc_pass = cli.main(check + [scores])
    lines = open(scores).read().strip().splitlines()
    parts = lines[2].split()
    parts[2] = str(float(parts[2]) + 0.5)
    bad = os.path.join(tmp, "bad.txt")
    with open(bad, "w") as f:
        f.write("\n".join(lines[:2] + [" ".join(parts)] + lines[3:]) + "\n")
    rc_fail = cli.main(check + [bad])
    print(f"[refckpt] --parity_check against the .pth's scores: exit {rc_pass}; against a "
          f"copy with {parts[0]} moved by 0.5: exit {rc_fail}")
    if (rc_pass, rc_fail) != (0, 1):
        raise AssertionError("--parity_check did not pass, then fail")
    print(f"[refckpt] phase in {time.perf_counter() - t_phase:.2f}s")
    return {"scores_identical": same, "max_abs": d, "pth_leaves_identical": exact,
            "pos_conv_elements_moved": moved,
            "parity_rc": [rc_pass, rc_fail]}


def _fwd_entry(K, A, shape, card, g, KB=None):
    """The forward kernel at ``shape`` bf16 against its plain version and
    the sdpa yardstick (pinned to its flash backend), and its bound; with
    ``KB``, the earlier build's kernel too."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q = (torch.randn(shape, device="cuda", generator=g) * shape[-1] ** -0.5).bfloat16()
    k = torch.randn(shape, device="cuda", generator=g).bfloat16()
    v = torch.randn(shape, device="cuda", generator=g).bfloat16()
    o, lse = K.flash_attn_fwd(q, k, v)
    ro, rlse = A.flash_attention_forward_reference(q, k, v)
    err = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    tol = TOL[torch.bfloat16]
    print(f"[kernel] flash_attn_fwd at {list(shape)} bf16: O err {err:.3e} "
          f"(tol {tol['o']:.0e})  LSE err {err_lse:.3e} (tol {tol['lse']:.0e})")
    if err > tol["o"] or err_lse > tol["lse"]:
        raise AssertionError(f"kernel disagrees with its plain version at {list(shape)}")
    plain1 = cuda_ms(lambda: A.flash_attention_forward_reference(q, k, v))
    times = time_kernel(lambda: K.flash_attn_fwd(q, k, v),
                        KB and (lambda: KB.flash_attn_fwd(q, k, v)))
    plain2 = cuda_ms(lambda: A.flash_attention_forward_reference(q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)  # noqa: E731
        eager = cuda_ms(sdpa)
        lib = min(graph_ms(sdpa) for _ in range(2))
    b, h, t, d = shape
    nbytes = 4 * q.numel() * q.element_size() + b * h * t * 4  # q, k, v, O + LSE
    bound, by, detail = _bound(nbytes, 4 * b * h * t * t * d)
    print(f"[times] {card}: flash_attn_fwd {list(shape)} bf16: {timing_line(times)}, "
          f"plain {plain1:.4f}/{plain2:.4f} ms, "
          f"sdpa (flash backend, graphed, best of 2) {lib:.4f} ms (eager {eager:.4f} ms), "
          f"bound {bound:.4f} ms ({detail})")
    return {"shape": list(shape), "max_abs_err": err, **times,
            "plain_ms": min(plain1, plain2), "bound_ms": bound, "bound_by": by,
            "library_ms": lib}


def phase_times(K, A, card, KB=None):
    """The forward kernel at the eval shape, then eval throughput."""
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.engine import score_step

    g = torch.Generator(device="cuda").manual_seed(1)
    entry = _fwd_entry(K, A, MAIN_SHAPE, card, g, KB)
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
    return entry


def _bwd_inputs(shape, dtype, g):
    q = (torch.randn(shape, device="cuda", generator=g) * shape[-1] ** -0.5).to(dtype)
    k, v, do = (torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(3))
    return q, k, v, do


def _bwd_check(K, A, q, k, v, do, kv_len):
    """Both backward kernels against their plain versions on one input: dq
    and D from the dq kernel, dk and dv from the dk/dv kernel fed that D.
    Returns ({kernel: its worst error}, message, D's error) and fails on a
    tolerance or on a non-zero dk/dv row past kv_len."""
    o, lse = K.flash_attn_fwd(q, k, v, kv_len)
    dq, delta = K.flash_attn_bwd_dq(q, k, v, o, do, lse, kv_len)
    got = (dq, *K.flash_attn_bwd_dkv(q, k, v, do, lse, delta, kv_len))
    torch.cuda.synchronize()
    want_dq, want_delta = A.flash_bwd_dq_delta_reference(q, k, v, o, do, lse, kv_len)
    want = (want_dq, *A.flash_bwd_dkv_reference(q, k, v, do, lse, want_delta, kv_len))
    err_delta = (delta - want_delta).abs().max().item()
    tol = tol_delta(o, do)
    msgs = [f"D {err_delta:.3e} (tol {tol:.1e})"]
    if err_delta > tol:
        raise AssertionError(f"D from the dq kernel disagrees with torch's ({q.dtype}, "
                             f"{tuple(q.shape)}, kv_len={kv_len})")
    errs = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        tol = TOL_BWD[q.dtype](b.float())
        msgs.append(f"{name} {err:.3e} (tol {tol:.1e})")
        if err > tol:
            raise AssertionError(f"{name} kernel disagrees with its plain version "
                                 f"({q.dtype}, {tuple(q.shape)}, kv_len={kv_len})")
        errs[name] = err
    dead = 0.0
    if kv_len is not None and kv_len < q.shape[2]:
        dead = max(got[1][:, :, kv_len:].abs().max().item(),
                   got[2][:, :, kv_len:].abs().max().item())
        if dead != 0.0:
            raise AssertionError("dk/dv rows past kv_len are not exactly 0")
    worst = {"flash_attn_bwd_dq": errs["dq"], "flash_attn_bwd_dkv": max(errs["dk"], errs["dv"])}
    return worst, "  ".join(msgs) + f"  |dk, dv past kv_len| {dead}", err_delta


def phase_backward_vs_plain(K, A):
    g = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        for (b, h, d), t in ((bhd, t) for bhd in HEAD_SHAPES for t in (199, 201, 1024)):
            for kv_len in (None, t - 13):
                inputs = _bwd_inputs((b, h, t, d), dtype, g)
                _, msg, _ = _bwd_check(K, A, *inputs, kv_len)
                print(f"[backward] {str(dtype):15s} H={h:2d} D={d:3d} T={t:5d} "
                      f"kv_len={kv_len!s:5s} {msg}  ok")


def phase_autograd(K, A):
    """torch.autograd through self_attention on the card (the three kernels)
    against torch.autograd through attention_reference."""
    g = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.bfloat16, torch.float32):
        for t, kv_len in ((199, None), (201, 188)):
            q, k, v, do = _bwd_inputs((2, 16, t, 64), dtype, g)
            grads = {}
            for impl in ("auto", "reference"):
                x = [a.clone().requires_grad_() for a in (q, k, v)]
                K.reset_launches()
                out = A.self_attention(*x, kv_len=kv_len, impl=impl)
                grads[impl] = torch.autograd.grad(out, x, do)
                torch.cuda.synchronize()
                n = dict(K.LAUNCHES)
                want = 1 if impl == "auto" else 0
                if any(c != want for c in n.values()):
                    raise AssertionError(f"impl={impl} launched {n}")
            msgs = []
            for name, a, b in zip(("dq", "dk", "dv"), grads["auto"], grads["reference"]):
                err = (a.float() - b.float()).abs().max().item()
                tol = TOL_GRAD[dtype](b.float())
                msgs.append(f"{name} {err:.3e} (tol {tol:.1e})")
                if err > tol:
                    raise AssertionError(f"autograd {name} disagrees ({dtype}, T={t})")
            print(f"[autograd] {str(dtype):15s} T={t:5d} kv_len={kv_len!s:5s} "
                  f"{'  '.join(msgs)}  ok")


def phase_memory(A):
    """Forward plus backward at T = 4096 must not hold a [T, T] tensor."""
    shape = (1, 16, 4096, 64)
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = _bwd_inputs(shape, torch.bfloat16, g)
    x = [a.requires_grad_() for a in (q, k, v)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads = torch.autograd.grad(A.self_attention(*x), x, do)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    limit = shape[1] * shape[2] ** 2 * 4  # one fp32 [H, T, T] score tensor
    print(f"[memory] {list(shape)} bf16 forward + backward: peak {peak / 2**20:.1f} MiB "
          f"above the inputs (limit {limit / 2**20:.0f} MiB, one fp32 [T, T] score "
          f"tensor)")
    if peak >= limit or not all(torch.isfinite(a).all() for a in grads):
        raise AssertionError("flash backward at T=4096 held a [T, T]-sized buffer")


def _golden_train_batches(n=3):
    rng = np.random.default_rng(20240817)
    labels = np.tile([1.0, 1.0, 0.0, 0.0], (2, 1)).astype(np.float32)
    return [{"wav": (0.2 * rng.normal(size=(2, 4, 8000))).astype(np.float32),
             "labels": labels} for _ in range(n)]


def phase_golden_train(K):
    """Three train steps from the golden checkpoint (tiny, fp32, TF32 off)
    through the kernels against impl='reference', then a train-state round
    trip."""
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train.engine import Engine, score_step
    from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

    tree = ckpt.load(GOLDEN_CKPT)[0]["params"]
    batches = _golden_train_batches()
    cfg = TrainConfig(seed=7)
    runs = {}
    for impl in ("auto", "reference"):
        model = LinearNLL(ssl=XLSRConfig.tiny(attention_impl=impl), emb_dim=16, device="cuda")
        eng = Engine(model, cfg)
        eng.init_state(params=tree)
        set_learning_rate(eng.optimizer, 1e-4)
        K.reset_launches()
        metrics = eng.run_epoch(batches, epoch=0)
        torch.cuda.synchronize()
        runs[impl] = (eng, metrics, dict(K.LAUNCHES))
    (eng, m_k, n_k), (eng_r, m_r, n_r) = runs["auto"], runs["reference"]
    layers = eng.model.ssl.cfg.encoder_layers
    want_k = {name: layers * len(batches) for name in K.KERNELS}
    if n_k != want_k or any(n_r.values()):
        raise AssertionError(f"golden train launches {n_k} (want {want_k}), "
                             f"reference {n_r}")
    err_m = max(abs(m_k[k] - m_r[k]) for k in m_r)
    ref_params = dict(eng_r.model.named_parameters())
    err_p = max((p - ref_params[n]).abs().max().item()
                for n, p in eng.model.named_parameters() if not n.endswith("attn.k.bias"))
    finite = all(np.isfinite(v) for v in m_k.values())
    print(f"[golden-train] 3 steps, tiny fp32: loss {m_k['loss']:.6f} (kernels) vs "
          f"{m_r['loss']:.6f} (reference); max |metric diff| {err_m:.3e}, max |param "
          f"diff| {err_p:.3e} (tol {TRAIN_ATOL:.0e}); launches {n_k}")
    if not finite or err_m > TRAIN_ATOL or err_p > TRAIN_ATOL:
        raise AssertionError("golden train steps through the kernels disagree with "
                             "impl='reference'")

    wav = batches[0]["wav"].reshape(8, -1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "last.ckpt")
        ckpt.save_train_state(path, eng.model, eng.optimizer, 0, cfg.seed, 90.0)
        other = Engine(LinearNLL(ssl=XLSRConfig.tiny(), emb_dim=16, device="cuda"), cfg)
        other.init_state()
        epoch, best, _ = ckpt.load_train_state(path, other.model, other.optimizer)
    same = torch.equal(score_step(eng.model, wav), score_step(other.model, wav))
    sa, sb = eng.optimizer.state_arrays(), other.optimizer.state_arrays()
    same_opt = sorted(sa) == sorted(sb) and all(
        torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa)
    print(f"[golden-train] train state saved and loaded: epoch {epoch}, best {best}, "
          f"identical scores {same}, identical optimizer state {same_opt}")
    if not (same and same_opt):
        raise AssertionError("train-state round trip changed the model")


def conf3_batches(n, seed):
    """conf-3 view batches: G groups of 5 bonafide and 6 spoof views."""
    c = CONF3
    rng = np.random.default_rng(seed)
    labels = np.tile(np.array([1.0] * 5 + [0.0] * 6, np.float32), (c["groups"], 1))
    return [{"wav": (0.1 * rng.normal(size=(c["groups"], c["views"], c["samples"])))
             .astype(np.float32), "labels": labels} for _ in range(n)]


def phase_train_main_path(K, card):
    """Engine.fit of the conf-3 model for one epoch, then ms per step."""
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.engine import Engine
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

    c = CONF3
    cfg = TrainConfig(num_epochs=1, seed=c["seed"])  # bf16 and remat are its defaults
    ssl = XLSRConfig.xlsr_300m(compute_dtype=cfg.compute_dtype, remat=cfg.remat,
                               remat_policy="attn")
    eng = Engine(LinearNLL(ssl=ssl, device="cuda", seed=c["seed"]), cfg)
    eng.init_state()
    train, dev = conf3_batches(c["steps"], c["seed"]), conf3_batches(1, c["seed"] + 1)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = eng.fit(lambda: train, lambda: dev, save_dir=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    # remat 'attn' recomputes the attention block, flash forward included, in
    # the backward: 2 forward launches per layer per train step, 1 per dev
    # forward; one dq and one dkv launch per layer per train step
    layers, steps = ssl.encoder_layers, c["steps"]
    want = {"flash_attn_fwd": 2 * layers * steps + layers,
            "flash_attn_bwd_dq": layers * steps, "flash_attn_bwd_dkv": layers * steps}
    rec = records[0] if records else {}
    nums = {k: v for k, v in rec.items() if isinstance(v, float)}
    print(f"[train] Engine.fit XLS-R 300M + LinearNLL bf16 remat 'attn', "
          f"{steps} steps of [{c['groups']}, {c['views']}, {c['samples']}] + 1 dev batch "
          f"in {wall:.2f}s (incl. first-step set-up): " + ", ".join(
              f"{k} {v:.6g}" for k, v in nums.items()))
    print(f"[train] launches {launches}, expected {want}")
    if len(records) != 1 or not all(np.isfinite(v) for v in nums.values()):
        raise AssertionError(f"non-finite or missing training metrics: {rec}")
    if launches != want:
        raise AssertionError("the training main path did not launch the kernels as expected")

    # the steps fit takes: head dropout 0.5 drawn from each step's generator
    placed = [eng.place_batch(b) for b in train]
    eng.train_step(placed[0], eng.step_generator(1, 0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 6
    t0 = time.perf_counter()
    for i in range(iters):
        eng.train_step(placed[i % len(placed)], eng.step_generator(1, i + 1))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[times] {card}: train step [{c['groups']}, {c['views']}, {c['samples']}] bf16 "
          f"remat 'attn', batch on the card: {step_ms:.2f} ms/step "
          f"({c['groups'] * c['views'] / step_ms * 1e3:.2f} views/s), peak memory "
          f"{peak / 2**30:.3f} GiB")
    return launches


CLI_DB = dict(train=8, dev=2, min_len=48000, max_len=80000, seed=2024,
              vocoders=("hifigan", "hn-sinc-nsf-hifi", "waveglow"))


def _cli_database(root, config=CONF3_CONFIG, **counts):
    """8 train and 2 dev bonafide anchors of 48000-80000 samples (both the
    pad and the random-crop branch of ``multiview_pad``), three vocoded
    copies of each, two noise files and two decaying RIRs of 0.3-0.5 s, the
    scp lists, and ``config`` (conf-3's YAML) with only its three paths
    changed; ``counts`` overrides ``CLI_DB``'s train and dev counts."""
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

    c = {**CLI_DB, **counts}
    rng = np.random.default_rng(c["seed"])
    n = c["train"] + c["dev"]
    utts = [f"anchor{i:02d}.wav" for i in range(n)]
    lengths = np.linspace(c["min_len"], c["max_len"], n).astype(int)
    rng.shuffle(lengths)
    for u, t in zip(utts, lengths):
        save_wav(os.path.join(root, "bonafide", u), (0.1 * rng.normal(size=t)).astype(np.float32))
        for v in c["vocoders"]:
            save_wav(os.path.join(root, "vocoded", f"{v}_{u}"),
                     (0.1 * rng.normal(size=t)).astype(np.float32))
    for i, secs in enumerate((0.3, 0.5)):
        t = int(16000 * secs)
        save_wav(os.path.join(root, "musan", f"noise{i}.wav"),
                 (0.05 * rng.normal(size=4 * t)).astype(np.float32))
        decay = np.exp(-np.arange(t) / (0.05 * 16000 * (i + 1)))
        save_wav(os.path.join(root, "rirs", f"rir{i}.wav"),
                 (0.9 * decay * rng.normal(size=t)).astype(np.float32))
    os.makedirs(os.path.join(root, "scp"), exist_ok=True)
    with open(os.path.join(root, "scp", "train_bonafide.lst"), "w") as f:
        f.write("\n".join(utts[:c["train"]]) + "\n")
    with open(os.path.join(root, "scp", "dev_bonafide.lst"), "w") as f:
        f.write("\n".join(utts[c["train"]:]) + "\n")
    return _config_in(root, config), utts


def _config_in(root, config):
    """``config`` written into ``root`` with only its three paths changed
    to the database's noise, RIR and augmentation-cache directories."""
    with open(config) as f:
        text = f.read()
    paths = {"noise_path": os.path.join(root, "musan"), "rir_path": os.path.join(root, "rirs"),
             "aug_dir": os.path.join(root, "aug")}
    for key, value in paths.items():
        lines = [ln for ln in text.splitlines() if ln.strip().startswith(f"{key}:")]
        if len(lines) != 1:
            raise AssertionError(f"{config} has {len(lines)} {key} lines")
        text = text.replace(lines[0], lines[0].split(":")[0] + f": '{value}'")
    cfg = os.path.join(root, os.path.basename(config))
    with open(cfg, "w") as f:
        f.write(text)
    return cfg


def _observed_cli(K, argv):
    """The port's CLI in-process, observed without being changed: its
    engine (to score with its model afterwards), each train step's end,
    each checkpoint write, the launches, the wall time and peak memory."""
    from scl_deepfake_audio_detection_torch import cli
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train import engine as E

    seen = {"engine": None, "step_end": [], "writes": []}
    fit, step, write = E.Engine.fit, E.Engine.train_step, ckpt._write_flat

    def fit_hook(self, *a, **kw):
        seen["engine"] = self
        return fit(self, *a, **kw)

    def step_hook(self, *a, **kw):
        m = step(self, *a, **kw)
        torch.cuda.synchronize()
        seen["step_end"].append(time.perf_counter())
        return m

    def write_hook(path, flat, extra):
        t0 = time.perf_counter()
        write(path, flat, extra)
        seen["writes"].append((os.path.basename(path), time.perf_counter() - t0))

    E.Engine.fit, E.Engine.train_step, ckpt._write_flat = fit_hook, step_hook, write_hook
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        E.Engine.fit, E.Engine.train_step, ckpt._write_flat = fit, step, write
    seen.update(wall=time.perf_counter() - t0, launches=dict(K.LAUNCHES),
                peak=torch.cuda.max_memory_allocated())
    if rc != 0:
        raise AssertionError(f"the training CLI exited {rc}")
    ends = seen["step_end"]
    seen["per_step_ms"] = ((ends[-1] - ends[0]) / (len(ends) - 1) * 1e3 if len(ends) > 1
                           else float("nan"))
    return seen


DEVICE_AUG = dict(groups=2, samples=64000, nb=1024, n_real=1, n_voc=3, seed=77,
                  noise=(4, 128000), rir=(3, 8000))
INT16_ATOL = 4.0  # LSB at int16 amplitude: trunc(x * 32768) of two FFT libraries
SIGNAL_ATOL = 1e-5


def _draws_to(draws, device):
    """A role -> draws dict (``device_pipeline.draw_views``) on ``device``."""
    import dataclasses

    def move(d):
        return type(d)(**{f.name: (move(v) if dataclasses.is_dataclass(v) else
                                   None if v is None else v.to(device))
                          for f in dataclasses.fields(d) for v in (getattr(d, f.name),)})

    return {role: move(d) for role, d in draws.items()}


def _views_close(got, want):
    """Max |difference| of the int16-amplitude rows (peak > 2) and of the
    signal-scale rows; fails past INT16_ATOL or SIGNAL_ATOL."""
    got, want = (x.double().cpu().reshape(-1, x.shape[-1]) for x in (got, want))
    big = want.abs().amax(dim=-1) > 2.0
    diff = (got - want).abs().amax(dim=-1)
    e16 = float(diff[big].max()) if big.any() else 0.0
    esig = float(diff[~big].max()) if (~big).any() else 0.0
    if e16 > INT16_ATOL or esig > SIGNAL_ATOL:
        raise AssertionError(f"views differ: int16 rows {e16:.3g} (atol {INT16_ATOL}), "
                             f"signal rows {esig:.3g} (atol {SIGNAL_ATOL})")
    return e16, esig, int(big.sum())


def phase_device_aug(K, card, host):
    """``--device_aug``: the composer on the card against the composer on
    the CPU on the same inputs and draws, at the training shape, for
    augall_3 in both SNR modes; then the training CLI with --device_aug at
    XLS-R 300M on phase_train_cli's database (``host``: its paths and
    figures), 4 train steps and 1 dev step, launching what the host path
    launches, with the dev pass's views composed again by a fresh composer
    and found identical."""
    from scl_deepfake_audio_detection_torch import cli
    from scl_deepfake_audio_detection_torch.cli.train import _device_composer, composer_seed
    from scl_deepfake_audio_detection_torch.data import device_pipeline as DP
    from scl_deepfake_audio_detection_torch.data import protocols
    from scl_deepfake_audio_detection_torch.data.datasets import (
        SCLViewBatchBuilder, resources_from_config, spec_from_config)
    from scl_deepfake_audio_detection_torch.data.loader import DeviceAugTrainLoader
    from scl_deepfake_audio_detection_torch.dsp import rawboost_batched as RBB
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.utils.config import RawBoostConfig, load_config

    c = DEVICE_AUG
    g, t = c["groups"], c["samples"]
    rng = np.random.default_rng(c["seed"])
    rb = RawBoostConfig()
    anchors = (0.2 * rng.normal(size=(g, t))).astype(np.float32)
    reals = (0.2 * rng.normal(size=(g, c["n_real"], t))).astype(np.float32)
    voc = (0.2 * rng.normal(size=(g, c["n_voc"], t))).astype(np.float32)
    spoofs = np.zeros((g, 0, t), np.float32)
    noise = (0.05 * rng.normal(size=c["noise"])).astype(np.float32)
    rir = (0.2 * np.exp(-np.arange(c["rir"][1]) / 800.0) * rng.normal(size=c["rir"])
           ).astype(np.float32)
    rir[:, 0] = 1.0  # a dominant direct path: one peak index on both sides
    rows = g * (1 + c["n_voc"] + c["n_real"])
    chains = np.stack([RBB.pack_chains(RBB.design_lnl_chains(rb, 16000, rng), c["nb"])
                       for _ in range(rows)]).astype(np.float32)
    inputs = [torch.from_numpy(a) for a in (anchors, reals, voc, spoofs, noise, rir, chains)]
    for mode in ("reference", "rms"):
        draws = DP.draw_views(g, c["n_real"], c["n_voc"], 0, t, inputs[4], inputs[5], rb,
                              "augall_3", mode, torch.Generator().manual_seed(c["seed"]))
        want, labels = DP.compose_views_given(*inputs, draws, rb, "augall_3", mode)
        on_card = [a.cuda() for a in inputs]
        K.reset_launches()
        got, got_labels = DP.compose_views_given(*on_card, _draws_to(draws, "cuda"), rb,
                                                 "augall_3", mode)
        torch.cuda.synchronize()
        if any(K.LAUNCHES.values()) or not torch.equal(got_labels.cpu(), labels):
            raise AssertionError(f"composer launches {dict(K.LAUNCHES)} or labels differ")
        e16, esig, n16 = _views_close(got, want)
        print(f"[device-aug] composer augall_3 '{mode}' [{g}, {got.shape[1]}, {t}] nb "
              f"{c['nb']} (FFT length {t + c['nb']}), card vs CPU on the same draws: int16 "
              f"rows ({n16}) max |diff| {e16:.4g} LSB (atol {INT16_ATOL}), signal rows "
              f"{esig:.3g} (atol {SIGNAL_ATOL})")
    composer = DP.DeviceViewComposer(rb, noise, rir, seed=c["seed"], device="cuda")
    comp_ms = {mode: None for mode in ("reference", "rms")}
    for mode in comp_ms:
        composer.snr_mode = mode
        comp_ms[mode] = cuda_ms(lambda: composer(anchors, reals, voc, 5), iters=10, warmup=2)
    del composer, on_card, got
    torch.cuda.empty_cache()

    # the training CLI with --device_aug on phase_train_cli's database
    out = os.path.join(os.path.dirname(host["db"]), "out_device_aug")
    argv = ["--config", host["config"], "--database_path", host["db"], "--ssl_preset",
            "xlsr_300m", "--compute_dtype", "bfloat16", "--batch_size", "2",
            "--num_epochs", "1", "--device", "cuda", "--out_dir", out, "--device_aug"]
    args = cli.build_parser().parse_args(argv)
    dev_seed = composer_seed(args.seed, -1, 0)
    dev_views = []
    call = DP.DeviceViewComposer.__call__

    def spy(self, anchors, reals, vocoded, step_seed, spoofs=None, variant="augall_3"):
        views, labels = call(self, anchors, reals, vocoded, step_seed, spoofs, variant)
        if step_seed == dev_seed:
            dev_views.append(views.clone())
        return views, labels

    DP.DeviceViewComposer.__call__ = spy
    try:
        seen = _observed_cli(K, argv)
    finally:
        DP.DeviceViewComposer.__call__ = call
    layers = XLSRConfig.xlsr_300m().encoder_layers
    steps, dev_steps = CLI_DB["train"] // 2, -(-CLI_DB["dev"] // 2)
    want = {"flash_attn_fwd": 2 * layers * steps + layers * dev_steps,
            "flash_attn_bwd_dq": layers * steps, "flash_attn_bwd_dkv": layers * steps}
    launches = seen["launches"]
    print(f"[device-aug] {card}: CLI --device_aug, XLS-R 300M widths at {layers} layers bf16 "
          f"remat 'attn', conf-3, "
          f"{steps} steps + {dev_steps} dev step: {seen['wall']:.2f}s wall, "
          f"{seen['per_step_ms']:.2f} ms/step after the first (host path "
          f"{host['per_step_ms']:.2f}), peak memory {seen['peak'] / 2**30:.3f} GiB "
          f"(host path {host['peak'] / 2**30:.3f})")
    print(f"[device-aug] launches {launches}, expected {want}")
    if len(seen["step_end"]) != steps or launches != want:
        raise AssertionError(f"--device_aug: {len(seen['step_end'])} steps, launches "
                             f"{launches}; expected {steps} and {want}")
    run_dir = os.path.join(out, os.listdir(out)[0])
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    nums = {k: v for k, v in recs[0].items() if isinstance(v, (int, float))} if recs else {}
    print("[device-aug] metrics.jsonl: " + ", ".join(f"{k} {v:.6g}" for k, v in nums.items()))
    if len(recs) != 1 or not all(np.isfinite(v) for v in nums.values()):
        raise AssertionError(f"metrics.jsonl: {recs}")
    del seen
    torch.cuda.empty_cache()

    # the dev pass again, as a resumed run composes it: a fresh composer
    cfg = load_config(host["config"])
    cfg.rawboost = cli.flags._rawboost_from_args(args)  # as the CLI's runtime sets it
    spec = spec_from_config(cfg.data.name, cfg.data.kwargs)
    spec.repeat_pad = False  # the CLI's --padding_type zero
    res = resources_from_config(cfg.data.kwargs, cfg.rawboost)
    fresh = _device_composer(args, cfg, spec, "cuda")
    _, dev_files = protocols.gen_list_scl(host["db"], "dev")
    dev_loader = DeviceAugTrainLoader(SCLViewBatchBuilder(spec, host["db"], dev_files, res,
                                                          seed=args.seed + 1),
                                      2, shuffle=False, drop_last=False,
                                      num_workers=args.num_workers, seed=args.seed)
    raw = next(iter(dev_loader.epoch(0)))
    again, _ = fresh(raw["anchors"], raw["reals"], raw["vocoded"], dev_seed,
                     spoofs=raw["spoofs"], variant=spec.variant)
    same = len(dev_views) == 1 and torch.equal(dev_views[0], again)
    print(f"[device-aug] dev views {tuple(again.shape)} composed again by a fresh composer: "
          f"identical {same}")
    if not same:
        raise AssertionError("the dev pass's views change between composers")

    _, files = protocols.gen_list_scl(host["db"], "train")
    builder = SCLViewBatchBuilder(spec, host["db"], files, res, seed=args.seed)
    t1 = time.perf_counter()
    n = sum(b["anchors"].shape[0] for b in DeviceAugTrainLoader(
        builder, 2, num_workers=args.num_workers).epoch(0))
    decode = (time.perf_counter() - t1) / n * 1e3
    print(f"[device-aug] {card}: host, {os.cpu_count()} cores: {decode:.1f} ms per group "
          f"through DeviceAugTrainLoader (decode and crop only) against {host['group_ms']:.1f} "
          f"ms through TrainLoader (host augmentation); composer on the card "
          f"{comp_ms['reference']:.2f} ms per step of {g} groups ('reference'), "
          f"{comp_ms['rms']:.2f} ms ('rms'), CUDA events, host arrays in")
    return launches


REMAT_POLICIES = ("attn", "attn_ffn", "dots", "full")


def phase_remat(K, card):
    """Two train steps of the conf-3 model at [2, 11, 64000] bf16 under each
    remat policy: ms for the second, peak memory, the launches of one step
    (the forward recomputed under every policy: 48 / 24 / 24); then two
    steps with bf16 weight-grad stacks under fp32 compute (--bf16_grads)."""
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train.engine import Engine
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

    c = CONF3
    layers = XLSRConfig.xlsr_300m().encoder_layers
    want = {"flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
            "flash_attn_bwd_dkv": layers}
    batch = conf3_batches(1, c["seed"])[0]
    out = {}
    runs = [(p, dict(compute_dtype="bfloat16", remat_policy=p)) for p in REMAT_POLICIES]
    # --bf16_grads: the encoder's matmul weights rounded to bf16, fp32 compute
    runs.append(("attn_bf16_grads_fp32", dict(compute_dtype="float32", remat_policy="attn",
                                              grad_stack_dtype="bfloat16")))
    for label, kw in runs:
        cfg = TrainConfig(compute_dtype=kw["compute_dtype"], seed=c["seed"])
        eng = Engine(LinearNLL(ssl=XLSRConfig.xlsr_300m(remat=True, **kw), device="cuda",
                               seed=c["seed"]), cfg)
        eng.init_state()
        placed = eng.place_batch(batch)
        n_steps = 2  # the second step's peak holds AdamW's moments
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(n_steps):
            K.reset_launches()
            t0 = time.perf_counter()
            m = eng.train_step(placed, eng.step_generator(0, i))
            loss = float(m["loss"])
            ms = (time.perf_counter() - t0) * 1e3
        launches, peak = dict(K.LAUNCHES), torch.cuda.max_memory_allocated()
        print(f"[remat] {card}: '{label}' [{c['groups']}, {c['views']}, {c['samples']}]: "
              f"step {n_steps} {ms:.2f} ms (loss read back), peak memory "
              f"{peak / 2**30:.3f} GiB, loss {loss:.6g}, launches per step {launches} "
              f"(expected {want})")
        if launches != want or not np.isfinite(loss):
            raise AssertionError(f"remat '{label}': launches {launches}, loss {loss}")
        out[label] = {"ms": ms, "peak_gib": peak / 2**30, "launches": launches}
        del eng, placed, m
        torch.cuda.empty_cache()
    return out


def phase_train_cli(K, card, tmp):
    """The port's CLI training mode in-process at XLS-R 300M (``main`` cuts
    the depth: ``cut_depth``) with conf-3
    verbatim (V = 11, trim 64000) on a database written here: 4 train steps
    of 2 anchor groups and 1 dev step, host augmentation in TrainLoader.
    Then last.ckpt is loaded into a fresh model, which must score a batch
    exactly as the trained one; and the host's time to build one group."""
    from scl_deepfake_audio_detection_torch import cli, native
    from scl_deepfake_audio_detection_torch.data import protocols
    from scl_deepfake_audio_detection_torch.data.datasets import (
        SCLViewBatchBuilder, resources_from_config, spec_from_config)
    from scl_deepfake_audio_detection_torch.data.loader import TrainLoader
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train import engine as E
    from scl_deepfake_audio_detection_torch.utils.config import load_config
    from scl_deepfake_audio_detection_torch.utils.registry import MODELS

    db, out = os.path.join(tmp, "db"), os.path.join(tmp, "out_host")
    cfg_path, utts = _cli_database(db)
    argv = ["--config", cfg_path, "--database_path", db, "--ssl_preset", "xlsr_300m",
            "--compute_dtype", "bfloat16", "--batch_size", "2", "--num_epochs", "1",
            "--device", "cuda", "--out_dir", out]
    workers = cli.build_parser().parse_args(argv).num_workers
    seen = _observed_cli(K, argv)
    wall, launches, peak = seen["wall"], seen["launches"], seen["peak"]
    layers = XLSRConfig.xlsr_300m().encoder_layers
    steps, dev_steps = CLI_DB["train"] // 2, -(-CLI_DB["dev"] // 2)
    want = {"flash_attn_fwd": 2 * layers * steps + layers * dev_steps,
            "flash_attn_bwd_dq": layers * steps, "flash_attn_bwd_dkv": layers * steps}
    ends, per_step = seen["step_end"], seen["per_step_ms"]
    print(f"[train-cli] {card}: CLI training, XLS-R 300M widths at {layers} layers + "
          f"LinearNLL bf16 remat 'attn', "
          f"conf-3 (V = 11, trim 64000), {steps} steps of 2 groups + {dev_steps} dev step: "
          f"{wall:.2f}s wall (model build, checkpoint writes included), "
          f"{per_step:.2f} ms/step after the first, peak memory {peak / 2**30:.3f} GiB")
    print(f"[train-cli] launches {launches}, expected {want}")
    if len(ends) != steps or launches != want:
        raise AssertionError(f"{len(ends)} train steps and launches {launches}; "
                             f"expected {steps} and {want}")
    run_dir = os.path.join(out, os.listdir(out)[0])
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    nums = {k: v for k, v in recs[0].items() if isinstance(v, (int, float))} if recs else {}
    print("[train-cli] metrics.jsonl: " + ", ".join(f"{k} {v:.6g}" for k, v in nums.items()))
    if len(recs) != 1 or not all(np.isfinite(v) for v in nums.values()):
        raise AssertionError(f"metrics.jsonl: {recs}")
    for name, secs in seen["writes"]:
        size = os.path.getsize(os.path.join(run_dir, name))
        print(f"[train-cli] checkpoint {name}: {size / 2**30:.3f} GiB written in {secs:.2f}s")
    if "last.ckpt" not in [n for n, _ in seen["writes"]]:
        raise AssertionError("no last.ckpt written")

    # last.ckpt -> a fresh model through load_train_state scores as the trained one
    eng = seen["engine"]
    cfg = load_config(cfg_path)
    ssl = XLSRConfig.xlsr_300m(compute_dtype="bfloat16", remat=True)
    fresh = E.Engine(MODELS.get(cfg.model.name).from_config(cfg.model, ssl=ssl, device="cuda",
                                                            seed=99), eng.cfg)
    fresh.init_state()
    t1 = time.perf_counter()
    epoch, _, _ = ckpt.load_train_state(os.path.join(run_dir, "last.ckpt"), fresh.model,
                                        fresh.optimizer)
    load_s = time.perf_counter() - t1
    wav = (0.1 * np.random.default_rng(3).normal(size=(4, 64000))).astype(np.float32)
    same = torch.equal(E.score_step(eng.model, wav), E.score_step(fresh.model, wav))
    print(f"[train-cli] last.ckpt (epoch {epoch}) loaded into a fresh model in {load_s:.2f}s; "
          f"identical scores {same}")
    if not same or not isinstance(fresh.model, LinearNLL):
        raise AssertionError("last.ckpt does not reproduce the trained model")
    del eng, fresh, seen
    torch.cuda.empty_cache()

    # the host's share: one 11-view group alone, then through TrainLoader
    spec = spec_from_config(cfg.data.name, cfg.data.kwargs)
    spec.repeat_pad = False  # the CLI's --padding_type zero
    res = resources_from_config(cfg.data.kwargs, cfg.rawboost)
    _, files = protocols.gen_list_scl(db, "train")
    builder = SCLViewBatchBuilder(spec, db, files, res, seed=1234)

    def build_ms():
        t1 = time.perf_counter()
        for i in range(len(files)):
            builder.build(i, 0)
        return (time.perf_counter() - t1) / len(files) * 1e3

    # RawBoost's LnL through the native host library (as the CLI ran it)
    # and through numpy, in turns: native, numpy, numpy, native
    native_on, native_available = native.available(), native.available
    alone = {True: [], False: []}
    try:
        for use in (True, False, False, True):
            native.available = native_available if use else (lambda: False)
            alone[use].append(build_ms())
    finally:
        native.available = native_available
    _, views, _ = builder.build(0, 0)
    t1 = time.perf_counter()
    n = sum(b["wav"].shape[0] for b in TrainLoader(builder, 2, num_workers=workers).epoch(0))
    loader = (time.perf_counter() - t1) / n * 1e3
    print(f"[train-cli] host, {os.cpu_count()} cores: one {views.shape[0]}-view group "
          f"[{views.shape[0]}, {views.shape[1]}] takes {min(alone[True]):.1f} ms in "
          f"SCLViewBatchBuilder.build alone with the native LnL (built: {native_on}), "
          f"{min(alone[False]):.1f} ms with numpy's (best of 2 each, in turns), "
          f"{loader:.1f} ms per group through TrainLoader "
          f"(2 groups a step, --num_workers {workers}): {2 * loader:.1f} ms of host work "
          f"per step against the CLI's {per_step:.1f} ms per step")
    return launches, {"db": db, "config": cfg_path, "per_step_ms": per_step,
                      "group_ms": loader, "peak": peak}


# The model zoo (AASIST with conf-aasist's published head, ResNet-18 at the
# JAX defaults) at XLS-R 300M bf16: 2 train steps of 2 groups and 1 dev step
# through the CLI, then scoring 16 eval clips of [16, 64600] from its
# last.ckpt through --eval, --serve and the exported artifact.
# int8_head: the head whose int8 artifact is written beside the fp one (its
# buffers bit-equal to the fp artifact's); one head keeps the phase short
ZOO = dict(kinds=("aasist", "resnet", "btse"), train=4, dev=2, eval_utts=16, batch=16,
           seed=1234, int8_head="aasist")
RESNET_MODEL = """model:
  name: wav2vec2_resnet
  flag_fix_ssl: false
  contra_mode: 'all'
  loss_type: 1
  resnet: {resnet_type: '18', num_nodes: 3, enc_dim: 256, nclasses: 2}
"""


def _zoo_database(root):
    """``_cli_database`` under conf-aasist.yaml (whose data section is
    conf-3's) with 4 train and 2 dev anchors, a ResNet-18 YAML beside it
    (the repository ships none: conf-aasist's with its model block
    replaced), conf-5's YAML and the real spoofs its data recipe adds, and
    16 eval clips (every fourth a third of 64600 samples, the zero-pad
    branch; each with a stretch at -40 dB and one of zeros) in ``eval/``
    and ``scp/test.lst``."""
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

    aasist, _ = _cli_database(root, AASIST_CONFIG, train=ZOO["train"], dev=ZOO["dev"])
    with open(aasist) as f:
        data = f.read().split("\ndata:", 1)[1]
    resnet = os.path.join(root, "resnet-18.yaml")
    with open(resnet, "w") as f:
        f.write(RESNET_MODEL + "data:" + data)
    rng = np.random.default_rng(ZOO["seed"])
    for i in range(3):
        save_wav(os.path.join(root, "spoof", f"spoof{i}.wav"),
                 (0.1 * rng.normal(size=64000)).astype(np.float32))
    utts = [f"eval{i:02d}.wav" for i in range(ZOO["eval_utts"])]
    for i, u in enumerate(utts):
        n = 64600 if i % 4 else 64600 // 3
        x = (0.1 * rng.normal(size=n)).astype(np.float32)
        x[n // 5:n // 5 + n // 6] *= 0.01
        x[3 * n // 5:3 * n // 5 + n // 8] = 0.0
        save_wav(os.path.join(root, "eval", u), x)
    with open(os.path.join(root, "scp", "test.lst"), "w") as f:
        f.write("\n".join(utts) + "\n")
    return {"aasist": aasist, "resnet": resnet, "btse": _config_in(root, BTSE_CONFIG)}, utts


def _btse_tokens(db, utts, sb):
    """BTSE's bio tokens of the eval clips as ``--eval`` crops them
    (``pad_eval`` to 64600), on the card and on the CPU: equal, with all
    three tokens present."""
    from scl_deepfake_audio_detection_torch.dsp.biosegment import wav2bio
    from scl_deepfake_audio_detection_torch.dsp.pad import pad_eval
    from scl_deepfake_audio_detection_torch.utils.audio_io import load_audio

    wav = torch.from_numpy(np.stack([pad_eval(load_audio(os.path.join(db, "eval", u)))
                                     for u in utts[:sb]]).astype(np.float32))
    on_card, on_cpu = wav2bio(wav.cuda()).cpu(), wav2bio(wav)
    counts = torch.bincount(on_cpu.flatten().long(), minlength=3).tolist()
    print(f"[zoo] btse: bio tokens of the {len(wav)} eval crops {tuple(on_cpu.shape)} on the "
          f"card equal the CPU's: {torch.equal(on_card, on_cpu)}; silence / talking / "
          f"breathing {counts}")
    if not torch.equal(on_card, on_cpu) or min(counts) == 0:
        raise AssertionError("btse: the card's bio tokens differ from the CPU's")


def _zoo_golden(K, kind, layers):
    """The committed tiny golden of ``kind`` on the card, fp32 with TF32 off:
    the ``tests/seeded_params.seeded_tree`` parameters and the golden's
    running statistics (BTSE has none), scored through the kernel and at
    impl='reference'; both within 1e-4 of the JAX package's scores, 2
    launches (the tiny encoder's layers) per kernel forward; BTSE's bio
    tokens on the card equal to those the golden records."""
    from scl_deepfake_audio_detection_torch.models.params import load_jax_params
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.registry import MODELS

    spec = importlib.util.spec_from_file_location(
        "seeded_params", os.path.join(ROOT, "tests", "seeded_params.py"))
    seeded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(seeded)
    tree, meta = ckpt.load(os.path.join(GOLDEN_DIR, f"mini_{kind}.ckpt"))
    with open(os.path.join(GOLDEN_DIR, f"mini_{kind}_scores.txt")) as f:
        want = np.array([[float(v) for v in ln.split()[1:]] for ln in f], np.float64)
    rng = np.random.default_rng(meta["wav_seed"])
    n, t = meta["wav_shape"]
    wav = [(0.1 * rng.normal(size=(n, t))).astype(np.float32)
           for _ in range(meta["train_forwards"] + 1)][-1]
    for row, start, end, factor in meta.get("stretches", []):
        wav[row, start:end] *= np.float32(factor)
    tokens_equal = True
    if "tokens" in meta:
        from scl_deepfake_audio_detection_torch.dsp.biosegment import wav2bio

        tokens_equal = wav2bio(torch.from_numpy(wav).cuda()).tolist() == meta["tokens"]
    got, launches = {}, {}
    for impl in ("auto", "reference"):
        cfg = XLSRConfig.tiny(attention_impl=impl)
        model = MODELS.get(meta["model"])(ssl=cfg, device="cuda")
        load_jax_params(model, seeded.seeded_tree(model, meta["param_seed"]), tree.get("buffers"))
        K.reset_launches()
        got[impl] = score_step(model, wav).double().cpu().numpy()
        torch.cuda.synchronize()
        launches[impl] = dict(K.LAUNCHES)
    err = {impl: float(np.abs(v - want).max()) for impl, v in got.items()}
    expect = dict({name: 0 for name in K.KERNELS}, flash_attn_fwd=cfg.encoder_layers)
    print(f"[zoo] golden {kind}: T={cfg.num_frames(t)} D={cfg.head_dim} fp32 on the card: max "
          f"|score - golden| kernel {err['auto']:.3e}, impl='reference' "
          f"{err['reference']:.3e} (tol {GOLDEN_ATOL:.0e}); kernel launches "
          f"{launches['auto']}" + ("" if "tokens" not in meta else
                                   f"; bio tokens on the card equal the golden's: {tokens_equal}"))
    if max(err.values()) > GOLDEN_ATOL or launches["auto"] != expect or not tokens_equal:
        raise AssertionError(f"the {kind} golden is not reproduced on the card")


def _first_layers(tree, n=EARLY_LAYERS):
    """A checkpoint's parameters and buffers with its XLS-R layer stack cut
    to the first ``n`` layers (the stacked [L, ...] leaves)."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) else t[:n]

    params = dict(tree["params"])
    ssl = dict(params["ssl"])
    ssl["encoder"] = {**ssl["encoder"], "layers": cut(ssl["encoder"]["layers"])}
    params["ssl"] = ssl
    return {"params": params, **({"buffers": tree["buffers"]} if "buffers" in tree else {})}


def _buffers_of(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()}


def phase_zoo(K, card, tmp):
    """AASIST (conf-aasist.yaml), ResNet-18 and BTSE (conf-5, on the card's
    bio tokens, which must equal the CPU's) at XLS-R 300M bf16 through
    the port's CLI: 2 train steps and 1 dev step (48 / 24 / 24 launches a
    step, 24 forwards a dev step), the running statistics (AASIST, ResNet)
    finite and moved;
    last.ckpt into a fresh model through load_train_state scores exactly as
    the trained one; --eval from last.ckpt on 16 clips of [16, 64600] (24
    launches); --serve on the same clips, its replies equal to --eval's cm1
    to 6 decimals; last.ckpt's parameters and buffers cut to EARLY_LAYERS
    encoder layers: --export_model of them (fp, and int8 for
    ZOO["int8_head"] with its buffers bit-equal to the fp artifact's) and
    --eval --from_export within 1e-3 of their --eval (4 launches a forward);
    score_step's utt/s.  Then each committed tiny golden on the card."""
    from scl_deepfake_audio_detection_torch import cli
    from scl_deepfake_audio_detection_torch.cli import serve as serve_mod
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.models.params import load_jax_params
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train import engine as E
    from scl_deepfake_audio_detection_torch.utils.config import load_config
    from scl_deepfake_audio_detection_torch.utils.registry import MODELS

    t_phase = time.perf_counter()
    db = os.path.join(tmp, "db")
    configs, utts = _zoo_database(db)
    layers = XLSRConfig.xlsr_300m().encoder_layers
    sb, seed = ZOO["batch"], ZOO["seed"]
    steps, dev_steps = ZOO["train"] // 2, -(-ZOO["dev"] // 2)
    forwards = math.ceil(len(utts) / sb)
    fwd_only = {name: 0 for name in K.KERNELS}
    by_path, stats = {}, {}

    def run(label, argv):
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"{label} exited {rc}")
        return time.perf_counter() - t0

    def expect(label, launches, want):
        if launches != want:
            raise AssertionError(f"{label}: launched {launches}, expected {want}")
        by_path[label] = dict(launches)

    for kind in ZOO["kinds"]:
        cfg_path = configs[kind]
        flags = ["--config", cfg_path, "--database_path", db, "--ssl_preset", "xlsr_300m",
                 "--compute_dtype", "bfloat16", "--seed", str(seed), "--device", "cuda"]
        # 1. two train steps through the CLI
        out = os.path.join(tmp, f"out_{kind}")
        seen = _observed_cli(K, flags + ["--batch_size", "2", "--num_epochs", "1",
                                         "--out_dir", out])
        expect(f"{kind}_train_cli", seen["launches"], {
            "flash_attn_fwd": 2 * layers * steps + layers * dev_steps,
            "flash_attn_bwd_dq": layers * steps, "flash_attn_bwd_dkv": layers * steps})
        eng = seen["engine"]
        moved = {n: b for n, b in _buffers_of(eng.model).items()}
        fresh_cfg = load_config(cfg_path)
        init = _buffers_of(MODELS.get(fresh_cfg.model.name).from_config(
            fresh_cfg.model, ssl=XLSRConfig.xlsr_300m(), device="meta"))
        finite = all(torch.isfinite(b).all().item() for b in moved.values())
        # every statistic left its initial value (mean 0, var 1)
        n_moved = sum(not torch.equal(b, torch.full_like(b, 0.0 if n.endswith(".mean") else 1.0))
                      for n, b in moved.items())
        stats[f"{kind}_cli_ms_per_step"] = seen["per_step_ms"]
        stats[f"{kind}_train_peak_gib"] = seen["peak"] / 2**30
        recipe = "conf-5's data (V = 14" if kind == "btse" else "conf-aasist's data (V = 11"
        print(f"[zoo] {card}: {kind} training CLI, XLS-R 300M bf16 remat 'attn', {recipe}, "
              f"trim 64000), {steps} steps of 2 groups + {dev_steps} dev step: "
              f"{seen['wall']:.2f}s wall, {seen['per_step_ms']:.2f} ms/step after the first, "
              f"peak memory {seen['peak'] / 2**30:.3f} GiB; launches {seen['launches']}; "
              f"{len(moved)} running statistics ({len(init)} at init), finite {finite}, "
              f"moved {n_moved}")
        if not finite or n_moved != len(moved) or sorted(init) != sorted(moved):
            raise AssertionError(f"{kind}: running statistics not finite or not moved")
        run_dir = os.path.join(out, os.listdir(out)[0])
        last = os.path.join(run_dir, "last.ckpt")
        # 2. last.ckpt into a fresh model scores exactly as the trained one
        ssl = XLSRConfig.xlsr_300m(compute_dtype="bfloat16", remat=True)
        fresh = E.Engine(MODELS.get(fresh_cfg.model.name).from_config(
            fresh_cfg.model, ssl=ssl, device="cuda", seed=99), eng.cfg)
        fresh.init_state()
        ckpt.load_train_state(last, fresh.model, fresh.optimizer)
        wav = (0.1 * np.random.default_rng(3).normal(size=(4, 64600))).astype(np.float32)
        same = torch.equal(E.score_step(eng.model, wav), E.score_step(fresh.model, wav))
        same_buf = all(torch.equal(a, b) for a, b in zip(moved.values(),
                                                         _buffers_of(fresh.model).values()))
        print(f"[zoo] {kind}: last.ckpt ({os.path.getsize(last) / 2**30:.3f} GiB) into a "
              f"fresh model: identical scores {same}, identical running statistics {same_buf}")
        if not (same and same_buf):
            raise AssertionError(f"{kind}: last.ckpt does not reproduce the trained model")
        del eng, fresh, seen
        torch.cuda.empty_cache()

        # 3. --eval from last.ckpt, 16 clips
        from_ckpt = flags + ["--model_path", last]
        ev_path = os.path.join(tmp, f"eval_{kind}.txt")
        wall = run(f"{kind} --eval", from_ckpt + [
            "--eval", "--batch_size", str(sb), "--num_workers", "4", "--wire_dtype", "int16",
            "--eval_output", ev_path])
        expect(f"{kind}_eval", dict(K.LAUNCHES), dict(fwd_only, flash_attn_fwd=layers * forwards))
        rows = {r[0]: (float(r[1]), float(r[2])) for r in _read_rows(ev_path)}
        logits = np.array([rows[u] for u in utts])
        print(f"[zoo] {kind}: --eval from last.ckpt, {len(utts)} clips of 64600 in {wall:.2f}s "
              f"wall (model and checkpoint load included), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches {dict(K.LAUNCHES)}"
              f"; raw logits in [{logits.min():.4f}, {logits.max():.4f}]")
        if logits.shape != (len(utts), 2) or not np.isfinite(logits).all():
            raise AssertionError(f"{kind}: bad --eval rows {logits.shape}")

        # 4. --serve on a pipe: replies equal --eval's cm1 to 6 decimals
        paths = [os.path.join(db, "eval", u) for u in utts]
        lines = [f"{u}\t{p}" for u, p in zip(utts, paths)]
        replies, wall, fwd, launches, window = _stdin_serve(
            K, cli, serve_mod, from_ckpt + ["--serve", "--serve_batch", str(sb)], lines)
        expect(f"{kind}_serve", launches, dict(fwd_only, flash_attn_fwd=layers * fwd))
        equal = [v for _, v in replies] == [f"{rows[u][1]:.6f}" for u in utts]
        stats[f"{kind}_serve_utt_s"] = len(lines) / window if window else float("nan")
        print(f"[zoo] {card}: {kind} --serve: {len(lines)} requests in {fwd} forwards of "
              f"[{sb}, 64600], {window:.3f}s from the first forward to the last "
              f"({stats[f'{kind}_serve_utt_s']:.2f} utt/s), {wall:.2f}s wall; replies equal "
              f"--eval's cm1 to 6 decimals: {equal}")
        if not equal or fwd != forwards:
            raise AssertionError(f"{kind}: --serve replies differ from --eval")
        if kind == "btse":
            _btse_tokens(db, utts, sb)

        # 5. the artifact of the trained checkpoint cut to EARLY_LAYERS layers
        # (the export's trace and checkpoint load grow with depth): fp (and
        # int8 for one head), --eval --from_export against --eval of it
        ckpt_tree, _ = ckpt.load(last)
        early = os.path.join(tmp, f"{kind}_early.ckpt")
        ckpt.save(early, _first_layers(ckpt_tree))
        from_early = flags + ["--model_path", early]
        arts = {q: os.path.join(tmp, f"art_{kind}_{q}")
                for q in (("fp", "int8") if kind == ZOO["int8_head"] else ("fp",))}
        with cut_depth():
            for q, path in arts.items():
                wall = run(f"{kind} --export_model {q}", from_early + ["--export_model", path] + (
                    ["--export_quant", "int8"] if q == "int8" else []))
                print(f"[zoo] {kind}: --export_model ({q}) at {EARLY_LAYERS} layers in "
                      f"{wall:.2f}s (model and checkpoint load included)")
            early_path = os.path.join(tmp, f"eval_{kind}_early.txt")
            run(f"{kind} --eval at {EARLY_LAYERS} layers", from_early + [
                "--eval", "--batch_size", str(sb), "--num_workers", "4", "--eval_output",
                early_path])
            expect(f"{kind}_eval_early", dict(K.LAUNCHES),
                   dict(fwd_only, flash_attn_fwd=EARLY_LAYERS * forwards))
        with np.load(os.path.join(arts["fp"], "weights.npz")) as a:
            bufs = [k for k in a.files if k.startswith("b")]
            bit_equal, n_q = bool(bufs) == bool(init), 0
            if "int8" in arts:
                with np.load(os.path.join(arts["int8"], "weights.npz")) as b:
                    bit_equal = bit_equal and all(a[k].tobytes() == b[k].tobytes()
                                                  for k in bufs)
                    n_q = sum(k.startswith("qs") for k in b.files)
        art_path = os.path.join(tmp, f"eval_{kind}_art.txt")
        wall = run(f"{kind} --eval --from_export", [
            "--from_export", arts["fp"], "--device", "cuda", "--eval", "--config", cfg_path,
            "--database_path", db, "--batch_size", str(sb), "--num_workers", "4",
            "--eval_output", art_path])
        expect(f"{kind}_eval_from_export", dict(K.LAUNCHES),
               dict(fwd_only, flash_attn_fwd=EARLY_LAYERS * forwards))
        early_rows = {r[0]: float(r[2]) for r in _read_rows(early_path)}
        art_rows = {r[0]: float(r[2]) for r in _read_rows(art_path)}
        art_err = max(abs(art_rows[u] - early_rows[u]) for u in utts)
        stats[f"{kind}_export_err"] = art_err
        int8 = (f"bit-equal in the int8 artifact {bit_equal} ({n_q} leaves int8)"
                if "int8" in arts else "no int8 artifact for this head")
        print(f"[zoo] {kind}: {len(bufs)} buffer leaves, {int8}; --eval --from_export in "
              f"{wall:.2f}s, max |d cm1| vs --eval of the {EARLY_LAYERS}-layer checkpoint "
              f"{art_err:.3e} (tol 1e-3), launches {dict(K.LAUNCHES)}")
        if not bit_equal or art_err > 1e-3 or sorted(art_rows) != sorted(utts):
            raise AssertionError(f"{kind}: the artifact disagrees")

        # 6. in-process: utt/s of score_step on a placed [16, 64600] batch
        cfg = load_config(cfg_path)
        model = MODELS.get(cfg.model.name).from_config(
            cfg.model, ssl=XLSRConfig.xlsr_300m(compute_dtype="bfloat16"), device="cuda",
            seed=seed)
        load_jax_params(model, ckpt_tree["params"], ckpt_tree.get("buffers"))
        del ckpt_tree
        cast_matmul_params(model.eval(), torch.bfloat16)
        wav = 0.1 * torch.randn(sb, 64600, device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(9))
        torch.cuda.reset_peak_memory_stats()
        ms = _best_ms(lambda: E.score_step(model, wav), calls=2, iters=5)
        stats[f"{kind}_eval_utt_s"] = sb / ms * 1e3
        stats[f"{kind}_eval_ms"] = ms
        stats[f"{kind}_eval_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"[zoo] {card}: {kind} score_step [{sb}, 64600] bf16 on the card: {ms:.3f} ms a "
              f"forward ({stats[f'{kind}_eval_utt_s']:.2f} utt/s), peak memory "
              f"{stats[f'{kind}_eval_peak_gib']:.3f} GiB")
        if kind == "btse":  # the bio branch alone: segmentation, encoder, scoring
            from scl_deepfake_audio_detection_torch.dsp.biosegment import wav2bio

            with torch.inference_mode():
                seg_ms = _best_ms(lambda: wav2bio(wav), calls=2, iters=5)
                bio = wav2bio(wav)
                enc_ms = _best_ms(lambda: model.bio_scoring_vector(bio), calls=2, iters=5)
            stats["btse_segment_ms"], stats["btse_bio_encoder_ms"] = seg_ms, enc_ms
            print(f"[zoo] {card}: btse's bio branch in that forward: wav2bio {seg_ms:.3f} ms, "
                  f"the bio encoder and scoring {enc_ms:.3f} ms (CUDA events, host launches "
                  f"included)")
        del model
        torch.cuda.empty_cache()

    for kind in ZOO["kinds"]:
        _zoo_golden(K, kind, layers)
    total = {name: sum(v[name] for k, v in by_path.items()) for name in K.KERNELS}
    print(f"[zoo] phase in {time.perf_counter() - t_phase:.2f}s; launches {total}")
    return by_path, total, stats



DISTILL = dict(train=6, dev=2, eval_utts=16, batch=16, teacher_seed=4321, seed=1234,
               min_lr=1e-5, max_lr=1e-4)


def _digest(model) -> str:
    """sha256 of every parameter's bytes, in the model's order."""
    import hashlib

    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _distill_golden(K):
    """The committed tiny distillation golden (``tests/golden/mini_distill*``,
    written by the JAX package) on the card, fp32 with TF32 off: the teacher
    from its ``.ckpt``, the one-layer student of head dim 96 from
    ``tests/seeded_params.seeded_tree``, two steps through the kernels, each
    step's metrics and then the student's scores within 1e-4 of the golden;
    per step 2 teacher and 1 student forward launches, 1 dq and 1 dk/dv."""
    from scl_deepfake_audio_detection_torch.dsp.pad import pad_eval
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train import distill as D
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate

    spec = importlib.util.spec_from_file_location(
        "seeded_params", os.path.join(ROOT, "tests", "seeded_params.py"))
    seeded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(seeded)
    tree, meta = ckpt.load(os.path.join(GOLDEN_DIR, "mini_distill.ckpt"))
    with open(os.path.join(GOLDEN_DIR, "mini_distill_scores.txt")) as f:
        want = np.array([[float(v) for v in ln.split()[1:]] for ln in f], np.float64)
    emb = meta["emb_dim"]
    teacher = LinearNLL(ssl=getattr(XLSRConfig, meta["teacher_ssl"])(), emb_dim=emb,
                        device="cuda")
    student = LinearNLL(ssl=XLSRConfig.tiny(**meta["student_ssl"]), emb_dim=emb,
                        dropout=meta["student_dropout"], device="cuda")
    eng = D.DistillEngine(teacher, student, D.DistillConfig(
        alpha=meta["alpha"], temperature=meta["temperature"],
        emb_loss_weight=meta["emb_loss_weight"]))
    eng.init_state(tree["params"], seeded.seeded_tree(student, meta["student_seed"]))
    set_learning_rate(eng.optimizer, meta["lr"])
    rng = np.random.default_rng(meta["batch_seed"])
    labels = np.tile([1.0, 1.0, 0.0, 0.0], (2, 1)).astype(np.float32)
    batches = [{"wav": (0.2 * rng.normal(size=meta["batch_shape"])).astype(np.float32),
                "labels": labels} for _ in range(meta["steps"])]
    K.reset_launches()
    err_m = 0.0
    for i, (batch, golden) in enumerate(zip(batches, meta["metrics"])):
        got = eng.run_epoch([batch], epoch=i)
        if sorted(got) != sorted(golden):
            raise AssertionError(f"distillation golden: metrics {sorted(got)}")
        err_m = max(err_m, max(abs(got[k] - golden[k]) for k in golden))
    wav = np.stack([pad_eval(w, "repeat", 16000) for w in golden_wavs()])
    scores = score_step(student, wav).double().cpu().numpy()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    err_s = float(np.abs(scores - want).max())
    t_layers, s_layers = teacher.ssl.cfg.encoder_layers, student.ssl.cfg.encoder_layers
    steps = meta["steps"]
    expect = {"flash_attn_fwd": steps * (t_layers + s_layers) + s_layers,
              "flash_attn_bwd_dq": steps * s_layers, "flash_attn_bwd_dkv": steps * s_layers}
    print(f"[distill] golden: teacher D={teacher.ssl.cfg.head_dim}, student "
          f"D={student.ssl.cfg.head_dim}, fp32 on the card, {steps} steps: max |metric - "
          f"golden| {err_m:.3e}, max |score - golden| {err_s:.3e} (tol {GOLDEN_ATOL:.0e}); "
          f"launches {launches}")
    if err_m > GOLDEN_ATOL or err_s > GOLDEN_ATOL or launches != expect:
        raise AssertionError(f"the distillation golden is not reproduced on the card "
                             f"(launches {launches}, expected {expect})")


def _codec_paths() -> str:
    """Which path the codec augmentations take on this host: the native
    mp3 / opus / G.722 round trips through the ffmpeg libraries, or the
    G.711 fallback (host DSP: reported, not asserted)."""
    from scl_deepfake_audio_detection_torch import native
    from scl_deepfake_audio_detection_torch.dsp import codec

    x = (0.1 * np.random.default_rng(0).normal(size=16000)).astype(np.float32)
    paths = []
    for name, fn in (("mp3", lambda: codec.codec_roundtrip(x, 16000, "mp3", "64k")),
                     ("opus", lambda: codec.codec_roundtrip(x, 16000, "opus", "24k")),
                     ("g722", lambda: codec.g722_roundtrip(x, 16000))):
        try:
            fn()
            paths.append(f"{name} native")
        except codec.CodecUnavailable:
            paths.append(f"{name} unavailable")
    fallback = "" if native.codec_available() else (
        f" (codec library: {native.BUILD_ERRORS.get('scl_codec', 'not built')!s:.120})")
    return (", ".join(paths) + "; where mp3 or opus is unavailable codec_wrapper falls back "
            "to G.711, and where G.722 is telephone_effect to mu-law" + fallback)


def phase_distill(K, card, tmp):
    """--distill_from through the port's CLI at full width: a seeded
    ``wav2vec2_linear_nll`` teacher at XLS-R 300M (24 layers) written once as
    a ``.ckpt``; the student is conf-3's model at ``student_base`` (12 x 768,
    8 heads: head dim 96), 3 steps of [2, 11, 64000] bf16 view batches.
    Launches per step, derived from the code: the teacher's eval forward
    runs each of its 24 layers once (under ``torch.no_grad``); the student
    trains under remat 'attn' (the CLI's ``XLSRConfig(remat=True)``), whose
    ``torch.utils.checkpoint`` over each layer's attention block runs that
    block again in the backward: 2 forwards a student layer, then one dq and
    one dk/dv; so 24 + 2 x 12 forwards, 12 dq and 12 dk/dv a step.  The
    teacher's parameters are bit-unchanged (a sha256 before and after),
    the student moved, every metric is finite, ``student_last.ckpt`` holds
    the trained student and scores through ``--eval --model_path
    --ssl_preset student_base`` (12 forwards at head dim 96 per scoring
    forward).  Then the committed distillation golden on the card."""
    from scl_deepfake_audio_detection_torch import cli
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.params import to_jax
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.train import distill as D
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav
    from scl_deepfake_audio_detection_torch.utils.tree import flatten

    t_phase = time.perf_counter()
    c = DISTILL
    db = os.path.join(tmp, "db")
    cfg_path, _ = _cli_database(db, train=c["train"], dev=c["dev"])
    rng = np.random.default_rng(c["seed"])
    utts = [f"eval{i:02d}.wav" for i in range(c["eval_utts"])]
    for i, u in enumerate(utts):
        n = 64600 if i % 4 else 64600 // 3
        save_wav(os.path.join(db, "eval", u), (0.1 * rng.normal(size=n)).astype(np.float32))
    with open(os.path.join(db, "scp", "test.lst"), "w") as f:
        f.write("\n".join(utts) + "\n")

    # 1. the teacher, written once
    t0 = time.perf_counter()
    t_path = os.path.join(tmp, "teacher.ckpt")
    teacher = LinearNLL(ssl=XLSRConfig.xlsr_300m(), device="cuda", seed=c["teacher_seed"])
    n_teacher = sum(p.numel() for p in teacher.parameters())
    ckpt.save(t_path, {"params": to_jax(teacher)})
    del teacher
    torch.cuda.empty_cache()
    print(f"[distill] teacher: seeded wav2vec2_linear_nll at xlsr_300m "
          f"({n_teacher / 1e6:.1f}M parameters) written to a .ckpt of "
          f"{os.path.getsize(t_path) / 2**30:.3f} GiB in {time.perf_counter() - t0:.2f}s")

    # 2. --distill_from through the CLI, observed: the engine, the teacher's
    # digest and the student before the first step, CUDA events around each
    # step and each teacher forward
    seen = {"engine": None, "steps": [], "teacher": [], "ends": []}
    init, step = D.DistillEngine.init_state, D.DistillEngine.step

    def init_hook(self, *a, **kw):
        out = init(self, *a, **kw)
        seen.update(engine=self, digest=_digest(self.teacher),
                    s0={n: p.detach().clone() for n, p in self.student.named_parameters()})
        apply = self.teacher.apply

        def timed_apply(*aa, **kk):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            res = apply(*aa, **kk)
            ev[1].record()
            seen["teacher"].append(ev)
            return res

        self.teacher.apply = timed_apply
        return out

    def step_hook(self, *a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        m = step(self, *a, **kw)
        ev[1].record()
        torch.cuda.synchronize()
        seen["steps"].append(ev)
        seen["ends"].append(time.perf_counter())
        return m

    out_dir = os.path.join(tmp, "out")
    argv = ["--distill_from", t_path, "--teacher_preset", "xlsr_300m",
            "--ssl_preset", "student_base", "--config", cfg_path, "--database_path", db,
            "--compute_dtype", "bfloat16", "--num_epochs", "1", "--batch_size", "2",
            "--seed", str(c["seed"]), "--min_lr", str(c["min_lr"]), "--max_lr", str(c["max_lr"]),
            "--out_dir", out_dir, "--device", "cuda"]
    D.DistillEngine.init_state, D.DistillEngine.step = init_hook, step_hook
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        D.DistillEngine.init_state, D.DistillEngine.step = init, step
    wall = time.perf_counter() - t0
    launches, peak = dict(K.LAUNCHES), torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError(f"--distill_from exited {rc}")
    eng = seen["engine"]
    t_layers = eng.teacher.ssl.cfg.encoder_layers
    s_layers = eng.student.ssl.cfg.encoder_layers
    steps = len(seen["steps"])
    want = {"flash_attn_fwd": steps * (t_layers + 2 * s_layers),
            "flash_attn_bwd_dq": steps * s_layers, "flash_attn_bwd_dkv": steps * s_layers}
    step_ms = [a.elapsed_time(b) for a, b in seen["steps"]]
    teacher_ms = [a.elapsed_time(b) for a, b in seen["teacher"]]
    ends = seen["ends"]
    wall_ms = (ends[-1] - ends[0]) / (len(ends) - 1) * 1e3
    share = [t / s for t, s in zip(teacher_ms[1:], step_ms[1:])]
    print(f"[distill] {card}: --distill_from, teacher XLS-R 300M ({t_layers} layers, D="
          f"{eng.teacher.ssl.cfg.head_dim}), student student_base ({s_layers} layers, D="
          f"{eng.student.ssl.cfg.head_dim}), bf16, {steps} steps of [2, 11, 64000]: "
          f"{wall:.2f}s wall (models, teacher load and checkpoint included); step ms (CUDA "
          f"events) {', '.join(f'{v:.2f}' for v in step_ms)}; after the first "
          f"{wall_ms:.2f} ms a step on the host's clock")
    print(f"[distill] {card}: the teacher's forward (CUDA events) "
          f"{', '.join(f'{v:.2f}' for v in teacher_ms)} ms, "
          f"{', '.join(f'{100 * v:.1f}' for v in share)} % of its step after the first; "
          f"peak memory {peak / 2**30:.3f} GiB; launches {launches} (expected {want})")
    if launches != want or steps != -(-c["train"] // 2):
        raise AssertionError(f"--distill_from launched {launches}, expected {want}")

    # 3. the teacher is bit-unchanged, the student moved and is what
    # student_last.ckpt holds, every metric finite
    same_teacher = _digest(eng.teacher) == seen["digest"]
    moved = max((p.detach() - seen["s0"][n]).abs().max().item()
                for n, p in eng.student.named_parameters())
    (run_dir,) = os.listdir(out_dir)
    student_path = os.path.join(out_dir, run_dir, "student_last.ckpt")
    tree, extra = ckpt.load(student_path)
    flat_saved, flat_file = flatten(to_jax(eng.student)), flatten(tree["params"])
    same_file = sorted(flat_saved) == sorted(flat_file) and all(
        np.array_equal(flat_saved[k], flat_file[k]) for k in flat_saved)
    metrics = {k: v for k, v in extra.items() if k != "epoch"}
    finite = all(np.isfinite(v) for v in metrics.values())
    print(f"[distill] teacher sha256 unchanged {same_teacher}; student max |moved| "
          f"{moved:.3e}; student_last.ckpt ({os.path.getsize(student_path) / 2**30:.3f} GiB) "
          f"equals the trained student {same_file}; metrics "
          f"{ {k: round(v, 6) for k, v in sorted(metrics.items())} } finite {finite}")
    if not (same_teacher and moved > 0 and same_file and finite):
        raise AssertionError("distillation: the teacher changed, the student did not move, "
                             "student_last.ckpt differs or a metric is not finite")
    del eng, seen, flat_saved
    torch.cuda.empty_cache()

    # 4. the student scores through --eval
    ev_path = os.path.join(tmp, "student_scores.txt")
    K.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["--eval", "--model_path", student_path, "--ssl_preset", "student_base",
                   "--config", cfg_path, "--database_path", db, "--compute_dtype", "bfloat16",
                   "--batch_size", str(c["batch"]), "--num_workers", "4",
                   "--eval_output", ev_path, "--device", "cuda"])
    torch.cuda.synchronize()
    ev_wall = time.perf_counter() - t0
    ev_launches = dict(K.LAUNCHES)
    forwards = math.ceil(len(utts) / c["batch"])
    ev_want = {"flash_attn_fwd": s_layers * forwards, "flash_attn_bwd_dq": 0,
               "flash_attn_bwd_dkv": 0}
    rows = _read_rows(ev_path)
    scores = np.array([[float(v) for v in r[1:]] for r in rows])
    print(f"[distill] --eval --model_path student_last.ckpt --ssl_preset student_base: "
          f"{len(rows)} rows in {ev_wall:.2f}s wall, {forwards} forwards of [{c['batch']}, "
          f"64600] (D={XLSRConfig.student_base().head_dim}), launches {ev_launches}, scores in "
          f"[{scores.min():.4f}, {scores.max():.4f}]")
    if (rc != 0 or sorted(r[0] for r in rows) != sorted(utts) or ev_launches != ev_want
            or not np.isfinite(scores).all()):
        raise AssertionError(f"the student's --eval failed (rc {rc}, launches {ev_launches})")

    _distill_golden(K)
    print(f"[distill] codec augmentations on this host: {_codec_paths()}")
    stats = {"step_ms": step_ms, "host_ms_per_step": wall_ms, "teacher_fwd_ms": teacher_ms,
             "teacher_share": share, "peak_gib": peak / 2**30, "wall_s": wall}
    print(f"[distill] phase in {time.perf_counter() - t_phase:.2f}s")
    return {"distill": launches, "distill_student_eval": ev_launches}, stats


# phase_parallel: XLS-R 300M widths (16 heads) at EARLY_LAYERS layers + LinearNLL,
# bf16 remat 'attn', conf-3's [2, 11, 64000] step; ranks on the one card
PARALLEL = dict(seed=1234, lr=1e-4, shapes=((2, 1), (1, 2)), eval_utts=8)
# the tensor-parallel rank's attention at [2 x 11, 64000]: 8 heads of 64
TP_SHAPE = (22, 8, 199, 64)


def _parallel_step(K, shape, device):
    """One train step (then a second, timed) of the phase's model on mesh
    ``shape`` (in a process group of that many ranks, or (1, 1) alone):
    the first step's metrics and whole first moments (rank 0, after the
    gathers), each step's launches, the second step's ms and the peak
    memory of this process."""
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.parallel import mesh as M
    from scl_deepfake_audio_detection_torch.train.engine import Engine
    from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

    c = PARALLEL
    ssl = XLSRConfig.xlsr_300m(encoder_layers=EARLY_LAYERS, compute_dtype="bfloat16",
                               remat=True)
    eng = Engine(LinearNLL(ssl=ssl, device=device, seed=c["seed"]),
                 TrainConfig(compute_dtype="bfloat16", seed=c["seed"],
                             mesh_shape=list(shape) if M.is_distributed() else None))
    eng.init_state()
    set_learning_rate(eng.optimizer, c["lr"])
    batch = conf3_batches(1, c["seed"])[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"launches": [], "heads": eng.model.ssl.encoder.layers[0].attn.q.weight.shape[0] //
           ssl.head_dim}
    for i in range(2):
        placed = eng.place_batch(batch)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        m = eng.train_step(placed, eng.step_generator(0, i))
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
        out["launches"].append(dict(K.LAUNCHES))
        if i == 0:
            out["metrics"] = {k: float(v) for k, v in m.items()}
            moments = {k[len("exp_avg//"):]: v.float().cpu()
                       for k, v in eng.optimizer.state_arrays().items()
                       if k.startswith("exp_avg//")}
            if M.rank() == 0:
                out["exp_avg"] = moments
            del moments
            torch.cuda.reset_peak_memory_stats()  # the peak of the second step
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del eng, placed
    torch.cuda.empty_cache()
    return out


def _parallel_rank(out_dir):
    """One of phase_parallel's two ranks on the card (a spawned process):
    joins the group, takes the step on each mesh shape, writes its results."""
    sys.path.insert(0, ROOT)
    from scl_deepfake_audio_detection_torch.ops import _kernels as K
    from scl_deepfake_audio_detection_torch.parallel import mesh as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = M.join_environment("cuda")
    res = {shape: _parallel_step(K, shape, device) for shape in PARALLEL["shapes"]}
    res["backend"] = torch.distributed.get_backend()
    torch.save(res, os.path.join(out_dir, f"rank{M.rank()}.pt"))
    return 0


def _parallel_database(root, n):
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

    rng = np.random.default_rng(PARALLEL["seed"])
    utts = [f"p{i:02d}.wav" for i in range(n)]
    for u in utts:
        save_wav(os.path.join(root, u), (0.1 * rng.normal(
            size=int(rng.integers(20000, 64600, endpoint=True)))).astype(np.float32))
    with open(os.path.join(root, "protocol.txt"), "w") as f:
        f.writelines(f"{u} eval {'bonafide' if i % 2 else 'spoof'}\n" for i, u in enumerate(utts))
    return utts


def phase_parallel(K, card, tmp, host):
    """The parallel path on the one card.  (a) The training CLI under
    ``--mesh 1,1 --zero1`` (a process group of one over NCCL) against the
    plain CLI on the training CLI's database at ``cut_depth``'s depth:
    ``last.ckpt``'s leaves within 1e-6.  (b) Two ranks on the card over
    gloo (NCCL puts one rank on a card): one [2, 11, 64000] bf16 step under
    (2, 1) and under (1, 2) (8 heads of 64 a rank through the kernels)
    against the one-process step: the metrics within MAIN_PATH_ATOL of
    their size, the first moments (0.1 x the gradient) by ``_moments_close``
    (each leaf's direction and size, all leaves' joint difference; a second
    one-process step gives the card's own floor); launches per rank exact; the second step's ms and the peak memory
    per rank.  (c) ``--multihost --eval`` from two ranks (batch 1, at full
    depth): ``.part0`` and ``.part1`` together equal the one-process rows
    to 6 decimals.  Returns the launches of each run and the stats."""
    import contextlib
    import io

    from scl_deepfake_audio_detection_torch import cli
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.parallel import memory as Mem
    from scl_deepfake_audio_detection_torch.parallel import mesh as M
    from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
    from scl_deepfake_audio_detection_torch.utils.tree import flatten

    c = PARALLEL
    t_phase = time.perf_counter()
    layers = XLSRConfig.xlsr_300m().encoder_layers  # cut_depth's
    launches, stats = {}, {}

    # (a) --mesh 1,1 --zero1: a group of one over NCCL, against the plain CLI
    common = ["--config", host["config"], "--database_path", host["db"], "--ssl_preset",
              "xlsr_300m", "--compute_dtype", "bfloat16", "--batch_size", "2",
              "--num_epochs", "1", "--device", "cuda", "--seed", str(c["seed"])]
    states, deterministic = {}, torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the two runs compared to 1e-6
    try:
        for label, extra in (("plain", []), ("mesh_1_1_zero1", ["--mesh", "1,1", "--zero1"])):
            out = os.path.join(tmp, f"par_{label}")
            K.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(common + extra + ["--out_dir", out])
            torch.cuda.synchronize()
            launches[f"cli_{label}"] = dict(K.LAUNCHES)
            if rc != 0:
                raise AssertionError(f"--mesh run {label} exited {rc}")
            (run,) = os.listdir(out)
            states[label] = flatten(ckpt.load(os.path.join(out, run, "last.ckpt"))[0])
            print(f"[parallel] (a) CLI {label}: {time.perf_counter() - t0:.2f}s, launches "
                  f"{launches[f'cli_{label}']}; a process group after the run: "
                  f"{M.is_distributed()}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = states["plain"], states["mesh_1_1_zero1"]
    err = max(float(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)).max())
              for k in a) if sorted(a) == sorted(b) else float("inf")
    steps, dev_steps = CLI_DB["train"] // 2, -(-CLI_DB["dev"] // 2)
    want = {"flash_attn_fwd": 2 * layers * steps + layers * dev_steps,
            "flash_attn_bwd_dq": layers * steps, "flash_attn_bwd_dkv": layers * steps}
    print(f"[parallel] (a) --mesh 1,1 --zero1 (NCCL, world 1) vs the plain CLI: "
          f"{len(a)} leaves of last.ckpt, max |diff| {err:.3e} (tol 1e-6)")
    if err > 1e-6 or any(launches[f"cli_{k}"] != want for k in ("plain", "mesh_1_1_zero1")):
        raise AssertionError(f"(a): max diff {err}, launches {launches}, want {want}")
    stats["cli_mesh_1_1_zero1_max_abs_diff"] = err

    # (b) two ranks on the card, dp (2, 1) and tp (1, 2), against one process
    ref = _parallel_step(K, (1, 1), torch.device("cuda"))
    again = _parallel_step(K, (1, 1), torch.device("cuda"))
    ref_launches = ref["launches"][0]
    per_step = {"flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
                "flash_attn_bwd_dkv": layers}
    analytic = Mem.estimate_train_memory(
        XLSRConfig.xlsr_300m(encoder_layers=layers, compute_dtype="bfloat16", remat=True),
        CONF3["groups"] * CONF3["views"], CONF3["samples"], overhead=1.0).analytic_gb
    print(f"[parallel] (b) one process: step 2 {ref['ms']:.2f} ms, peak "
          f"{ref['peak_gib']:.3f} GiB (analytic sum {analytic:.3f} GiB), launches "
          f"{ref_launches}, loss {ref['metrics']['loss']:.6g}")
    torch.cuda.empty_cache()
    rank_dir = os.path.join(tmp, "ranks")
    os.makedirs(rank_dir)
    backend = os.environ.get("SCL_DIST_BACKEND")
    os.environ["SCL_DIST_BACKEND"] = "gloo"  # two ranks on one card
    t0 = time.perf_counter()
    try:
        codes = M.launch(_parallel_rank, 2, args=(rank_dir,), timeout=300)
    finally:
        if backend is None:
            os.environ.pop("SCL_DIST_BACKEND")
        else:
            os.environ["SCL_DIST_BACKEND"] = backend
    if codes != [0, 0]:
        raise AssertionError(f"(b) rank exit codes {codes}")
    ranks = [torch.load(os.path.join(rank_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    print(f"[parallel] (b) two ranks over {ranks[0]['backend']} on one card: "
          f"{time.perf_counter() - t0:.1f}s with start-up")
    bad = []
    floor = _moments_diff(again["exp_avg"], ref["exp_avg"])
    print(f"[parallel] (b) a second one-process step against the first (the card's "
          f"run-to-run floor in bf16): {_moments_line(floor)}")
    for shape in c["shapes"]:
        name = f"{'dp' if shape[0] > 1 else 'tp'}_{shape[0]}_{shape[1]}"
        got = ranks[0][shape]
        merr = max(abs(got["metrics"][k] - ref["metrics"][k]) /
                   max(abs(ref["metrics"][k]), 1.0) for k in ref["metrics"])
        diff = _moments_diff(got["exp_avg"], ref["exp_avg"])
        stats[f"{name}_moments"] = diff
        for r, res in enumerate(ranks):
            launches[f"{name}_rank{r}"] = res[shape]["launches"][0]
            ok = all(l == per_step for l in res[shape]["launches"])
            print(f"[parallel] (b) {card}: {name} rank {r}: {res[shape]['heads']} heads a "
                  f"layer, step 2 {res[shape]['ms']:.2f} ms, peak {res[shape]['peak_gib']:.3f} "
                  f"GiB, launches per step {res[shape]['launches']} (expected {per_step}: "
                  f"{ok})")
            bad += [] if ok else [f"{name} rank {r} launches"]
            stats[f"{name}_rank{r}"] = {"ms": res[shape]["ms"],
                                        "peak_gib": res[shape]["peak_gib"]}
        print(f"[parallel] (b) {name}: metrics within {merr:.3e} of the one-process step "
              f"(tol {MAIN_PATH_ATOL:.0e}); first moments: {_moments_line(diff)}")
        if merr > MAIN_PATH_ATOL or not _moments_close(diff):
            bad.append(f"{name}: metrics {merr}, moments {diff}")
        if ranks[0][shape]["heads"] != 16 // shape[1]:
            bad.append(f"{name}: {ranks[0][shape]['heads']} heads a rank")
    if ref_launches != per_step or bad:
        raise AssertionError(f"(b): {bad}, one-process launches {ref_launches}")
    stats["one_process"] = {"ms": ref["ms"], "peak_gib": ref["peak_gib"],
                            "analytic_gib": analytic}
    print(f"[memory] {card}: conf-3 step at {layers} layers, [2, 11, 64000] bf16 remat "
          f"'attn': peak {ref['peak_gib']:.3f} GiB / analytic sum {analytic:.3f} GiB = "
          f"{ref['peak_gib'] / analytic:.4f}")
    del ref, again
    torch.cuda.empty_cache()
    return launches, stats


# phase_parallel (b)'s first moments (0.1 x the gradient) against one
# process's.  In bf16 the card's own rerun of one step differs by ~2e-2 of a
# leaf's largest entry (cuDNN's bf16 conv backward), and tensor parallelism
# rounds more partial sums (each rank's half of a product in bf16), which
# moves the leaves whose gradient is mostly cancellation (the key weights and
# the attention layer norm's, ~1e-1 of their largest) more.  So each leaf is
# held by direction and size, not entry by entry, and all leaves by their
# joint norm; the key bias (a true gradient of 0) is left out.
MOMENT_COS, MOMENT_NORM, MOMENT_JOINT = 0.99, 0.05, 2.0 ** -5


def _moments_diff(got, want):
    """Per leaf the cosine and the norm ratio, and the joint relative
    difference of all leaves (the key bias left out)."""
    cos, ratio, num, den = {}, {}, 0.0, 0.0
    for n, w in want.items():
        if n.endswith("attn.k.bias"):
            continue
        g, w = got[n].double().reshape(-1), w.double().reshape(-1)
        nw, ng = float(w.norm()), float(g.norm())
        both_zero = nw == 0.0 and ng == 0.0
        cos[n] = 1.0 if both_zero else float(g @ w) / max(nw * ng, 1e-300)
        ratio[n] = 1.0 if both_zero else ng / max(nw, 1e-300)
        num += float((g - w).norm()) ** 2
        den += nw ** 2
    worst_cos = min(cos, key=cos.get)
    worst_ratio = max(ratio, key=lambda n: abs(ratio[n] - 1.0))
    return {"min_cos": cos[worst_cos], "min_cos_leaf": worst_cos,
            "worst_norm_ratio": ratio[worst_ratio], "worst_norm_ratio_leaf": worst_ratio,
            "joint_rel_diff": (num / max(den, 1e-300)) ** 0.5}


def _moments_line(d):
    return (f"least cosine {d['min_cos']:.6f} ({d['min_cos_leaf']}; tol {MOMENT_COS}), "
            f"norm ratio furthest from 1 {d['worst_norm_ratio']:.4f} "
            f"({d['worst_norm_ratio_leaf']}; tol 1 +- {MOMENT_NORM}), joint relative "
            f"difference {d['joint_rel_diff']:.3e} (tol {MOMENT_JOINT:.3e})")


def _moments_close(d) -> bool:
    return (d["min_cos"] >= MOMENT_COS and abs(d["worst_norm_ratio"] - 1.0) <= MOMENT_NORM
            and d["joint_rel_diff"] <= MOMENT_JOINT)


def memory_overhead(card, peak_gib):
    """``parallel/memory``'s overhead on this card: the peak of
    ``phase_remat``'s conf-3 'attn' step (XLS-R 300M + LinearNLL, [2, 11,
    64000] bf16, the second step) over the estimator's analytic sum."""
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.parallel import memory as Mem

    c = CONF3
    est = Mem.estimate_train_memory(
        XLSRConfig.xlsr_300m(compute_dtype="bfloat16", remat=True), c["groups"] * c["views"],
        c["samples"], overhead=1.0)
    ratio = peak_gib / est.analytic_gb
    print(f"[memory] {card}: conf-3 'attn' step (phase_remat): peak {peak_gib:.3f} GiB / "
          f"analytic sum {est.analytic_gb:.3f} GiB = overhead {ratio:.4f} "
          f"(parallel/memory.py H100_OVERHEAD {Mem.H100_OVERHEAD})")
    return {"peak_gib": peak_gib, "analytic_gib": est.analytic_gb, "overhead": ratio}


def phase_parallel_eval(K, card, tmp):
    """(c) of phase_parallel, at full depth: ``--multihost --eval`` from two
    ranks (each on the card, no process group), ``.part0`` and ``.part1``
    against the one-process ``--eval`` rows (batch 1 in both, so that each
    row's forward is the same) to 6 decimals, the parts' decode caches
    apart."""
    import contextlib
    import io

    from scl_deepfake_audio_detection_torch import cli
    from scl_deepfake_audio_detection_torch.cli.context import _rank_cli
    from scl_deepfake_audio_detection_torch.parallel import mesh as M

    c = PARALLEL
    db = os.path.join(tmp, "db")
    utts = _parallel_database(db, c["eval_utts"])
    common = ["--eval", "--config", EVAL_CONFIG, "--database_path", db, "--ssl_preset",
              "xlsr_300m", "--compute_dtype", "bfloat16", "--batch_size", "1",
              "--num_workers", "2", "--seed", str(c["seed"]), "--device", "cuda"]
    whole = os.path.join(tmp, "whole.txt")
    K.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(common + ["--eval_output", whole])
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"one-process --eval exited {rc}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parts = os.path.join(tmp, "scores.txt")
    codes = M.launch(_rank_cli, 2, args=(common + ["--multihost", "--eval_output", parts,
                                                   "--decode_cache",
                                                   os.path.join(tmp, "cache")],),
                     timeout=300)
    if codes != [0, 0]:
        raise AssertionError(f"(c) rank exit codes {codes}")
    rows = [_read_rows(f"{parts}.part{r}") for r in range(2)]
    want = sorted(_read_rows(whole))
    got = sorted(rows[0] + rows[1])
    same_utts = [r[0] for r in got] == [r[0] for r in want] and len(want) == len(utts)
    err = max(abs(float(x) - float(y)) for g, w in zip(got, want) for x, y in zip(g[1:], w[1:]))
    caches = sorted(os.listdir(os.path.join(tmp, "cache")))
    print(f"[parallel] (c) {card}: --multihost --eval from two ranks: parts of "
          f"{[len(r) for r in rows]} rows ({time.perf_counter() - t0:.1f}s with start-up), "
          f"union vs one process: max |diff| {err:.1e} (tol 5e-7, 6 decimals), decode "
          f"caches {caches}; one-process launches {launches}")
    if not same_utts or err > 5e-7 or [len(r) for r in rows] != [4, 4] or \
            caches != ["part0", "part1"]:
        raise AssertionError(f"(c): rows {rows} vs {want}")
    return launches


TOOLS = dict(batch=16, samples=64600, warmup=3, iters=10, k1=3, k2=9, lr=1e-5, seed=1234,
             pool=32, picks=4, cycles=2, gan_steps=3, gan_lr=1e-3, gemm=(16384, 4096, 4096),
             gemm_iters=300)
GAN_NETS = {"gan": ([4, 32, 2], [2, 32, 1]), "wgan": ([4, 32, 2], [2, 32, 1]),
            "aux": ([3, 16, 2], [2, 16, 1])}
GAN_ATOL = 1e-5  # fp32, TF32 off: the same steps on the CPU, sums in another order


def _gan_mlp(sizes, squeeze):
    """The MLP of the JAX package's GAN tests (``tests/test_gan_al.py``), from
    the port's ``Linear``; its JAX tree is a list of {w, b}."""
    from torch import nn

    from scl_deepfake_audio_detection_torch.models.base import Linear

    class MLP(nn.ModuleList):
        def apply(self, x, train=False, generator=None):
            for i, layer in enumerate(self):
                x = layer(x)
                if i < len(self) - 1:
                    x = torch.relu(x)
            return x[..., 0] if squeeze else x

    return MLP([Linear(i, o) for i, o in zip(sizes[:-1], sizes[1:])])


def _engine_digest(eng) -> str:
    """sha256 of the engine's parameters, buffers and AdamW state."""
    import hashlib

    h = hashlib.sha256()
    for name, t in eng.model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().float().cpu().numpy().tobytes())
    opt = eng.optimizer
    for t in opt.targets:
        for k, v in sorted(opt.adamw.state.get(t, {}).items()):
            h.update(k.encode())
            h.update(torch.as_tensor(v).detach().float().cpu().numpy().tobytes())
    h.update(str(opt.mini_step).encode())
    return h.hexdigest()


def _mfu_pair(flops, seconds, gemm_rate):
    from scl_deepfake_audio_detection_torch.utils import flops as FL

    pair = FL.mfu(flops, seconds), FL.mfu(flops, seconds, peak=gemm_rate)
    if not all(0.0 < x <= 1.05 for x in pair):
        raise AssertionError(f"MFU reading {pair} outside (0, 1.05]")
    return pair


def phase_tools(K, card, tmp):
    """The measurement tools and the NII trainers on the card: (e) the
    attainable bf16 GEMM rate; (a) ``utils/measure.chained_eval_throughput``
    at XLS-R 300M + LinearNLL bf16 [16, 64600], 24 layers, MFU against the
    H100's published peak and the measured rate; (f) a ``DataProbe`` of card
    tensors against one of their CPU copies; (b)
    ``utils/measure.train_ms_per_step`` on the conf-3 ``Engine`` (remat
    'attn'), its state digest unchanged; (c) ``al_loop`` over 32 clips,
    scored by that engine's model through ``score_step``, one train step a
    cycle, interrupted after a cycle and resumed from its cache, its picks
    equal to the CPU's over the card's log-probs; (d) ``GANEngine`` in three
    modes against the CPU, and its checkpoint written and loaded."""
    from scl_deepfake_audio_detection_torch.models.base import (
        cast_matmul_params,
        init_parameters,
    )
    from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
    from scl_deepfake_audio_detection_torch.models.params import to_jax
    from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig
    from scl_deepfake_audio_detection_torch.train import active_learning as AL
    from scl_deepfake_audio_detection_torch.train import gan as GAN
    from scl_deepfake_audio_detection_torch.train.engine import Engine, score_step
    from scl_deepfake_audio_detection_torch.train.optim import set_learning_rate
    from scl_deepfake_audio_detection_torch.utils import flops as FL
    from scl_deepfake_audio_detection_torch.utils import measure
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig, load_config
    from scl_deepfake_audio_detection_torch.utils.probe import DataProbe

    t = TOOLS
    out = {}
    layers = XLSRConfig.xlsr_300m().encoder_layers
    zero = {name: 0 for name in K.KERNELS}
    total = dict(zero)

    def launched(part, want):
        got = dict(K.LAUNCHES)
        print(f"[tools] ({part}) launches {got}, expected {want}")
        if got != {**zero, **want}:
            raise AssertionError(f"tools ({part}): launches {got}, expected {want}")
        for k, v in got.items():
            total[k] += v
        return got

    # (e) the attainable bf16 GEMM rate: chained through a one-element feed
    m, k, n = t["gemm"]
    g = torch.Generator(device="cuda").manual_seed(0)
    a = (0.1 * torch.randn(m, k, device="cuda", generator=g)).bfloat16()
    b = (0.1 * torch.randn(k, n, device="cuda", generator=g)).bfloat16()
    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def gemms(iters):
        for _ in range(iters):
            c = torch.matmul(a, b)
            a[0, :1] += c[0, :1] * 1e-30
        return c

    float(gemms(5).float().sum())
    t0 = time.perf_counter()
    ev[0].record()
    c = gemms(t["gemm_iters"])
    ev[1].record()
    float(c[0, 0])
    host_s = time.perf_counter() - t0
    flop = 2 * m * k * n * t["gemm_iters"]
    rate, ev_rate = flop / host_s, flop / (ev[0].elapsed_time(ev[1]) / 1e3)
    print(f"[tools] {card}: chained bf16 torch.matmul [{m}, {k}] x [{k}, {n}] x "
          f"{t['gemm_iters']}: {rate / 1e12:.2f} TFLOP/s (host readback), "
          f"{ev_rate / 1e12:.2f} TFLOP/s (CUDA events); published H100 SXM peak "
          f"{FL.PUBLISHED_H100_BF16_PEAK_FLOPS / 1e12:.1f}, utils/flops constant "
          f"{FL.MEASURED_ATTAINABLE_H100_BF16_FLOPS / 1e12:.2f}")
    if not 0 < rate <= 1.05 * FL.PUBLISHED_H100_BF16_PEAK_FLOPS:
        raise AssertionError(f"GEMM rate {rate:.4g} outside (0, 1.05 peak]")
    out["gemm"] = {"tflops": rate / 1e12, "events_tflops": ev_rate / 1e12,
                   "shape": [m, k, n], "iters": t["gemm_iters"]}
    del a, b, c
    torch.cuda.empty_cache()

    # (a) chained eval at [16, 64600], all 24 layers
    cfg = load_config(EVAL_CONFIG)
    ssl = XLSRConfig.xlsr_300m(compute_dtype="bfloat16")
    model = LinearNLL.from_config(cfg.model, ssl=ssl, device="cuda", seed=t["seed"])
    cast_matmul_params(model.eval(), torch.bfloat16)
    rng = np.random.default_rng(t["seed"])
    wav = torch.from_numpy((0.1 * rng.standard_normal((t["batch"], t["samples"])))
                           .astype(np.float32)).cuda()
    K.reset_launches()
    ups, ms = measure.chained_eval_throughput(model, wav, t["iters"], t["warmup"])
    launched("a", {"flash_attn_fwd": layers * (t["warmup"] + t["iters"])})
    fl = FL.forward_flops(ssl, t["samples"], batch=t["batch"])
    mfu, mfu_gemm = _mfu_pair(fl, ms / 1e3, rate)
    print(f"[tools] {card}: (a) chained_eval_throughput XLS-R 300M + LinearNLL bf16 "
          f"[{t['batch']}, {t['samples']}], {layers} layers, {t['iters']} iters: "
          f"{ups:.2f} utt/s, {ms:.3f} ms/iter, {fl / 1e12:.4f} TFLOP a forward, MFU "
          f"{mfu:.4f} of the H100's published 989.4 TFLOP/s, {mfu_gemm:.4f} of the "
          f"measured GEMM rate")
    out["eval"] = {"utt_per_s": ups, "ms": ms, "flops": fl, "mfu": mfu,
                   "mfu_of_gemm_rate": mfu_gemm}

    # (f) a probe of card tensors dumps what a probe of their CPU copies dumps
    with torch.inference_mode():
        lp = score_step(model, wav[:4])
    caps = [("log_probs", lp), ("wav", wav[:2, :1000]),
            ("bf16", lp.to(torch.bfloat16)), (None, lp[0, 0])]
    dumps = {}
    for where in ("cuda", "cpu"):
        pr = DataProbe()
        for name, x in caps:
            pr.add(x if where == "cuda" else x.cpu(), name=name)
        dumps[where] = pr.dump(os.path.join(tmp, f"probe_{where}"))
    with np.load(dumps["cuda"]) as zc, np.load(dumps["cpu"]) as zh:
        if zc.files != zh.files or any(
                zc[f].dtype != zh[f].dtype or not np.array_equal(zc[f], zh[f])
                for f in zc.files):
            raise AssertionError(f"probe dumps differ: {zc.files} vs {zh.files}")
    print(f"[tools] (f) DataProbe of {len(caps)} card tensors: {zc.files} equal to the "
          f"CPU copies' dump")
    del model, wav, lp
    torch.cuda.empty_cache()

    # (b) differenced train-step timing on the conf-3 Engine
    c = CONF3
    tcfg = TrainConfig(seed=c["seed"])
    tssl = XLSRConfig.xlsr_300m(compute_dtype=tcfg.compute_dtype, remat=tcfg.remat,
                                remat_policy="attn")
    eng = Engine(LinearNLL(ssl=tssl, device="cuda", seed=c["seed"]), tcfg)
    eng.init_state()
    set_learning_rate(eng.optimizer, t["lr"])
    batch = conf3_batches(1, c["seed"])[0]
    eng.train_step(eng.place_batch(batch), eng.step_generator(0, 0))  # AdamW state exists
    before = _engine_digest(eng)
    K.reset_launches()
    step_ms = measure.train_ms_per_step(eng, batch, t["k1"], t["k2"])
    steps = 2 * t["k1"] + t["k2"]
    launched("b", {"flash_attn_fwd": 2 * layers * steps, "flash_attn_bwd_dq": layers * steps,
                   "flash_attn_bwd_dkv": layers * steps})
    after = _engine_digest(eng)
    views = c["groups"] * c["views"]
    tfl = FL.train_step_flops(tssl, c["samples"], views)
    tmfu, tmfu_gemm = _mfu_pair(tfl, step_ms / 1e3, rate)
    print(f"[tools] {card}: (b) train_ms_per_step conf-3 [{c['groups']}, {c['views']}, "
          f"{c['samples']}] bf16 remat 'attn', k = {t['k1']}, {t['k2']}: {step_ms:.3f} "
          f"ms/step, {tfl / 1e12:.4f} TFLOP a step, MFU {tmfu:.4f} of 989.4 TFLOP/s, "
          f"{tmfu_gemm:.4f} of the measured GEMM rate; engine digest "
          f"{'unchanged' if after == before else 'CHANGED'}")
    if after != before:
        raise AssertionError("train_ms_per_step changed the engine's state")
    out["train"] = {"ms": step_ms, "flops": tfl, "mfu": tmfu, "mfu_of_gemm_rate": tmfu_gemm,
                    "steps_run": steps}

    # (c) active learning: the pool scored by the engine's model, one step a cycle
    pool_wav = (0.1 * rng.standard_normal((t["pool"], t["samples"]))
                * np.linspace(0.3, 1.5, t["pool"])[:, None]).astype(np.float32)
    pool_labels = np.arange(t["pool"]) % 2
    card_scores = []

    def score_pool(idx):
        rows = [score_step(eng.model, pool_wav[idx[i:i + t["batch"]]]).float().cpu().numpy()
                for i in range(0, len(idx), t["batch"])]
        card_scores.append((list(idx), np.concatenate(rows)))
        return card_scores[-1][1]

    def train_cycle(idx, n_epochs):  # idx: this cycle's picks (use_new_data_only)
        picked = sorted(idx)
        b = {"wav": pool_wav[picked][None, :, :c["samples"]],
             "labels": pool_labels[picked][None].astype(np.float32)}
        eng.train_step(eng.place_batch(b), eng.step_generator(100 + len(card_scores), 0))

    cache = os.path.join(tmp, "al_cache.json")
    al_kw = dict(samples_per_cycle=t["picks"], criterion="entropy", seed=t["seed"],
                 use_new_data_only=True, cache_path=cache)
    K.reset_launches()
    AL.al_loop(AL.ALConfig(cycles=1, **al_kw), [], list(range(t["pool"])), train_cycle,
               score_pool)
    state = AL.al_loop(AL.ALConfig(cycles=t["cycles"], **al_kw), [],
                       list(range(t["pool"])), train_cycle, score_pool)
    forwards = sum(math.ceil(len(i) / t["batch"]) for i, _ in card_scores)
    launched("c", {"flash_attn_fwd": layers * forwards + 2 * layers * t["cycles"],
                   "flash_attn_bwd_dq": layers * t["cycles"],
                   "flash_attn_bwd_dkv": layers * t["cycles"]})
    replay = iter(card_scores)

    def cpu_scores(idx):
        want_idx, lp = next(replay)
        if list(idx) != want_idx:
            raise AssertionError(f"active learning scored {idx}, the card {want_idx}")
        return lp

    cpu = AL.al_loop(AL.ALConfig(cycles=t["cycles"], **{**al_kw, "cache_path": None}), [],
                     list(range(t["pool"])), lambda i, n: None, cpu_scores)
    print(f"[tools] (c) al_loop {t['cycles']} cycles (the second resumed from the cache) "
          f"over {t['pool']} clips: picks {state.history}, on the CPU over the card's "
          f"log-probs {cpu.history}; {forwards} scoring forwards")
    if state.history != cpu.history or len(state.history) != t["cycles"]:
        raise AssertionError("active-learning selections differ from the CPU's")
    out["al"] = {"history": state.history, "forwards": forwards}
    del eng
    torch.cuda.empty_cache()

    # (d) GAN on the card against the CPU, fp32 with TF32 off
    worst = 0.0
    for mode, (sg, sd) in GAN_NETS.items():
        kw = {"gan": {}, "wgan": {"mode": "wgan"}, "aux": {"aux_loss_fn": GAN.mse_aux}}[mode]
        gen0, disc0 = _gan_mlp(sg, False), _gan_mlp(sd, True)
        init_parameters(gen0, torch.Generator().manual_seed(1))
        init_parameters(disc0, torch.Generator().manual_seed(2))
        grng = np.random.default_rng(3)
        batches = []
        for _ in range(t["gan_steps"]):
            z = grng.standard_normal((16, sg[0])).astype(np.float32)
            batches.append({"z": z, "real": (grng.standard_normal((16, 2)) + z[:, :2])
                            .astype(np.float32)})
        engs = {}
        for where in ("cuda", "cpu"):
            gen, disc = copy.deepcopy(gen0).to(where), copy.deepcopy(disc0).to(where)
            engs[where] = GAN.GANEngine(gen, disc, sg[0], lr_g=t["gan_lr"], lr_d=t["gan_lr"],
                                        **kw)
            engs[where].fit(lambda: batches, 1,
                            save_dir=os.path.join(tmp, f"gan_{mode}_{where}"))
        diff = max(_tree_diff(to_jax(getattr(engs["cuda"], net)),
                              to_jax(getattr(engs["cpu"], net))) for net in ("gen", "disc"))
        back = GAN.GANEngine(_gan_mlp(sg, False).cuda(), _gan_mlp(sd, True).cuda(), sg[0], **kw)
        extra = back.load(os.path.join(tmp, f"gan_{mode}_cuda", "gan_last.ckpt"))
        same = all(torch.equal(p, q) for p, q in zip(
            list(back.gen.parameters()) + list(back.disc.parameters()),
            list(engs["cuda"].gen.parameters()) + list(engs["cuda"].disc.parameters())))
        print(f"[tools] (d) GANEngine '{mode}' {t['gan_steps']} steps on the card vs the "
              f"CPU: max |d param| {diff:.3e} (tol {GAN_ATOL:.0e}); checkpoint (epoch "
              f"{extra.get('epoch')}) loads {'identical' if same else 'DIFFERENT'}")
        if diff > GAN_ATOL or not same:
            raise AssertionError(f"GAN '{mode}' disagrees with the CPU or its checkpoint")
        worst = max(worst, diff)
    out["gan_max_abs_err"] = worst
    return total, out


# phase_g3's tolerances, fp32 with TF32 off on both sides (the same
# operations summed in another order, by cuBLAS / cuDNN / cuFFT and by the
# CPU's libraries): outputs and log-dets within G3_ATOL of their largest
# entry, the batch-norm statistics likewise, gradients within G3_GRAD of each
# leaf's largest (a leaf that is zero up to rounding, such as the key bias
# ahead of the softmax or the depthwise bias ahead of a training batch norm,
# to G3_GRAD of the model's largest); a flow's reverse of its forward within
# G3_INVERT of the input's largest; the log-mel within G3_LOGMEL (natural
# log: a relative error of the mel power) and the power within G3_ATOL.
G3_ATOL, G3_GRAD, G3_INVERT, G3_LOGMEL = 1e-4, 1e-3, 1e-4, 1e-3
# the conformer at XLS-R 300M's width over its scoring frames [16, 201, 1024]
# (the JAX ConformerConfig defaults at dim 1024); VITS's coupling block and
# its duration predictor's ConvFlow (jaywalnut310/vits models.py:
# ResidualCouplingBlock(192, 192, 5, 1, 4), four mean-only couplings, each
# followed by a flip; StochasticDurationPredictor's ConvFlow(2, 192, 3,
# n_layers=3), 10 bins, tail bound 5.0, conditioned on [16, 201, 192])
G3 = {"frames": (16, 201, 1024), "depth": 2, "flow": (16, 201, 192), "flows": 4,
      "wav": (16, 64600)}


def _g3_scale(a, b) -> float:
    """max |a - b| over the largest |b| (1 for an all-zero b)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _g3_check(what, got, want, tol):
    err = _g3_scale(got, want)
    if not err <= tol:
        raise AssertionError(f"[g3] {what}: card vs CPU {err:.3e} of the largest > {tol:.0e}")
    return err


def _g3_grads(what, got, want):
    """Per-leaf gradient check of the card's {name: grad} against the CPU's."""
    top = max(float(g.abs().max()) for g in want.values())
    worst = 0.0
    for n, w in want.items():
        scale = max(float(w.abs().max()), G3_GRAD * top)
        err = float((got[n].float().cpu() - w.float()).abs().max()) / scale
        if not err <= G3_GRAD:
            raise AssertionError(f"[g3] {what} gradient {n}: {err:.3e} of its largest > "
                                 f"{G3_GRAD:.0e}")
        worst = max(worst, err)
    return worst


def _g3_run(model, fn, inputs, ct_seed):
    """``fn(model, *inputs)`` -> a tuple of tensors; the parameter and input
    gradients of a seeded weighting of their sum (one weight tensor per
    output).  Returns (outputs, {name: grad})."""
    inputs = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(model, *inputs)
    gen = torch.Generator().manual_seed(ct_seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen).to(o.device)).sum()
               for o in outs)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads.update({f"input{i}": t.grad for i, t in enumerate(inputs)})
    return [o.detach() for o in outs], grads


def _vits_block(nn, PF):
    """VITS's ResidualCouplingBlock: four mean-only couplings, each followed
    by a flip of the channels; forward returns (y, summed log-det)."""

    class CouplingBlock(nn.Module):
        def __init__(self):
            super().__init__()
            c = G3["flow"][2]
            self.flows = nn.ModuleList(PF.ResidualCoupling(c, c, 5, 4, mean_only=True,
                                                           dilation_rate=1)
                                       for _ in range(G3["flows"]))

        def forward(self, x, mask, reverse=False):
            if reverse:
                for f in reversed(self.flows):
                    x = f(PF.flip_flow(x, reverse=True), mask, reverse=True)
                return x
            logdet = 0.0
            for f in self.flows:
                x, ld = f(x, mask)
                x, _ = PF.flip_flow(x)
                logdet = logdet + ld
            return x, logdet

    return CouplingBlock()


def phase_g3(K, card):
    """Slice G3 on the card, each part against the same module on the CPU on
    the same weights and inputs (fp32, TF32 off): (a) the conformer at dim
    1024 over [16, 201, 1024], a training forward and backward (outputs,
    moved batch-norm statistics, parameter and input gradients) and an eval
    forward, with the forward's and the backward's ms; (b) VITS's coupling
    block and its duration predictor's ConvFlow over [16, 201, 192] with a
    ragged mask: forward (outputs, log-dets, gradients) and reverse, which
    must undo the forward; (c) ``dsp/spectral.melspec`` on [16, 64600].  It
    launches none of the three kernels."""
    import copy

    from torch import nn

    from scl_deepfake_audio_detection_torch.dsp import spectral as SP
    from scl_deepfake_audio_detection_torch.models.base import init_parameters
    from scl_deepfake_audio_detection_torch.models.conformer import Conformer, ConformerConfig
    from scl_deepfake_audio_detection_torch.ops import flows as PF

    K.reset_launches()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"card": card}
    b, t, d = G3["frames"]

    # (a) the conformer
    cfg = ConformerConfig(dim=d, depth=G3["depth"])
    cpu_model = init_parameters(Conformer(cfg), torch.Generator().manual_seed(31))
    card_model = copy.deepcopy(cpu_model).cuda()
    x = torch.randn(b, t, d, generator=torch.Generator().manual_seed(32))
    fwd = lambda m, xx: (m(xx, train=True),)  # noqa: E731
    (y_c,), g_c = _g3_run(card_model, fwd, [x.cuda()], 33)
    (y_p,), g_p = _g3_run(cpu_model, fwd, [x], 33)
    errs = {"conformer_train_out": _g3_check("conformer training output", y_c, y_p, G3_ATOL)}
    errs["conformer_bn"] = max(
        _g3_check(f"conformer {n}", bc, bp, G3_ATOL)
        for (n, bc), (_, bp) in zip(card_model.named_buffers(), cpu_model.named_buffers()))
    moved = float(next(card_model.buffers()).abs().max())
    if not moved > 0.0:
        raise AssertionError("[g3] the training forward did not move the batch-norm mean")
    errs["conformer_grad"] = _g3_grads("conformer", g_c, g_p)
    with torch.no_grad():  # eval rows are independent: the CPU scores four of them
        errs["conformer_eval_out"] = _g3_check(
            "conformer eval output", card_model(x.cuda())[:4], cpu_model(x[:4]), G3_ATOL)
    xc = x.cuda()
    with torch.no_grad():
        out["conformer_eval_fwd_ms"] = cuda_ms(lambda: card_model(xc), iters=10, warmup=2)
    xr = xc.clone().requires_grad_(True)
    out["conformer_train_fwd_ms"] = cuda_ms(lambda: card_model(xr, train=True), iters=10,
                                            warmup=2)
    yr = card_model(xr, train=True)
    ones = torch.ones_like(yr)

    def step():
        card_model.zero_grad(set_to_none=True)
        card_model(xr, train=True).backward(ones)

    out["conformer_train_fwd_bwd_ms"] = cuda_ms(step, iters=10, warmup=2)
    out["conformer_train_bwd_ms"] = out["conformer_train_fwd_bwd_ms"] - out["conformer_train_fwd_ms"]
    del yr, ones, card_model, cpu_model, g_c, g_p
    torch.cuda.empty_cache()
    print(f"[g3] (a) conformer dim {d}, depth {cfg.depth}, {cfg.heads} heads x "
          f"{cfg.dim_head}, kernel {cfg.conv_kernel} on [{b}, {t}, {d}] fp32: training "
          f"output {errs['conformer_train_out']:.3e}, batch-norm statistics "
          f"{errs['conformer_bn']:.3e}, eval output {errs['conformer_eval_out']:.3e} of "
          f"their largest (tol {G3_ATOL:.0e}), gradients {errs['conformer_grad']:.3e} of each "
          f"leaf's largest (tol {G3_GRAD:.0e}); training forward "
          f"{out['conformer_train_fwd_ms']:.3f} ms, backward {out['conformer_train_bwd_ms']:.3f} "
          f"ms, eval forward {out['conformer_eval_fwd_ms']:.3f} ms")

    # (b) the flows, VITS's widths, a ragged mask
    fb, ft, fc = G3["flow"]
    gen = torch.Generator().manual_seed(34)
    lengths = torch.randint(ft // 2, ft + 1, (fb,), generator=gen)
    lengths[0] = ft
    mask = (torch.arange(ft)[None, :] < lengths[:, None]).float()[..., None]
    block = init_parameters(_vits_block(nn, PF), gen)
    sdp = init_parameters(PF.ConvFlow(2, fc, 3, 3, num_bins=10, tail_bound=5.0), gen)
    with torch.no_grad():  # seeded projections: zero ones make the couplings the identity
        for f in block.flows:
            f.post.weight.normal_(0.0, 0.02, generator=gen)
        sdp.proj.weight.normal_(0.0, 0.02, generator=gen)
    z = torch.randn(fb, ft, fc, generator=gen)
    w = 2.0 * torch.randn(fb, ft, 2, generator=gen)
    h = torch.randn(fb, ft, fc, generator=gen)
    cases = {"coupling_block": (block, lambda m, zz: m(zz, mask.to(zz.device)), [z]),
             "conv_flow": (sdp, lambda m, ww, hh: m(ww, mask.to(ww.device), g=hh), [w, h])}
    for name, (module, fn, inputs) in cases.items():
        card_m = copy.deepcopy(module).cuda()
        outs_c, g_c = _g3_run(card_m, fn, [i.cuda() for i in inputs], 35)
        outs_p, g_p = _g3_run(module, fn, inputs, 35)
        errs[f"{name}_out"] = _g3_check(f"{name} output", outs_c[0], outs_p[0], G3_ATOL)
        errs[f"{name}_logdet"] = _g3_check(f"{name} log-det", outs_c[1], outs_p[1], G3_ATOL)
        errs[f"{name}_grad"] = _g3_grads(name, g_c, g_p)
        mc = mask.cuda()
        with torch.no_grad():
            if name == "coupling_block":
                # the valid frames (a coupling zeroes the masked frames of
                # the half it writes, and the flips bring every channel there)
                z_c = z.cuda()
                back = card_m(outs_c[0], mc, reverse=True) * mc
                want = z_c * mc
                fwd_rev = lambda: card_m(card_m(z_c, mc)[0], mc, reverse=True)  # noqa: E731
            else:
                w_c, h_c = w.cuda(), h.cuda()
                back = card_m(outs_c[0], mc, g=h_c, reverse=True)
                want = w_c * mc
                fwd_rev = lambda: card_m(card_m(w_c, mc, g=h_c)[0], mc, g=h_c,  # noqa: E731
                                         reverse=True)
            errs[f"{name}_invert"] = _g3_check(f"{name} reverse of forward", back, want,
                                               G3_INVERT)
            out[f"{name}_fwd_rev_ms"] = cuda_ms(fwd_rev, iters=10, warmup=2)
        del card_m
    print(f"[g3] (b) VITS coupling block ({G3['flows']} x ResidualCoupling({fc}, {fc}, 5, "
          f"4 layers, mean-only) + flip) on [{fb}, {ft}, {fc}], lengths {lengths.tolist()}: output "
          f"{errs['coupling_block_out']:.3e}, log-det {errs['coupling_block_logdet']:.3e} "
          f"(tol {G3_ATOL:.0e}), gradients {errs['coupling_block_grad']:.3e} (tol "
          f"{G3_GRAD:.0e}), reverse of forward {errs['coupling_block_invert']:.3e} (tol "
          f"{G3_INVERT:.0e}), forward + reverse {out['coupling_block_fwd_rev_ms']:.3f} ms; "
          f"ConvFlow(2, {fc}, 3, 3 layers, 10 bins, tail 5.0) on [{fb}, {ft}, 2] with g "
          f"[{fb}, {ft}, {fc}]: output {errs['conv_flow_out']:.3e}, log-det "
          f"{errs['conv_flow_logdet']:.3e}, gradients {errs['conv_flow_grad']:.3e}, reverse "
          f"of forward {errs['conv_flow_invert']:.3e}, forward + reverse "
          f"{out['conv_flow_fwd_rev_ms']:.3f} ms")

    # (c) melspec on the card
    wav = 0.1 * torch.randn(*G3["wav"], generator=torch.Generator().manual_seed(36))
    wav_c = wav.cuda()
    with torch.no_grad():
        errs["melspec_power"] = _g3_check("mel power", SP.melspec(wav_c, log=False),
                                          SP.melspec(wav, log=False), G3_ATOL)
        lm_c, lm_p = SP.melspec(wav_c), SP.melspec(wav)
        errs["melspec_log_abs"] = float((lm_c.cpu() - lm_p).abs().max())
        if not errs["melspec_log_abs"] <= G3_LOGMEL:
            raise AssertionError(f"[g3] log-mel: card vs CPU {errs['melspec_log_abs']:.3e} > "
                                 f"{G3_LOGMEL:.0e}")
        out["melspec_ms"] = cuda_ms(lambda: SP.melspec(wav_c), iters=20, warmup=3)
    print(f"[g3] (c) melspec [{G3['wav'][0]}, {G3['wav'][1]}] -> {tuple(lm_c.shape)}: power "
          f"{errs['melspec_power']:.3e} of its largest (tol {G3_ATOL:.0e}), log-mel "
          f"{errs['melspec_log_abs']:.3e} (tol {G3_LOGMEL:.0e}); {out['melspec_ms']:.3f} ms")

    launches = dict(K.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"[g3] launched a hand-written kernel: {launches}")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t0
    out["max_err"] = errs
    print(f"[g3] {card}: peak {out['peak_gib']:.3f} GiB, {out['seconds']:.1f} s, kernel "
          f"launches {launches}")
    return launches, out


def _tree_diff(a, b) -> float:
    """max |a - b| over two trees of the same structure."""
    from scl_deepfake_audio_detection_torch.utils.tree import keyed_leaves

    return max(float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
               for (_, x), (_, y) in zip(keyed_leaves(a), keyed_leaves(b)))


def _bound(nbytes, flops):
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations", \
        f"{nbytes / 1e6:.2f} MB -> {bytes_ms:.4f} ms, {flops / 1e9:.3f} GFLOP -> {flops_ms:.4f} ms"


def phase_backward_times(K, A, card, KB=None, shape=TRAIN_SHAPE):
    """Each backward kernel at ``shape`` (the train shape, or the
    distillation student's) against its plain version, the sdpa backward
    and its bound (the forward's entry at that shape too); with ``KB``, the
    earlier build's kernels too.  The dq kernel is timed with its D; torch's
    D is timed alone beside it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = torch.Generator(device="cuda").manual_seed(5)
    out = {"flash_attn_fwd": _fwd_entry(K, A, shape, card, g, KB)}
    q, k, v, do = _bwd_inputs(shape, torch.bfloat16, g)
    err, msg, err_delta = _bwd_check(K, A, q, k, v, do, None)
    print(f"[backward] at {list(shape)} bf16: {msg}")
    o, lse = K.flash_attn_fwd(q, k, v)
    _, delta = K.flash_attn_bwd_dq(q, k, v, o, do, lse)
    qr, kr, vr = (a.clone().requires_grad_() for a in (q, k, v))
    # the yardstick pinned to sdpa's flash backend, graphed, best of two runs
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        def fwd():
            return F.scaled_dot_product_attention(qr, kr, vr, scale=1.0)

        def fwd_bwd():
            return torch.autograd.grad(fwd(), (qr, kr, vr), do)

        eager_f, eager_fb = cuda_ms(fwd), cuda_ms(fwd_bwd)
        sdpa_f = min(graph_ms(fwd) for _ in range(2))
        sdpa_fb = min(graph_ms(fwd_bwd) for _ in range(2))
    lib = sdpa_fb - sdpa_f
    # torch's D, as the port computed it before the dq kernel did: four eager
    # launches (two casts, the product, the sum)
    d_graph = min(graph_ms(lambda: A._delta(o, do)) for _ in range(2))
    d_eager = cuda_ms(lambda: A._delta(o, do))
    print(f"[times] {card}: torch D = (dO.float() * O.float()).sum(-1) at "
          f"{list(shape)} bf16 (the port's D before the dq kernel computed it): "
          f"{d_graph:.4f} ms graphed (eager {d_eager:.4f} ms)")
    b, h, t, d = shape
    n = q.numel() * q.element_size()
    stats = 2 * b * h * t * 4  # L and D, fp32
    before_dq = None
    if KB and len(KB.ARGTYPES["flash_attn_bwd_dq"]) == len(K.ARGTYPES["flash_attn_bwd_dq"]):
        def before_dq():
            return KB.flash_attn_bwd_dq(q, k, v, o, do, lse)
    elif KB:
        # the earlier dq kernel took D as an input: time it with torch's D
        def before_dq():
            return KB.flash_attn_bwd_dq(q, k, v, do, lse, A._delta(o, do))
    runs = (
        # dq reads q, dO, O, K, V, L and writes dq and D
        ("flash_attn_bwd_dq", lambda: A.flash_bwd_dq_delta_reference(q, k, v, o, do, lse),
         lambda: K.flash_attn_bwd_dq(q, k, v, o, do, lse), before_dq,
         6 * n + stats, 6 * b * h * t * t * d),
        # dk/dv reads q, dO, K, V, L, D and writes dK and dV
        ("flash_attn_bwd_dkv", lambda: A.flash_bwd_dkv_reference(q, k, v, do, lse, delta),
         lambda: K.flash_attn_bwd_dkv(q, k, v, do, lse, delta),
         KB and (lambda: KB.flash_attn_bwd_dkv(q, k, v, do, lse, delta)),
         6 * n + stats, 8 * b * h * t * t * d))
    for name, plain, kern, before, nbytes, flops in runs:
        p1 = cuda_ms(plain)
        times = time_kernel(kern, before)
        p2 = cuda_ms(plain)
        bound, by, detail = _bound(nbytes, flops)
        print(f"[times] {card}: {name} {list(shape)} bf16: {timing_line(times)}, "
              f"plain {p1:.4f}/{p2:.4f} ms, sdpa backward (dq, dk, dv together) "
              f"{lib:.4f} ms, bound {bound:.4f} ms ({detail})")
        out[name] = {"shape": list(shape), "max_abs_err": err[name], **times,
                     "plain_ms": min(p1, p2), "bound_ms": bound, "bound_by": by,
                     "library_ms": lib}
    out["flash_attn_bwd_dq"].update(delta_max_abs_err=err_delta, torch_delta_ms=d_graph,
                                    torch_delta_eager_ms=d_eager)
    print(f"[times] {card}: at {list(shape)}, sdpa (flash backend, graphed, best of 2) "
          f"forward {sdpa_f:.4f} ms, forward + backward {sdpa_fb:.4f} ms; eager "
          f"{eager_f:.4f} and {eager_fb:.4f} ms")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--before", metavar="DIR",
                        help="another checkout of the repo whose kernels are timed "
                             "beside this tree's (ms_before)")
    args = parser.parse_args()
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
    laps = [t_start]

    def lap(name):
        now = time.perf_counter()
        print(f"[timeline] {name}: {now - laps[-1]:.1f}s (at {now - t_start:.1f}s)")
        laps.append(now)

    KB = None
    if args.before:
        KB = load_before(args.before)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            pending = pool.submit(KB.build)  # its nvcc runs beside this tree's
            phase_build(K)
            pending.result()
        print(f"[build] kernels of {args.before} built for ms_before")
    else:
        phase_build(K)
    lap("build")
    phase_kernel_vs_plain(K, A)
    phase_backward_vs_plain(K, A)
    phase_autograd(K, A)
    phase_memory(A)
    lap("kernels_vs_plain")
    phase_golden(K)
    phase_golden_train(K)
    lap("goldens")
    with tempfile.TemporaryDirectory() as tmp:
        eval_launches = phase_main_path(K, tmp)
    lap("main_path")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        modes_launches = phase_eval_modes(K, card, tmp)
    lap("eval_modes")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches, serve_stats = phase_serve(K, card, tmp)
    lap("serve")
    torch.cuda.empty_cache()
    print(f"[depth] the export, reference-checkpoint, training-CLI and --device_aug "
          f"phases: XLS-R 300M widths at {EARLY_LAYERS} encoder layers (phase_zoo drives "
          f"the CLI's training at all 24, its exports at {EARLY_LAYERS})")
    with tempfile.TemporaryDirectory() as tmp, cut_depth():
        export_launches, export_stats = phase_export(K, card, tmp)
    lap("export")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp, cut_depth():
        refckpt = phase_reference_ckpt(K, card, tmp)
    lap("reference_ckpt")
    torch.cuda.empty_cache()
    conv = phase_conv_impls(K, card)
    lap("conv_impls")
    torch.cuda.empty_cache()
    # the forward at bucketed scoring's longest batch, past T = 256
    modes_fwd = _fwd_entry(K, A, BUCKET_SHAPE, card, torch.Generator(device="cuda").manual_seed(6))
    eval_fwd = phase_times(K, A, card, KB)
    lap("times")
    torch.cuda.empty_cache()
    launches = phase_train_main_path(K, card)
    lap("train_main_path")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp, cut_depth():
        cli_launches, host = phase_train_cli(K, card, tmp)
        lap("train_cli")
        torch.cuda.empty_cache()
        aug_launches = phase_device_aug(K, card, host)
        lap("device_aug")
        torch.cuda.empty_cache()
        par_launches, par_stats = phase_parallel(K, card, tmp, host)
    with tempfile.TemporaryDirectory() as tmp:
        par_launches["multihost_eval_one_process"] = phase_parallel_eval(K, card, tmp)
    lap("parallel")
    torch.cuda.empty_cache()
    remat = phase_remat(K, card)
    par_stats["memory_overhead"] = memory_overhead(card, remat["attn"]["peak_gib"])
    lap("remat")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        zoo_launches, zoo, zoo_stats = phase_zoo(K, card, tmp)
    lap("zoo")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        distill_launches, distill_stats = phase_distill(K, card, tmp)
    lap("distill")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tools_launches, tools_stats = phase_tools(K, card, tmp)
    lap("tools")
    torch.cuda.empty_cache()
    g3_launches, g3_stats = phase_g3(K, card)
    lap("g3")
    torch.cuda.empty_cache()
    train_times = phase_backward_times(K, A, card, KB, TRAIN_SHAPE)
    student_times = phase_backward_times(K, A, card, KB, STUDENT_SHAPE)
    tp_times = phase_backward_times(K, A, card, KB, TP_SHAPE)
    lap("backward_times")
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f}s; launches on the "
          f"eval main path {eval_launches}, in the eval modes {modes_launches}, serving "
          f"{serve_launches}, from the exported scorer {export_launches}, on the "
          f"training main path {launches}, through the training CLI {cli_launches}, with "
          f"--device_aug {aug_launches}; remat per step "
          f"{ {k: v['launches'] for k, v in remat.items()} }; the model zoo {zoo}; "
          f"distillation {distill_launches}; the parallel path {par_launches}; the "
          f"measurement tools and active learning {tools_launches}; Slice G3 (the conformer, "
          f"the flows, melspec) {g3_launches}")
    # Each entry's launches belong to this slice's main path, the training CLI
    # under --mesh 1,1 --zero1 (phase_parallel (a)); its times to XLS-R 300M's
    # training shape, as in the entries of the slices before, so that they
    # compare across commits, with the times at the distillation student's
    # shape under "student_shape" and at a tensor-parallel rank's (8 heads of
    # 64, phase_parallel (b)) under "tp_shape".  The other paths' launches
    # (each rank of (b) per step among them) sit beside them, and the
    # forward's eval-shape times under "eval".
    kernels = []
    for name in K.KERNELS:
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"scl_deepfake_audio_detection_torch/csrc/{K.SOURCES[name]}",
            "replaces": REPLACES[name],
            "path": "parallel",
            "launches": par_launches["cli_mesh_1_1_zero1"][name],
            "launches_by_path": {"eval": eval_launches[name],
                                 "eval_modes": modes_launches[name],
                                 "serve": serve_launches["serve"][name],
                                 "serve_http": serve_launches["serve_http"][name],
                                 "eval_from_export": export_launches["eval_artifact"][name],
                                 "serve_from_export": export_launches["serve_artifact"][name],
                                 "train": launches[name], "train_cli": cli_launches[name],
                                 "train_cli_device_aug": aug_launches[name],
                                 **{f"remat_{k}_per_step": v["launches"][name]
                                    for k, v in remat.items()},
                                 **{f"zoo_{k}": v[name] for k, v in zoo_launches.items()},
                                 "zoo": zoo[name],
                                 **{k: v[name] for k, v in distill_launches.items()},
                                 **{f"parallel_{k}": v[name] for k, v in par_launches.items()},
                                 "tools": tools_launches[name],
                                 "g3": g3_launches[name]},
            **train_times[name],
            "student_shape": student_times[name],
            "tp_shape": tp_times[name],
        }
        if name == "flash_attn_fwd":
            entry["zoo"] = zoo_stats
            entry["distill"] = distill_stats
            entry["tools"] = {"card": card, "launches": tools_launches[name], **tools_stats}
            entry["eval"] = {"launches": eval_launches[name], **eval_fwd}
            entry["eval_modes"] = {"launches": modes_launches[name], **modes_fwd}
            entry["serve"] = {"launches": serve_launches["serve"][name],
                              "launches_http": serve_launches["serve_http"][name],
                              **serve_stats}
            entry["export"] = {"launches_eval": export_launches["eval_artifact"][name],
                               "launches_serve": export_launches["serve_artifact"][name],
                               "launches_per_forward":
                                   export_launches["artifact_forward"][name],
                               **export_stats}
        kernels.append(entry)
    print("[conv-json] " + json.dumps({"card": card, **conv}))
    print("[parallel-json] " + json.dumps({"card": card, **par_stats}))
    print("[refckpt-json] " + json.dumps(refckpt))
    print("[g3-json] " + json.dumps(g3_stats))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
