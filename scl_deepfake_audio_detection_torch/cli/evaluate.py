"""Eval-list scoring: ``--eval`` (``utt cm0 cm1``), ``--eval --predict``
(``utt score pred``), ``--eval --emb`` (per-utt ``.npy`` embeddings and
``scores.txt``), ``--eval --long_audio`` (overlapping crops, scores
averaged) and ``--resume_eval`` (score only what an earlier run left).

EvalDataset -> EvalLoader -> score_step -> the writers of
``train/scoring``, the flow of ``scl_deepfake_audio_detection_tpu/cli/evaluate.py``
with its decode cache (``--decode_cache``), its per-process file-list
slices (``RunContext.pidx`` of ``pcnt``; one process until multi-host runs
are ported) and ``--from_export``, where the artifact's scorer replaces the
model (fp32 input: ``--wire_dtype`` is ignored).
"""

from __future__ import annotations

import os
import sys
import time

import torch

from scl_deepfake_audio_detection_torch.cli.context import RunContext
from scl_deepfake_audio_detection_torch.data import protocols
from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
from scl_deepfake_audio_detection_torch.data.loader import EvalLoader
from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
from scl_deepfake_audio_detection_torch.ops.layers import dewire_pcm16
from scl_deepfake_audio_detection_torch.train import scoring
from scl_deepfake_audio_detection_torch.train.engine import score_step
from scl_deepfake_audio_detection_torch.utils.device import torch_dtype


def run(args, ctx: RunContext) -> int:
    scorer = ctx.scorer
    if scorer is None:
        # scoring needs no fp32 master weights: the matmul weights go to the
        # compute dtype once
        model = cast_matmul_params(ctx.model.eval(), torch_dtype(args.compute_dtype))

        def score_fn(wav):
            return score_step(model, wav)
    else:
        score_fn = scorer.score_tensor
    if ctx.desc["variant"] is None:
        _, file_eval = protocols.gen_list_eval_only(args.database_path)
    else:
        _, file_eval = protocols.gen_list_scl(args.database_path, "eval")
    pidx, pcnt = ctx.pidx, ctx.pcnt
    if pcnt > 1:  # this process's slice; `cat out.part*` merges them
        file_eval = file_eval[pidx::pcnt]
    print(f"no. of eval trials {len(file_eval)}")
    out = args.eval_output or "scores.txt"
    if pcnt > 1:
        out = f"{out}.part{pidx}"
    resume_append = False
    if args.resume_eval:
        if args.emb:
            print("--resume_eval supports --eval/--predict score files "
                  "(per-utt .npy embedding dirs don't resume); rerun "
                  "--emb without it", file=sys.stderr)
            return 2
        valid_rows, scored = scoring.read_valid_rows(out, n_tokens=3)
        if scored:
            file_eval = [u for u in file_eval if u not in scored]
            # rewrite exactly the rows kept: a torn final line and repeats go
            with open(out, "w") as f:
                f.writelines(valid_rows)
            resume_append = True
            print(f"resume: {len(scored)} utts already scored in {out}, "
                  f"{len(file_eval)} remaining")
            if not file_eval:
                print(f"nothing left to score -> {out}")
                return 0
    ds = EvalDataset(file_eval, args.database_path, padding_type=args.padding_type,
                     use_eval_subdir=ctx.desc["eval_subdir"])
    if args.decode_cache:
        # the first run decodes and packs once; later runs of a sweep read
        # memmap slices.  Each process of a multi-process run caches its own
        # slice of the list in part{k}: one shared pcm16.bin would be raced.
        cache_dir = (os.path.join(args.decode_cache, f"part{pidx}") if pcnt > 1
                     else args.decode_cache)
        ds.warm_decode_cache(cache_dir, num_workers=args.num_workers)
    wire_dtype = args.wire_dtype
    if scorer is not None and wire_dtype != "float32":
        # the exported program takes fp32; the PCM16 wire is score_step's
        print(f"--from_export scores float32 input; ignoring --wire_dtype {wire_dtype}",
              file=sys.stderr)
        wire_dtype = "float32"
    loader = EvalLoader(ds, batch_size=max(args.batch_size, 1),
                        num_workers=args.num_workers, wire_dtype=wire_dtype)
    t0 = time.time()
    total = len(file_eval)
    last = {"n": 0, "t": t0}

    def progress(n):
        if n - last["n"] >= max(200, total // 50) or n >= total:
            now = time.time()
            rate = (n - last["n"]) / max(now - last["t"], 1e-9)
            print(f"  scored {n}/{total} ({rate:.1f} utt/s)", file=sys.stderr)
            last["n"], last["t"] = n, now

    if args.long_audio and not (args.emb or args.predict):
        # one utterance at a time: each has its own number of crops, which
        # go through score_step in fixed [batch, 64600] blocks
        scoring.produce_long_audio_evaluation_file(
            ds, score_fn, out, batch=max(args.batch_size, 1), append=resume_append,
            progress=progress)
        print(f"scored {total} utts (long-audio chunked) in {time.time() - t0:.1f}s -> {out}")
        return 0
    if args.long_audio:
        print("--long_audio applies to --eval scoring only; "
              "--predict/--emb use the fixed-window path", file=sys.stderr)

    if args.emb:
        device = ctx.device

        def emb_fn(wav):
            with torch.inference_mode():
                o = model.apply(dewire_pcm16(torch.as_tensor(wav).to(device, non_blocking=True)),
                                train=False)
            return o.log_probs, o.emb

        scoring.produce_emb_file(loader, emb_fn, out, progress=progress)
    elif args.predict:
        scoring.produce_prediction_file(loader, score_fn, out, append=resume_append,
                                        progress=progress)
    else:
        scoring.produce_evaluation_file(loader, score_fn, out, append=resume_append,
                                        progress=progress)
    dt = time.time() - t0
    print(f"scored {total} utts in {dt:.1f}s ({total / dt:.1f} utt/s) -> {out}")
    return 0
