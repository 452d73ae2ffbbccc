"""Serving modes: a persistent scorer behind stdin lines (``--serve``) or
HTTP (``--serve_http``), two front ends to one warm model on the engine's
device; ``serving.py`` holds the HTTP micro-batcher.

Counterpart of ``scl_deepfake_audio_detection_tpu/cli/serve.py``.  With
``--from_export`` the artifact's scorer replaces the model, at its own cut
and, unless ``--calibrate`` says otherwise, with its own calibration.
"""

from __future__ import annotations

import queue
import sys
import threading

import numpy as np

from scl_deepfake_audio_detection_torch.cli.common import parse_calibration
from scl_deepfake_audio_detection_torch.cli.context import RunContext
from scl_deepfake_audio_detection_torch.dsp.pad import pad_eval
from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
from scl_deepfake_audio_detection_torch.train.engine import score_step
from scl_deepfake_audio_detection_torch.train.scoring import score_long_audio
from scl_deepfake_audio_detection_torch.utils.audio_io import load_audio, pcm16_encode
from scl_deepfake_audio_detection_torch.utils.device import torch_dtype

CUT = 64600  # the reference eval crop: one batch shape


def run(args, ctx: RunContext) -> int:
    scorer = ctx.scorer
    cut = CUT if scorer is None else scorer.cut
    cal = parse_calibration(args.calibrate)
    if cal is None and scorer is not None and scorer.calibration is not None:
        cal = scorer.calibration  # written into the artifact at export
        print(f"serve: applying the artifact's calibration a={cal[0]:.6f} b={cal[1]:.6f}",
              file=sys.stderr)
    if scorer is None:
        # scoring needs no fp32 master weights: the matmul weights go to the
        # compute dtype once
        model = cast_matmul_params(ctx.model.eval(), torch_dtype(args.compute_dtype))

        def batch_score(block):
            return score_step(model, block)
    else:
        batch_score = scorer.score_tensor
    sb = max(int(args.serve_batch), 1)

    if args.serve_http is not None:
        from scl_deepfake_audio_detection_torch.serving import serve_http

        wire16 = args.wire_dtype == "int16" and scorer is None
        if args.wire_dtype == "int16" and scorer is not None:
            print("serve_http: --wire_dtype int16 needs the in-process model (export "
                  "artifacts take float32); using float32", file=sys.stderr)

        def batch_score_async(block):
            """The unread device tensor, so that the MicroBatcher keeps two
            batches in flight.  ``--wire_dtype int16`` ships the batch as
            PCM16, half the host-to-device bytes; score_step rescales it on
            the device."""
            return batch_score(pcm16_encode(block) if wire16 else block)

        return serve_http(
            batch_score_async, cut=cut, host=args.serve_host, port=args.serve_http,
            batch_size=sb, max_wait_ms=args.serve_wait_ms,
            max_queue=args.serve_max_queue or None, padding_type=args.padding_type,
            calibration=cal, long_audio=args.long_audio,
            model_tag=scorer.meta["model_tag"] if scorer is not None else ctx.cfg.model.name)

    def score_group(group):
        """Score up to ``sb`` request lines as one [sb, cut] batch.

        A decode failure replies on its own line while its zero row keeps
        the batch shape.  With ``--long_audio``, a clip longer than the
        window scores as overlapping crops through the same [sb, cut]
        batches (``score_long_audio``), its mean replied in request order."""
        keys, rows, errs = [], [], []
        long_rows = {}
        for line in group:
            key, _, path = line.rpartition("\t")
            keys.append(key or path)
            try:
                raw_wav = load_audio(path)
                if args.long_audio and raw_wav.shape[0] > cut:
                    long_rows[len(rows)] = score_long_audio(raw_wav, batch_score, window=cut,
                                                            batch=sb)
                    rows.append(np.zeros(cut, np.float32))  # keeps the slot
                else:
                    rows.append(pad_eval(raw_wav, args.padding_type, cut))
                errs.append(None)
            except Exception as e:  # noqa: BLE001 -- a bad request replies ERROR
                rows.append(np.zeros(cut, np.float32))
                errs.append(e)
        lp = None
        if any(e is None and i not in long_rows for i, e in enumerate(errs)):
            batch = np.zeros((sb, cut), np.float32)
            batch[: len(rows)] = np.stack(rows)
            lp = batch_score(batch).float().cpu().numpy()
        for i, key in enumerate(keys):
            if errs[i] is not None:
                print(f"{key}\tERROR {errs[i]}", flush=True)
                continue
            row = long_rows.get(i)
            raw = float(row[1] if row is not None else lp[i, 1])
            # column 1 is the bonafide log-prob, the reference's score
            out = cal[0] * raw + cal[1] if cal else raw
            print(f"{key}\t{out:.6f}", flush=True)

    print("serve: one '<wav-path>' or '<id>\\t<wav-path>' per line; "
          "replies '<id-or-path>\\t<score>'", file=sys.stderr)

    # a reader thread feeds a queue, so that pending requests group into
    # one batch without non-blocking stdin
    q: "queue.Queue" = queue.Queue()

    def _reader():
        for line in sys.stdin:
            q.put(line)
        q.put(None)

    threading.Thread(target=_reader, daemon=True).start()
    eof = False
    while not eof:
        item = q.get()
        if item is None:
            break
        group = [item.strip()] if item.strip() else []
        while len(group) < sb:
            try:
                nxt = q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                eof = True
                break
            if nxt.strip():
                group.append(nxt.strip())
        if group:
            score_group(group)
    return 0
