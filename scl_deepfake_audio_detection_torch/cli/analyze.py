"""The CLI modes that build no model: ``--average_ckpts``, ``--compare``,
``--fuse``, ``--fit_calibration`` and ``--analyze``.

Counterpart of ``scl_deepfake_audio_detection_tpu/cli/analyze.py``.  Each
mode reads checkpoints, or score and protocol text files, and prints a
report; none touches a device, so they run with the default ``--device
cuda`` on a machine without a card.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import tempfile

from scl_deepfake_audio_detection_torch.train import analysis
from scl_deepfake_audio_detection_torch.train.calibration import (
    apply_calibration,
    cllr,
    logistic_calibration,
    min_cllr,
)
from scl_deepfake_audio_detection_torch.train.metrics import (
    compute_eer,
    eer_diff_bootstrap,
    min_tdcf,
)


def dispatch(args):
    """Run the analysis mode that ``args`` selects, in the JAX CLI's order;
    None when it selects none (the caller then builds the runtime)."""
    if args.average_ckpts:
        return run_average_ckpts(args)
    if args.compare:
        return run_compare(args)
    if args.fuse:
        return run_fuse(args)
    if args.fit_calibration:
        return run_fit_calibration(args)
    if args.analyze:
        return run_analyze(args)
    return None


def run_average_ckpts(args) -> int:
    from scl_deepfake_audio_detection_torch.train.checkpoint import average_checkpoints

    paths = [p.strip() for p in args.average_ckpts.split(",") if p.strip()]
    out = args.avg_out or "averaged.ckpt"
    try:
        avg, _ = average_checkpoints(paths, out_path=out)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    nbytes = sum(a.nbytes for a in avg.values())
    print(f"averaged {len(paths)} checkpoints ({len(avg)} leaves, "
          f"{nbytes/1e6:.1f} MB) -> {out}; eval/serve/export it with "
          f"--model_path {out}")
    return 0


def run_compare(args) -> int:
    if not args.protocol:
        print("--compare requires --protocol", file=sys.stderr)
        return 2
    pa, pb = (x.strip() for x in args.compare.split(",", 1))
    n_boot = args.bootstrap_ci or 1000
    ta, na, tb, nb_ = analysis.paired_system_scores(pa, pb, args.protocol,
                                                    fmt=args.score_format,
                                                    subset=args.subset)
    ea, _ = compute_eer(ta, na)
    eb, _ = compute_eer(tb, nb_)
    d, lo, hi, pv = eer_diff_bootstrap(ta, na, tb, nb_, n_boot=n_boot)
    verdict = ("A better" if hi < 0 else
               "B better" if lo > 0 else "not significant")
    print(f"A {pa}: EER {100*ea:.4f}%")
    print(f"B {pb}: EER {100*eb:.4f}%")
    print(f"paired EER difference A-B: {100*d:+.4f}% "
          f"(95% CI [{100*lo:+.4f}%, {100*hi:+.4f}%], "
          f"p={pv:.4f}, {n_boot} paired resamples) -> {verdict}")
    return 0


def run_fuse(args) -> int:
    if not args.protocol:
        print("--fuse requires --protocol (dev labels)", file=sys.stderr)
        return 2
    paths = [p_.strip() for p_ in args.fuse.split(",") if p_.strip()]
    w, b, rep = analysis.fit_fusion(paths, args.protocol, fmt=args.score_format,
                                    subset=args.subset)
    for sysr in rep["systems"]:
        print(f"system {sysr['path']}: EER {100*sysr['eer']:.4f}%")
    print(f"fused ({rep['n_matched']} labeled / {rep['n_common']} common "
          f"utts): EER {100*rep['fused']['eer']:.4f}%, "
          f"Cllr {rep['fused']['cllr']:.4f} bits; "
          f"weights={[round(float(x), 6) for x in w]} bias={b:.6f}")
    if args.fuse_eval and args.fuse_out:
        eval_paths = [p_.strip() for p_ in args.fuse_eval.split(",") if p_.strip()]
        if len(eval_paths) != len(paths):
            print("--fuse_eval must list one file per --fuse system", file=sys.stderr)
            return 2
        n = analysis.write_fused_scores(eval_paths, w, b, args.fuse_out,
                                        fmt=args.score_format)
        print(f"wrote {n} fused scores -> {args.fuse_out}")
    return 0


def run_fit_calibration(args) -> int:
    if not args.protocol:
        print("--fit_calibration requires --protocol", file=sys.stderr)
        return 2
    tar, non = analysis.matched_scores(args.fit_calibration, args.protocol,
                                       fmt=args.score_format, subset=args.subset)
    a, b = logistic_calibration(tar, non)
    before = cllr(tar, non)
    after = cllr(apply_calibration(tar, a, b), apply_calibration(non, a, b))
    print(f"calibration: a={a:.6f} b={b:.6f} "
          f"(Cllr {before:.4f} -> {after:.4f} bits); "
          f"pass --calibrate {a:.6f},{b:.6f} to --serve")
    return 0


def _merge_shards(pattern: str):
    """The files that match ``pattern`` (``scores.txt.part*`` of a sharded
    sweep) concatenated into one temporary file -> its path, or None when
    nothing matches."""
    parts = sorted(glob.glob(pattern))
    if not parts:
        return None
    with tempfile.NamedTemporaryFile("w", suffix=".scores.txt", delete=False) as f:
        for p in parts:
            with open(p) as shard:
                text = shard.read()
            f.write(text if text.endswith("\n") else text + "\n")
    print(f"merged {len(parts)} score shards")
    return f.name


def run_analyze(args) -> int:
    if not args.protocol:
        print("--analyze requires --protocol", file=sys.stderr)
        return 2
    score_path = args.analyze
    merged = None
    if not os.path.exists(score_path):
        merged = _merge_shards(score_path)
        if merged is None:
            print(f"no score file matches {score_path}", file=sys.stderr)
            return 2
        score_path = merged
    try:
        _analyze(args, score_path)
    finally:
        if merged:
            os.unlink(merged)
    return 0


def _analyze(args, score_path: str) -> None:
    join = dict(fmt=args.score_format, subset=args.subset)
    rep = analysis.score_report(score_path, args.protocol, per_attack=args.per_attack,
                                bootstrap_ci=args.bootstrap_ci, **join)
    # join once for every extra that needs the raw arrays
    tar = non = None
    if args.cllr or args.plot or args.plot_det or (args.asv_scores and args.json):
        tar, non = analysis.matched_scores(score_path, args.protocol, **join)
    out = rep.to_dict() if args.json else None
    if not args.json:
        print(rep)
    if args.cllr:
        c, mc = cllr(tar, non), min_cllr(tar, non)
        if args.json:
            out["cllr"] = c
            out["min_cllr"] = mc
        else:
            print(f"Cllr: {c:.4f} bits (scores as LLRs); minCllr: {mc:.4f} bits")
    if args.asv_scores:
        if args.json:
            tar_a, non_a, spoof_a = analysis.load_asv_scores(args.asv_scores)
            val, thr = min_tdcf(tar, non, tar_a, non_a, spoof_a, version=args.tdcf_version)
            out["min_tdcf"] = {"version": args.tdcf_version, "value": val,
                               "cm_threshold": thr}
            if args.per_attack:
                # the text report's breakdown: each attack against all
                # bonafide at the pooled ASV point
                _, _, by_atk = analysis._joined_trials(score_path, args.protocol, **join)
                _, asv_thr = compute_eer(tar_a, non_a)
                out["min_tdcf"]["per_attack"] = {
                    atk: min_tdcf(tar, ss, tar_a, non_a, spoof_a, version=args.tdcf_version,
                                  asv_threshold=asv_thr)[0]
                    for atk, ss in sorted(by_atk.items())
                }
        else:
            print(analysis.tdcf_report(score_path, args.protocol, args.asv_scores,
                                       version=args.tdcf_version,
                                       per_attack=args.per_attack, **join))
    if args.plot_det:
        path = analysis.plot_det_curve(tar, non, args.plot_det)
        if args.json:
            out["det_plot"] = path
        else:
            print(f"DET curve -> {path}")
    if args.plot:
        path = analysis.plot_score_distributions(tar, non, args.plot,
                                                 threshold=rep.threshold)
        if args.json:
            out["distribution_plot"] = path
        else:
            print(f"score distribution figure -> {path}")
    if args.json:
        print(json.dumps(out))
