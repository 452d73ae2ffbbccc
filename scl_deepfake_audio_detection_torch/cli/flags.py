"""The CLI's flags.

Counterpart of ``scl_deepfake_audio_detection_tpu/cli/flags.py``: every flag
of the JAX CLI with its name and default, so a shell workflow ports by
swapping the program name, plus ``--device`` (default ``cuda``; ``cpu`` runs
on the CPU).  ``--jax_cache`` is accepted and has no effect.
"""

from __future__ import annotations

import argparse
import dataclasses

from scl_deepfake_audio_detection_torch.utils.config import RawBoostConfig

_PORT_HELP = {
    "jax_cache": "accepted for the JAX CLI's flag surface; no effect in the port",
    "profile_dir": "write a torch.profiler trace of the first epoch here",
    "device_aug": "compose the view batches on the device (RawBoost, noise and "
                  "reverb over the whole batch); the host only decodes",
    "distill_from": "train the configured model as a distillation student of this "
                    "frozen teacher checkpoint (a .ckpt of either package or a reference "
                    ".pth; the teacher is wav2vec2_linear_nll at --teacher_preset): each "
                    "epoch sets the learning rate the training mode sets for it (the JAX "
                    "CLI sets none) and writes <out>/<tag>/student_last.ckpt; eval, serve "
                    "or export it with --model_path and the student's --ssl_preset.  "
                    "Students without batch-norm state only",
    "mesh": "mesh shape 'data,model', e.g. 8,1 or 4,2: training runs one rank a card "
            "(started here, or joined from torchrun's RANK/WORLD_SIZE/MASTER_ADDR/"
            "MASTER_PORT), the anchor groups split over 'data', the XLS-R heads and FFN "
            "over 'model'; --eval and --serve split each batch over data*model local "
            "cards, one model replica a card, in this process",
    "zero1": "shard the AdamW moments over the data ranks (ZeRO-1)",
    "multihost": "multi-process mode from torchrun's environment (RANK, WORLD_SIZE, "
                 "LOCAL_RANK, MASTER_ADDR, MASTER_PORT): training shards the loader "
                 "streams per data rank, eval splits the file list and writes "
                 "<out>.part<k> per process; with no such environment it runs as one "
                 "process",
    "export_model": "export the scoring function as a standalone artifact (a "
                    "torch.export program with a symbolic batch that runs on the "
                    "CPU and on the card, the weights as arguments) and exit; "
                    "deploy it with --from_export: no model code is needed on the "
                    "serving host",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="scl_deepfake_audio_detection_torch.cli",
        description="SCL deepfake audio detection on PyTorch/CUDA")
    p.add_argument("--database_path", type=str, default="/your/path/to/data/")
    # hyperparameters (reference main.py:226-241)
    p.add_argument("--batch_size", type=int, default=1,
                   help="eval batch size; alias for --groups_per_step in training")
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--min_lr", type=float, default=1e-8)
    p.add_argument("--max_lr", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--loss", type=str, default="weighted_CCE")
    p.add_argument("--config", type=str, default="configs/conf-3-linear.yaml")
    p.add_argument("--padding_type", type=str, default="zero", choices=["zero", "repeat"])
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--model_path", type=str, default=None, help="checkpoint to load")
    p.add_argument("--comment", type=str, default=None)
    # NII entry-config optimizer knobs (reference
    # core_scripts/config_parse/arg_parse.py:26ff --grad-clip-norm /
    # --accumulate; implemented in train/optim.py::make_optimizer)
    p.add_argument("--grad_clip_norm", type=float, default=None,
                   help="clip gradients to this global norm before the "
                        "optimizer update (default: no clipping)")
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="accumulate gradients over N steps before applying "
                        "one optimizer update (optax.MultiSteps)")
    p.add_argument("--early_metric", type=str, default="acc",
                   choices=["acc", "eer"],
                   help="early-stop / best-checkpoint signal: 'acc' is the "
                        "reference's val accuracy (main.py:400,418-421); "
                        "'eer' stops on per-epoch dev EER — the metric the "
                        "eval protocol actually scores")
    p.add_argument("--es_patience", type=int, default=10,
                   help="early-stop strikes before training halts "
                        "(reference hardcodes 10, main.py:26)")
    p.add_argument("--es_delta", type=float, default=0.01,
                   help="minimum metric improvement that resets the "
                        "early-stop counter (reference hardcodes 0.01)")
    # eval modes (reference main.py:247-254)
    p.add_argument("--eval_output", type=str, default=None)
    p.add_argument("--eval", action="store_true", default=False)
    p.add_argument("--predict", action="store_true", default=False)
    p.add_argument("--emb", action="store_true", default=False)
    # RawBoost knobs (reference main.py:258-298)
    p.add_argument("--algo", type=int, default=5)
    p.add_argument("--nBands", type=int, default=5)
    p.add_argument("--minF", type=int, default=20)
    p.add_argument("--maxF", type=int, default=8000)
    p.add_argument("--minBW", type=int, default=100)
    p.add_argument("--maxBW", type=int, default=1000)
    p.add_argument("--minCoeff", type=int, default=10)
    p.add_argument("--maxCoeff", type=int, default=100)
    p.add_argument("--minG", type=int, default=0)
    p.add_argument("--maxG", type=int, default=0)
    p.add_argument("--minBiasLinNonLin", type=int, default=5)
    p.add_argument("--maxBiasLinNonLin", type=int, default=20)
    p.add_argument("--N_f", type=int, default=5)
    p.add_argument("--P", type=int, default=10)
    p.add_argument("--g_sd", type=int, default=2)
    p.add_argument("--SNRmin", type=int, default=10)
    p.add_argument("--SNRmax", type=int, default=40)
    # TPU-native additions
    p.add_argument("--groups_per_step", type=int, default=None,
                   help="anchor groups per train step (default: batch_size)")
    p.add_argument("--mesh", type=str, default=None, help="mesh shape, e.g. 8,1")
    p.add_argument("--loss_scope", type=str, default="group", choices=["group", "global"])
    p.add_argument("--zero1", action="store_true", default=False,
                   help="shard AdamW moments over the data axis (ZeRO-1)")
    p.add_argument("--decode_cache", type=str, default=None,
                   help="dir for the packed eval decode cache (PCM16 memmap; "
                        "built on first eval run, reused by later sweeps)")
    p.add_argument("--serve", action="store_true", default=False,
                   help="persistent scorer: read wav paths (or 'id\\tpath') "
                        "from stdin, write 'id\\tscore' lines; one warm "
                        "model, no per-request startup cost")
    p.add_argument("--multihost", action="store_true", default=False,
                   help="TPU pod mode: jax.distributed.initialize(); train "
                        "shards loader streams per process over the global "
                        "mesh, eval splits the file list and writes "
                        "<out>.part<k> per host")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--ssl_checkpoint", type=str, default=None,
                   help="pretrained SSL: fairseq xlsr2_300m.pt or HF model dir")
    p.add_argument("--ssl_preset", type=str, default="xlsr_300m",
                   choices=["xlsr_300m", "xlsr_1b", "xlsr_2b",
                            "student_base", "tiny"],
                   help="SSL frontend size: xlsr_300m (reference scale), "
                        "xlsr_1b/2b (need --mesh tp and/or --zero1 — see "
                        "parallel/memory.py for per-chip HBM estimates), "
                        "student_base (12x768 distillation student), tiny "
                        "(CPU smoke tests)")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--out_dir", type=str, default="out")
    p.add_argument("--tensorboard_dir", type=str, default=None,
                   help="tensorboard scalar logs (default: <out>/<tag>/logs)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="capture a jax.profiler trace of the first epoch")
    p.add_argument("--device_aug", action="store_true", default=False,
                   help="compose view batches on the accelerator (RawBoost/"
                        "noise/reverb as one jit program; host only decodes)")
    p.add_argument("--snr_mode", type=str, default="reference",
                   choices=["reference", "rms"],
                   help="--device_aug noise/reverb semantics: 'reference' = "
                        "the pydub gain formula + int16-amplitude quirk "
                        "(matches the host/reference training distribution); "
                        "'rms' = textbook RMS-power SNR mix at signal scale")
    p.add_argument("--jax_cache", type=str, default="/tmp/scl_tpu_jax_cache",
                   help="persistent XLA compilation cache dir ('' disables); "
                        "repeat CLI runs skip the ~30s first compile")
    p.add_argument("--wire_dtype", type=str, default="float32",
                   choices=["float32", "int16"],
                   help="host->device wire format for eval batches and "
                        "--device_aug raw stacks; int16 halves PCIe/tunnel "
                        "transfer and is lossless for PCM16 audio")
    p.add_argument("--is_train", type=str, default="True",
                   help="accepted for reference flag compatibility "
                        "(main.py:236 — its type=bool makes any string "
                        "truthy there); here train/eval mode fully "
                        "determines dropout behavior, so this is a no-op")
    p.add_argument("--bf16_grads", action="store_true", default=False,
                   help="force bf16 encoder weight-grad stacks (XLSRConfig."
                        "grad_stack_dtype).  Under bf16 compute this is "
                        "already the default (auto) and is bit-identical "
                        "to fp32 stacks.  Under fp32 compute it shrinks "
                        "grad-stack HBM, but NOTE: the mechanism is casting "
                        "the stacked encoder weights to bf16 before the "
                        "layer scan, so the fp32 forward then runs on "
                        "bf16-rounded weights (train and eval through this "
                        "config) — a numerics change, not a free memory "
                        "knob")
    p.add_argument("--ckpt_every", type=int, default=1,
                   help="save last.ckpt every N epochs (best checkpoints and "
                        "the final epoch always save; a 300M full-state "
                        "checkpoint is ~3.8GB)")
    p.add_argument("--sync_ckpt", action="store_true", default=False,
                   help="disable the async checkpoint writer (npz/disk "
                        "writes then block the epoch loop)")
    p.add_argument("--warm_cache", action="store_true", default=False,
                   help="pre-populate the offline augmentation cache for the "
                        "train+dev lists (needs online_aug: false), then exit")
    # weights-day parity harness (train/parity.py)
    p.add_argument("--parity_check", type=str, default=None,
                   help="reference score file (e.g. docs/asvspoof2019_conf-3"
                        ".txt): convert --model_path / --ssl_checkpoint, "
                        "score the reference-scored utts present under "
                        "--database_path through the eval path, and diff "
                        "row-by-row; exit 0 iff all within --parity_tol")
    p.add_argument("--parity_n", type=int, default=200,
                   help="max utts to score for --parity_check (0 = all)")
    p.add_argument("--parity_tol", type=float, default=1e-2,
                   help="per-row |score diff| tolerance for --parity_check")
    # analysis mode (replaces Result.ipynb)
    p.add_argument("--show_params", action="store_true", default=False,
                   help="print the per-layer parameter table for the "
                        "configured model and exit (reference "
                        "script_model_para.py capability)")
    p.add_argument("--analyze", type=str, default=None, help="score file to analyze")
    p.add_argument("--protocol", type=str, default=None, help="protocol for --analyze")
    p.add_argument("--score_format", type=str, default="auto",
                   choices=["auto", "eval", "pred"])
    p.add_argument("--subset", type=str, default=None)
    p.add_argument("--asv_scores", type=str, default=None,
                   help="organizers' ASV score file (source key score): adds "
                        "the official min t-DCF to the --analyze report")
    p.add_argument("--tdcf_version", type=str, default="legacy",
                   choices=["legacy", "revised"],
                   help="t-DCF form: 'legacy' (ASVspoof 2019) or 'revised' "
                        "(ASVspoof 2021, constant-C0 normalization)")
    p.add_argument("--per_attack", action="store_true", default=False,
                   help="add per-attack EER breakdown to --analyze")
    p.add_argument("--bootstrap_ci", type=int, default=0, metavar="N",
                   help="add a percentile-bootstrap 95%% EER confidence "
                        "interval over N resamples to --analyze")
    p.add_argument("--json", action="store_true", default=False,
                   help="emit the --analyze report as one JSON object "
                        "instead of text")
    p.add_argument("--cllr", action="store_true", default=False,
                   help="add Cllr (scores treated as LLRs) and minCllr "
                        "(PAV discrimination floor) to --analyze")
    p.add_argument("--fit_calibration", type=str, default=None, metavar="SCORES",
                   help="fit affine LLR calibration (llr = a*score + b) on a "
                        "dev score file joined with --protocol; prints a,b "
                        "and the before/after Cllr")
    p.add_argument("--compare", type=str, default=None, metavar="A,B",
                   help="paired-bootstrap comparison of two score files on "
                        "the same --protocol: EER difference, 95%% CI, and "
                        "a two-sided bootstrap p-value")
    p.add_argument("--fuse", type=str, default=None, metavar="S1,S2[,..]",
                   help="fit logistic score fusion over K dev score files "
                        "(labels from --protocol); prints weights and the "
                        "fused EER/Cllr.  With --fuse_eval/--fuse_out, also "
                        "applies the fit to K matching eval score files")
    p.add_argument("--fuse_eval", type=str, default=None, metavar="E1,E2[,..]",
                   help="eval-side score files (same system order as --fuse)")
    p.add_argument("--fuse_out", type=str, default=None,
                   help="output path for fused eval scores (pred format)")
    p.add_argument("--average_ckpts", type=str, default=None,
                   metavar="C1,C2[,..]",
                   help="leaf-wise average K checkpoints (SWA-style final "
                        "model: float leaves incl. BN stats average, "
                        "optimizer/RNG state is dropped) and write the "
                        "result to --avg_out for --model_path use")
    p.add_argument("--avg_out", type=str, default=None,
                   help="output path for --average_ckpts "
                        "(default averaged.ckpt)")
    p.add_argument("--calibrate", type=str, default=None, metavar="A,B",
                   help="apply 'a,b' affine calibration to --serve scores "
                        "(emit calibrated LLRs instead of raw bonafide "
                        "log-probs)")
    p.add_argument("--serve_batch", type=int, default=1,
                   help="--serve: score up to N pending requests as ONE "
                        "fixed-shape batch (a batch-1 forward leaves most "
                        "of the card idle under load); "
                        "latency for a lone request is unchanged")
    p.add_argument("--serve_http", type=int, default=None, metavar="PORT",
                   help="HTTP scoring service on PORT (0 = ephemeral): "
                        "POST /score (audio bytes or JSON {'path': ...}), "
                        "POST /score_batch, GET /healthz; concurrent "
                        "requests micro-batch into --serve_batch-sized "
                        "forwards (serving.py).  Composes with "
                        "--from_export, --calibrate and --long_audio like "
                        "--serve")
    p.add_argument("--serve_host", type=str, default="127.0.0.1",
                   help="--serve_http bind address (default loopback; set "
                        "0.0.0.0 behind a load balancer)")
    p.add_argument("--serve_wait_ms", type=float, default=5.0,
                   help="--serve_http: max time a request waits for "
                        "co-riders before a partial batch runs (the "
                        "latency/throughput knob of micro-batching)")
    p.add_argument("--serve_max_queue", type=int, default=256,
                   help="--serve_http: shed load with HTTP 503 once this "
                        "many requests are queued in the micro-batcher "
                        "(bounded queue = bounded loaded latency; 0 = "
                        "unbounded)")
    p.add_argument("--distill_from", type=str, default=None, metavar="CKPT",
                   help="train the configured model as a DISTILLATION "
                        "student of this frozen teacher checkpoint (our "
                        ".ckpt or a reference .pth; teacher architecture = "
                        "wav2vec2_linear_nll at --teacher_preset).  Typical "
                        "use: --ssl_preset student_base for a ~2.2x-serving "
                        "student (PERFORMANCE.md).  Saves "
                        "<out>/<tag>/student_last.ckpt every epoch; eval/"
                        "serve/export it with --model_path + the student's "
                        "--ssl_preset.  Stateless students only (BN heads "
                        "need the full Engine)")
    p.add_argument("--teacher_preset", type=str, default="xlsr_300m",
                   choices=["xlsr_300m", "xlsr_1b", "xlsr_2b",
                            "student_base", "tiny"],
                   help="SSL size of the --distill_from teacher")
    p.add_argument("--distill_alpha", type=float, default=0.5,
                   help="CE weight; (1 - alpha) weighs the teacher KLD")
    p.add_argument("--distill_temp", type=float, default=20.0,
                   help="KLD temperature (reference kld_distill default)")
    p.add_argument("--distill_emb_w", type=float, default=0.0,
                   help="cosine embedding-matching weight (teacher and "
                        "student emb widths must match; 0 = off)")
    p.add_argument("--resume_eval", action="store_true", default=False,
                   help="--eval/--predict: if the output score file already "
                        "exists, keep its well-formed rows (a torn final "
                        "line from a killed run is dropped), score ONLY the "
                        "missing utterances and append them — restartable "
                        "70k-utt sweeps instead of rescoring from scratch. "
                        "Rows land in file order on a clean prefix; "
                        "downstream tools join on utt id either way")
    p.add_argument("--long_audio", action="store_true", default=False,
                   help="--eval/--serve: score audio LONGER than the 64600-"
                        "sample window as overlapping half-window-hop crops "
                        "with score averaging (train/scoring.score_long_audio)"
                        " instead of the reference's truncation — opt-in: it "
                        "uses evidence the reference discards, so scores for "
                        "long clips deliberately differ from reference parity")
    p.add_argument("--export_model", type=str, default=None, metavar="DIR",
                   help="export the scoring function as a standalone AOT "
                        "artifact (jax.export StableHLO, symbolic batch, "
                        "cpu+tpu lowering, weights as arguments) and exit; "
                        "deploy it with --from_export — no model code needed "
                        "on the serving host")
    p.add_argument("--export_quant", type=str, default=None,
                   choices=["int8"],
                   help="--export_model: store big float weight matrices as "
                        "symmetric per-channel int8 + fp32 scales (half the "
                        "bf16 artifact bytes again; ~4x vs fp32). Dequantized "
                        "to the original dtype at load — the serialized "
                        "program and serving numerics path are unchanged; "
                        "drift is weight rounding only. Check a deployment "
                        "with --verify_export")
    p.add_argument("--verify_export", type=str, default=None, metavar="DIR",
                   help="deployment hygiene: score a deterministic probe "
                        "batch through BOTH the --export_model artifact in "
                        "DIR and the in-process model (--config/--ssl_preset/"
                        "--model_path), print the max score difference, exit "
                        "0 iff within --parity_tol — catches artifact/"
                        "checkpoint drift before it serves traffic")
    p.add_argument("--from_export", type=str, default=None, metavar="DIR",
                   help="--serve/--eval/--predict from an --export_model "
                        "artifact: the serialized program + weights replace "
                        "model construction and checkpoint loading")
    p.add_argument("--export_reference_ckpt", type=str, default=None,
                   metavar="OUT.pth",
                   help="reverse migration: write the loaded wav2vec2_linear_"
                        "nll checkpoint (--model_path, ours or a reference "
                        ".pth) as a reference-loadable torch state dict "
                        "(main.py --model_path in the upstream stack) and "
                        "exit; round-tripping a reference .pth preserves its "
                        "BatchNorm/pretraining-head tensors byte-exactly")
    p.add_argument("--plot", type=str, default=None,
                   help="save the score-distribution figure of --analyze here")
    p.add_argument("--plot_det", type=str, default=None,
                   help="save a DET curve (normal-deviate axes) of --analyze here")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    for action in p._actions:
        if action.dest in _PORT_HELP:
            action.help = _PORT_HELP[action.dest]
    return p


def _rawboost_from_args(args) -> RawBoostConfig:
    fields = {f.name for f in dataclasses.fields(RawBoostConfig)}
    return RawBoostConfig(**{k: getattr(args, k) for k in fields if hasattr(args, k)})
