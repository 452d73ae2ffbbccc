"""A copy of the benchmark at CPU sizes, for the tests: the benchmark's
files copied into a temporary root, with tiny configurations, mixes, limits
and cells added as files and entries beside the real ones."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_SSL = {"conv_layers": [[16, 10, 5], [16, 3, 2], [16, 2, 2]], "conv_bias": True,
            "encoder_dim": 32, "encoder_layers": 2, "ffn_dim": 64, "num_heads": 4,
            "pos_conv_kernel": 16, "pos_conv_groups": 4, "layer_norm_eps": 1e-5}

TRAFFIC = {
    "tiny-eval": {"kind": "eval_list", "batch": 4, "samples": 4000, "pool": 8, "wire": "int16",
                  "warmup_batches": 1},
    "tiny-train": {"kind": "train_steps", "groups": 2, "views": 4, "samples": 4000,
                   "pool_steps": 4, "check_steps": 3, "view_labels": [1, 1, 0, 0]},
    "tiny-http": {"kind": "http_open", "rate_per_s": 20.0, "min_samples": 2000,
                  "max_samples": 6000, "pool": 8, "cut": 4000, "batch_size": 4,
                  "max_wait_ms": 5.0, "max_queue": 256, "clients": 4, "warmup_requests": 2,
                  "latency_limit_ms": 250.0},
}

# float32 on the CPU: the port and the reference agree to round-off
LIMITS = {"score_gap": 1e-4, "score_gap_median": 1e-4, "score_gap_mean": 1e-4,
          "score_gap_p90": 1e-4, "score_gap_p95": 1e-4, "score_gap_p99": 1e-4,
          "clip_gap_mean": 1e-4, "clip_gap_median": 1e-4, "clip_gap_p95": 1e-4,
          "rows_missing": 0, "unanswered": 0, "loss_gap_step1": 1e-4, "loss_gap": 1e-4,
          "grad_gap_median": 1e-3, "update_gap_step1": 1e-3, "update_gap": 1e-3,
          "update_gap_median": 1e-3, "moment1_gap_median": 1e-3, "moment2_gap_median": 1e-3,
          "moment1_gap": 1e-3, "moment2_gap": 1e-3, "increment_gap_step2_median": 1e-3}

# each tiny cell, its configuration and mix, and the real cell whose
# limits it is held to by name (None: the serving mix, which has no cell)
CELLS = {"tiny-linearnll-eval": ("tiny-linearnll", "tiny-eval", "conf3-eval-b16"),
         "tiny-linearnll-train": ("tiny-linearnll", "tiny-train", "conf3-train-g2v11"),
         "tiny-aasist-eval": ("tiny-aasist", "tiny-eval", "aasist-eval-b64"),
         "tiny-linearnll-http": ("tiny-linearnll", "tiny-http", None)}


def make_root(tmp: Path) -> Path:
    """A benchmark root under ``tmp`` holding the tiny cells."""
    root = Path(tmp) / "bench"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    for name, base in (("tiny-linearnll", "xlsr300m-linearnll"), ("tiny-aasist", "xlsr300m-aasist")):
        cfg = json.loads((pb / "configs" / f"{base}.json").read_text())
        cfg["ssl"] = copy.deepcopy(TINY_SSL)
        cfg["precision"]["compute_dtype"] = "float32"
        cfg["precision"]["gelu"] = "erf"
        if cfg["head"]["kind"] == "linear_nll":
            cfg["head"]["emb_dim"] = 16
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "tiny", "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "CPU test"})
    for name, t in TRAFFIC.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for cell, (cfg, traffic, real) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": traffic, "chips": 1,
                                   "why": "CPU test"})
        names = (json.loads((pb / "limits" / f"{real}.json").read_text()) if real
                 else ("score_gap", "unanswered"))
        (pb / "limits" / f"{cell}.json").write_text(
            json.dumps({n: {"limit": LIMITS[n]} for n in names}))
    kinds = {"conf3-eval-b16": "eval", "conf3-train-g2v11": "train"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c for c in CELLS if any(c.endswith("-" + kinds[w])
                                                       for w in m["workloads"] if w in kinds)]
    bench["end_to_end"].append({"name": "serve_p95_ms", "unit": "ms", "better": "lower",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["tiny-linearnll-http"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
