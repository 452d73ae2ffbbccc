"""Readings that the limits of ``correct`` are set from (one process).

    python3 portbench/control.py --workload <cell> --seeds a,b,... \
        --control-seeds x,y,z [--seconds S] [--faults] [--look]

For each of ``--seeds`` it runs the cell as ``run.py`` does, with a window
of ``--seconds``, and prints the numbers it compares (the lower readings).
For each of ``--control-seeds`` it puts the plain reference, computed in
float8 (e4m3, the precision below the configurations' bfloat16), in the
program's place and prints the same numbers (the upper readings); with
``--faults`` also the program with each planted fault the cell's driver
knows, and, for training, the reference with half of the anchor groups left
out.  With ``--look`` (training) each of ``--seeds`` also prints the share
of elements whose first gradient's sign differs between the program and the
reference, and the reference's loss of each later check step from the
program's parameters before it (the program's forward, apart from how far
the two sides' parameters have parted).  One JSON line a reading.  Needs
the card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ["USE_FLAX"] = "0"

FAULTS = {"eval_list": ("answer",), "http_open": ("answer",),
          "train_steps": ("unchanged", "half_batch", "moments_reset")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--look", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from portbench.harness import cells

    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]

    def emit(kind, seed, checks, **extra):
        print(json.dumps({"kind": kind, "seed": seed, "checks": checks, **extra}), flush=True)

    for s in seeds:
        t0 = time.perf_counter()
        ctx = cells.make_ctx(args.workload, s, args.seconds, device=args.device)
        ctx.look = {} if args.look else None
        ctx.bench.driver(ctx.traffic["kind"]).run(ctx)
        out = cells.result(ctx)
        look = {k: v for k, v in (ctx.look or {}).items() if k not in ("params", "sign1")}
        del ctx
        emit("program", s, {k: v["value"] for k, v in out["checks"].items()},
             correct=out["correct"], info=out["info"], look=look,
             seconds=time.perf_counter() - t0)
    for s in cseeds:
        ctx = cells.make_ctx(args.workload, s, args.seconds, device=args.device)
        driver = ctx.bench.driver(ctx.traffic["kind"])
        emit("control_fp8", s, driver.control(ctx, "fp8"))
        if not args.faults:
            continue
        for fault in FAULTS[ctx.traffic["kind"]]:
            out = cells.run_cell(args.workload, s, args.seconds, False, device=args.device,
                                 fault=fault)
            emit("fault_" + fault, s, out["info"]["readings"], correct=out["correct"])
        if ctx.traffic["kind"] == "train_steps":
            emit("reference_half_batch", s, driver.control(ctx, fault="half_batch"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
