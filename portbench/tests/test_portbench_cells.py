"""Every traffic mix end to end at CPU sizes through the harness's own
entry (``cells.run_cell``), untraced and traced, held to the plain
reference; the planted faults and the float8 control come out not correct;
new pieces are found by name."""

import json
import math

import pytest

from portbench.harness import cells

SEED = 2 ** 31 + 12345  # over 32 signed bits, as the driver's seeds are

TINY = ["tiny-linearnll-eval", "tiny-aasist-eval", "tiny-linearnll-train", "tiny-linearnll-http"]


def _run(root, cell, trace=False, fault=None, seed=SEED):
    return cells.run_cell(cell, seed, 0.5, trace, device="cpu", root=root, fault=fault)


@pytest.mark.parametrize("cell", TINY)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_matches_the_reference(tiny_root, cell, trace):
    out = _run(tiny_root, cell, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) <= want
    for m in out["metrics"].values():
        assert math.isfinite(m["value"])
    if not trace:  # a CPU run reads no device metric: peak memory is the card's
        assert "setup_s" in out["metrics"] and "peak_mem_gib" not in out["metrics"]
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell,fault", [
    ("tiny-linearnll-eval", "answer"), ("tiny-aasist-eval", "answer"),
    ("tiny-linearnll-http", "answer"),
    ("tiny-linearnll-train", "unchanged"), ("tiny-linearnll-train", "half_batch"),
    ("tiny-linearnll-train", "moments_reset")])
def test_planted_fault_is_not_correct(tiny_root, cell, fault):
    out = _run(tiny_root, cell, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["tiny-linearnll-eval", "tiny-aasist-eval",
                                  "tiny-linearnll-train", "tiny-linearnll-http"])
def test_float8_control_is_not_correct(tiny_root, cell):
    """The reference in float8 in the program's place fails a limit."""
    ctx = cells.make_ctx(cell, SEED, 1.0, device="cpu", root=tiny_root)
    readings = ctx.bench.driver(ctx.traffic["kind"]).control(ctx, "fp8")
    limits = ctx.bench.limits(cell)
    assert any(readings[k] > v["limit"] for k, v in limits.items() if k in readings), readings


def test_same_seed_same_inputs(tiny_root):
    """A seed fixes the clips, their order and the weights, and another seed
    changes them (how many batches a window holds is the clock's)."""
    import numpy as np
    import torch

    from portbench.harness import traffic as gen, weights

    ctx = cells.make_ctx("tiny-linearnll-eval", SEED, device="cpu", root=tiny_root)
    spec = ctx.ref.param_spec(ctx.cfg)

    def inputs(seed):
        it = gen.batch_stream(seed, 8, 4)
        return (np.stack(gen.clips(seed, [4000] * 8)), [next(it) for _ in range(4)],
                weights.make(spec, seed, "cpu", ctx.cfg.get("init_scale")))

    (ca, oa, wa), (cb, ob, wb), (cc, _, wc) = inputs(SEED), inputs(SEED), inputs(SEED + 1)
    assert np.array_equal(ca, cb) and all(np.array_equal(x, y) for x, y in zip(oa, ob))
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert not np.array_equal(ca, cc) and not all(torch.equal(wa[k], wc[k]) for k in wa)


def test_new_config_mix_and_metric_found_by_name(tiny_root, tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added as
    new files and entries run with no edit to an existing file."""
    import shutil

    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "tiny-linearnll.json").read_text())
    cfg["head"]["mlp_layers"] = 2
    (pb / "configs" / "tiny-linearnll-2.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "tiny-eval-b2.json").write_text(json.dumps(
        {"kind": "eval_list", "batch": 2, "samples": 3200, "pool": 4, "wire": "float32",
         "warmup_batches": 1}))
    (pb / "metrics" / "rows_per_window.py").write_text(
        "def read(ctx):\n    return ctx.info['batches'] * ctx.traffic['batch']\n")
    (pb / "limits" / "tiny-new.json").write_text(json.dumps({"score_gap": {"limit": 1e-4}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-linearnll-2", "source": "tiny",
                             "file": "portbench/configs/tiny-linearnll-2.json", "reduced": [],
                             "why": "CPU test"})
    bench["workloads"].append({"name": "tiny-new", "config": "tiny-linearnll-2",
                               "traffic": "tiny-eval-b2", "chips": 1, "why": "CPU test"})
    bench["per_layer"].append({"name": "rows_per_window", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "eval writer",
                               "moves": "eval_utt_per_s", "workloads": ["tiny-new"]})
    for m in bench["end_to_end"]:
        if m["name"] == "eval_utt_per_s":
            m["workloads"].append("tiny-new")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = cells.run_cell("tiny-new", SEED, 0.5, True, device="cpu", root=root)
    assert out["correct"]
    assert out["metrics"]["rows_per_window"]["value"] > 0
    out = cells.run_cell("tiny-new", SEED, 0.5, False, device="cpu", root=root)
    assert out["metrics"]["eval_utt_per_s"]["value"] > 0


def test_serve_sweep_runs_without_a_cell(tiny_root, capsys):
    """The knee sweep takes a configuration and a mix by name, with no cell
    in ``BENCHMARK.json``, and prints one line a rate and the rate found."""
    import portbench.sweep_serve as sweep

    assert sweep.main(["--config", "tiny-linearnll", "--traffic", "tiny-http", "--rates", "10",
                       "--seconds", "0.5", "--seed", str(SEED), "--device", "cpu"],
                      root=tiny_root) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["rate_per_s"] == 10.0 and lines[0]["readings"]["unanswered"] == 0
    assert "highest_sustained_rate_per_s" in lines[-1]
