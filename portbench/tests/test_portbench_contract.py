"""``BENCHMARK.json``'s names and units, the entry's refusal without a card,
and a run that loads no JAX."""

import json
import re
import subprocess
import sys
import textwrap

from portbench.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for k in ("end_to_end", "per_layer") for m in bench[k]]
    names += [r for c in bench["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for k in ("end_to_end", "per_layer") for m in bench[k]]
    assert all(UNIT.match(u) for u in units), units
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in bench[kind]]
        assert len(seen) == len(set(seen))
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert (REPO / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (REPO / "portbench" / "limits" / f"{w['name']}.json").exists()
    for m in bench["per_layer"]:
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").exists()


def test_no_card_exits_nonzero_and_prints_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "conf3-eval-b16",
                        "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_run_loads_no_jax(tiny_root):
    """In a fresh process: the harness and the reference run a cell, and no
    module whose top-level name is jax or the JAX package is loaded."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from portbench.harness import cells
        out = cells.run_cell("tiny-linearnll-train", 2 ** 31 + 7, 0.3, True, device="cpu",
                             root={str(tiny_root)!r})
        assert out["correct"]
        out = cells.run_cell("tiny-aasist-eval", 2 ** 31 + 7, 0.3, False, device="cpu",
                             root={str(tiny_root)!r})
        top = {{m.split(".")[0] for m in sys.modules}}
        print(sorted(top & {{"jax", "jaxlib", "flax", "scl_deepfake_audio_detection_tpu"}}))
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
