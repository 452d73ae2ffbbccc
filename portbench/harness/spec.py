"""Find the pieces of a cell by the names in ``BENCHMARK.json``.

A configuration is the JSON file that ``BENCHMARK.json`` names, and its
plain reference is ``portbench/reference/<reference>.py``.  A traffic mix is
``portbench/traffic/<name>.json``, read by the driver
``portbench/harness/drivers/<kind>.py`` that its ``kind`` names.  A
per-layer metric is ``portbench/metrics/<name>.py`` with a
``read(ctx)`` that returns a number or None.  A cell's limits for
``correct`` are ``portbench/limits/<cell>.json``.  Adding any of them is
adding files and entries; no file here names a cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.pb = self.root / "portbench"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.root / c["file"]).read_text())
                cfg["name"] = name
                return cfg
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        t = json.loads((self.pb / "traffic" / f"{name}.json").read_text())
        t["name"] = name
        return t

    def limits(self, cell: str) -> dict:
        return json.loads((self.pb / "limits" / f"{cell}.json").read_text())

    def driver(self, kind: str):
        return _load_file(self.pb / "harness" / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")

    def reference(self, name: str):
        return importlib.import_module(f"portbench.reference.{name}")

    def metric_reader(self, name: str) -> Callable:
        path = self.pb / "metrics" / f"{name}.py"
        return _load_file(path, "portbench_metric_" + name.replace(".", "_")).read

    def metrics_of(self, cell: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that apply to ``cell``:
        those without a ``workloads`` list, or whose list names it."""
        return [m for m in self.data[kind] if cell in m.get("workloads", [cell])]


def load(root=ROOT) -> Bench:
    return Bench(root)


def units(bench: Bench) -> Dict[str, str]:
    return {m["name"]: m["unit"] for k in ("end_to_end", "per_layer") for m in bench.data[k]}
