"""The port stands alone: no module of
``scl_deepfake_audio_detection_torch``, and neither ``chip_smoke.py`` nor
the ``scripts/profile_torch_*.py``, pulls in ``jax`` or the JAX package, and
importing compiles nothing."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

import scl_deepfake_audio_detection_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "scl_deepfake_audio_detection_tpu")


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        if not info.name.endswith("__main__"):
            names.append(info.name)
    return names


def test_every_port_module_imports_without_jax_or_the_jax_package():
    mods = _port_modules()
    assert len(mods) >= 25
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "raise SystemExit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_sweep_holds_the_conversion_and_artifact_modules():
    mods = set(_port_modules())
    for m in ("models.convert", "export", "ops.custom_ops", "train.parity", "cli.export"):
        assert f"{port.__name__}.{m}" in mods, m


def test_the_sweep_holds_the_zoo_modules():
    mods = set(_port_modules())
    for m in ("models.aasist", "models.resnet", "ops.graph"):
        assert f"{port.__name__}.{m}" in mods, m


def test_the_sweep_holds_the_parallel_modules():
    mods = set(_port_modules())
    for m in ("parallel", "parallel.mesh", "parallel.memory", "parallel.pipeline",
              "parallel.dryrun"):
        assert f"{port.__name__}.{m}" in mods, m


def test_the_parallel_tests_ranks_import_no_jax():
    """The spawned ranks of the parallel tests import their functions from
    ``tests/torch_parallel_ranks.py``: it must leave JAX out."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        "import torch_parallel_ranks\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "raise SystemExit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


SLICE_G3_MODULES = ("version", "models.conformer", "ops.flows", "ops.seq_utils",
                    "dsp.spectral", "dsp.morph", "dsp.vad", "dsp.pad", "dsp.biosegment")


def test_the_sweep_holds_the_conformer_flow_and_dsp_modules():
    """The conformer, the flows and sequence utilities and the DSP remainder
    are in the sweep, and importing them alone leaves JAX out (``dsp/pad``'s
    trims take the port's own VAD)."""
    mods = set(_port_modules())
    names = [f"{port.__name__}.{m}" for m in SLICE_G3_MODULES]
    assert set(names) <= mods, sorted(set(names) - mods)
    code = (
        "import importlib, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "raise SystemExit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_sweep_holds_the_distillation_and_codec_modules():
    mods = set(_port_modules())
    for m in ("train.distill", "dsp.codec", "ops.losses"):
        assert f"{port.__name__}.{m}" in mods, m


TOOL_MODULES = ("utils.flops", "utils.measure", "utils.probe", "data.generic_io",
                "utils.stats", "utils.filelists", "utils.text", "utils.warehouse",
                "train.schedulers", "train.monitor", "train.logs",
                "train.active_learning", "train.gan")


def test_the_sweep_holds_the_tool_modules():
    """The measurement tools and the NII trainers and host tools are in the
    sweep, and importing them alone leaves JAX out."""
    mods = set(_port_modules())
    names = [f"{port.__name__}.{m}" for m in TOOL_MODULES]
    assert len(names) == 13 and set(names) <= mods, sorted(set(names) - mods)
    code = (
        "import importlib, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "raise SystemExit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_importing_the_kernels_module_builds_nothing():
    code = (
        "from scl_deepfake_audio_detection_torch.ops import _kernels as K\n"
        "import sys\n"
        "assert K._LIBS == {} and all(n == 0 for n in K.LAUNCHES.values())\n"
        "assert 'triton' not in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("rel", ["chip_smoke.py", "scripts/profile_torch_eval.py",
                                 "scripts/profile_torch_train.py",
                                 "scripts/compare_torch_measure.py"] + sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, fs in os.walk(os.path.join(REPO, "scl_deepfake_audio_detection_torch"))
    for f in fs if f.endswith(".py")))
def test_no_source_file_of_the_port_imports_jax(rel):
    roots = _imported_roots(os.path.join(REPO, rel))
    assert not roots & set(FORBIDDEN), (rel, roots & set(FORBIDDEN))
