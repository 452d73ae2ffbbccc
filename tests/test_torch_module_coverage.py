"""The port covers the JAX package: every module of
``scl_deepfake_audio_detection_tpu`` has a counterpart file in
``scl_deepfake_audio_detection_torch`` (``dsp/rawboost_jax.py`` is
``dsp/rawboost_batched.py``, the one file of another name), and every public
top-level name a JAX module defines (a function, a class or an assigned
name; not an import) is defined in its counterpart, or is on the allow-list
below with its reason.  Both trees are read with ``ast``; neither package is
imported."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "scl_deepfake_audio_detection_tpu")
PORT_PKG = os.path.join(REPO, "scl_deepfake_audio_detection_torch")
RENAMED_FILES = {"dsp/rawboost_jax.py": "dsp/rawboost_batched.py"}


def _by_rule(name: str) -> bool:
    """The JAX package's functional parameter helpers: ``init_*``
    initialisers and the ``Params`` tree alias (the port's modules are
    ``nn.Module``s that fill their own parameters, ``models/base``), and the
    ``*_pspec`` PartitionSpec constructors (the port shards by
    ``parallel/mesh.param_pspecs`` and ``zero1_spec``)."""
    return name.startswith("init_") or name == "Params" or name.endswith("_pspec")


# JAX name -> its counterpart in the port: a name of the counterpart module
# ("Class" or "Class.method"), "path::Name" in another port module, or None
# where the port has none.
NOT_BY_NAME = {
    "ops/attention.py": {
        # the TPU's einsum-vs-Pallas switch, measured on a TPU; the port sends
        # every length to its kernel on the card (ROADMAP.md "North star")
        "FLASH_MIN_SEQ": None,
        "flash_available": None,
    },
    "ops/layers.py": {"PRECISION": None},  # XLA's matmul precision flag
    "ops/graph.py": {"gat": "GAT", "graph_pool": "GraphPool", "htrg_gat": "HtrgGAT"},
    "ops/flows.py": {"wn": "WN", "dds_conv": "DDSConv", "conv_relu_norm": "ConvReluNorm",
                     "res_block1": "ResBlock1", "res_block2": "ResBlock2",
                     "residual_coupling": "ResidualCoupling", "conv_flow": "ConvFlow",
                     "elementwise_affine": "ElementwiseAffine"},
    "models/conformer.py": {"conformer_block": "ConformerBlock", "conformer": "Conformer"},
    "models/xlsr.py": {"feature_encoder": "XLSR.feature_encoder",
                       "transformer_encoder": "XLSR.transformer_encoder",
                       "extract_features": "XLSR.extract_features"},
    "models/resnet.py": {"resnet_forward": "ResNet",
                         "resnet_buffers": "ResNet"},  # its BatchNorm buffers
    "parallel/mesh.py": {"shard_opt_state": "train/optim.py::Optimizer"},  # ZeRO-1 there
    "parallel/memory.py": {"HBMEstimate": "MemoryEstimate",
                           "estimate_train_hbm": "estimate_train_memory"},
    "parallel/pipeline.py": {"Carry": None},  # the JAX scan's carry type
    "utils/flops.py": {  # the TPU's rates; the port's are the H100's
        "PUBLISHED_V5E_BF16_PEAK_FLOPS": "PUBLISHED_H100_BF16_PEAK_FLOPS",
        "MEASURED_ATTAINABLE_BF16_FLOPS": "MEASURED_ATTAINABLE_H100_BF16_FLOPS"},
}


def _modules(root):
    out = []
    for d, _, files in os.walk(root):
        if "__pycache__" in d or "_build" in d:
            continue
        out += [os.path.relpath(os.path.join(d, f), root) for f in files if f.endswith(".py")]
    return sorted(out)


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read())


def _defined(tree):
    """{top-level name defined in the module: ast node}."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            out.update({t.id: node for t in node.targets if isinstance(t, ast.Name)})
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
    return out


def _public(tree):
    return {n for n in _defined(tree) if not n.startswith("_")}


def _counterpart(rel):
    return RENAMED_FILES.get(rel, rel)


def _resolves(spec, rel):
    """Whether ``spec`` names something the port defines."""
    path, name = spec.split("::") if "::" in spec else (_counterpart(rel), spec)
    defined = _defined(_tree(os.path.join(PORT_PKG, path)))
    cls, _, method = name.partition(".")
    if cls not in defined:
        return False
    if not method:
        return True
    return any(isinstance(n, ast.FunctionDef) and n.name == method
               for n in ast.walk(defined[cls]))


JAX_MODULES = _modules(JAX_PKG)


def test_every_jax_module_has_a_counterpart_file():
    port = set(_modules(PORT_PKG))
    missing = [rel for rel in JAX_MODULES if _counterpart(rel) not in port]
    assert not missing, missing
    assert len(JAX_MODULES) >= 80  # the walk found the package
    # the renamed file is the only one, and its JAX name is not in the port
    assert all(rel in JAX_MODULES and rel not in port for rel in RENAMED_FILES)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_of_the_module_is_ported(rel):
    want = _public(_tree(os.path.join(JAX_PKG, rel)))
    have = _public(_tree(os.path.join(PORT_PKG, _counterpart(rel))))
    allowed = NOT_BY_NAME.get(rel, {})
    missing = sorted(n for n in want - have if not _by_rule(n) and n not in allowed)
    assert not missing, f"{rel}: no counterpart for {missing}"
    unresolved = sorted(n for n, spec in allowed.items() if spec and not _resolves(spec, rel))
    assert not unresolved, f"{rel}: the allow-list names what the port lacks: {unresolved}"


def test_the_allow_list_holds_only_names_the_port_lacks():
    """No stale entry: each listed name is a public JAX name of its module
    that the counterpart does not define under that name."""
    for rel, names in NOT_BY_NAME.items():
        want = _public(_tree(os.path.join(JAX_PKG, rel)))
        have = _public(_tree(os.path.join(PORT_PKG, _counterpart(rel))))
        for n in names:
            assert n in want and n not in have, (rel, n)
