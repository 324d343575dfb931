"""The port stands alone: no module of tpdm_tpu_torch, and not
chip_smoke.py, imports JAX, Flax, Optax or the JAX package, nor the
checkpoint libraries that the card machine lacks (``safetensors``,
``transformers``, ``diffusers``, ``msgpack``: the port reads checkpoints
with its own ``utils/safetensors.py``), and the port's YAMLs name only
tpdm_tpu_torch targets (a ``_target_`` imports by name at run time, out of
the reach of the import scan)."""

import ast
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpdm_tpu", "safetensors", "transformers",
             "diffusers", "msgpack")
SOURCES = sorted((REPO / "tpdm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    assert not [n for n in names if _forbidden(n)], path


def test_the_scan_sees_the_imports_it_forbids():
    src = ("import jax\nimport jax.numpy as jnp\nfrom flax import linen\n"
           "from tpdm_tpu.ops import attention\nimport importlib\n"
           "importlib.import_module('optax')\nfrom tpdm_tpu_torch.ops import attention\n"
           "from safetensors.torch import load_file\nimport transformers, msgpack\n"
           "from diffusers import AutoencoderKL\nfrom tpdm_tpu_torch.utils import safetensors\n")
    assert sorted(n for n in _imported(ast.parse(src)) if _forbidden(n)) == sorted([
        "jax", "jax.numpy", "flax", "tpdm_tpu.ops", "optax", "safetensors.torch",
        "transformers", "msgpack", "diffusers"])


def _targets(node):
    if isinstance(node, dict):
        if "_target_" in node:
            yield node["_target_"]
        for v in node.values():
            yield from _targets(v)
    elif isinstance(node, list):
        for v in node:
            yield from _targets(v)


def test_port_yamls_target_only_the_port():
    paths = sorted((REPO / "configs" / "torch").rglob("*.yaml"))
    assert paths
    for path in paths:
        targets = list(_targets(yaml.safe_load(path.read_text())))
        assert targets and all(t.split(".")[0] == "tpdm_tpu_torch" for t in targets), path
