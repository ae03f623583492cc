"""The PyTorch port stands alone: no JAX, no flax, nothing of the JAX package.

Checked twice: by importing every module of the port in a fresh interpreter
and listing what got loaded, and by scanning the port's sources (and
``chip_smoke.py``) for import statements.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = "aliasfree_diffusion_models_pytorch_tpu_torch"
JAX_PKG = "aliasfree_diffusion_models_pytorch_tpu"
FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "optax", "orbax"}


def _forbidden(module: str) -> bool:
    # Exact name or dotted prefix: the port's own name starts with the JAX
    # package's name, so a bare startswith would flag the port itself.
    top = module.split(".")[0]
    return top in FORBIDDEN_TOP or module == JAX_PKG or module.startswith(JAX_PKG + ".")


def test_forbidden_matches_exact_names_only():
    assert _forbidden("jax.numpy")
    assert _forbidden(JAX_PKG)
    assert _forbidden(JAX_PKG + ".ops.filters")
    assert not _forbidden(PORT)
    assert not _forbidden(PORT + ".ops.filters")
    assert not _forbidden("jaxtyping_free_module")


def test_importing_every_port_module_loads_no_jax():
    code = f"""
import importlib, json, pkgutil, sys
before = set(sys.modules)
import {PORT} as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
print(json.dumps({{"imported": names, "loaded": sorted(set(sys.modules) - before)}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {PORT + m for m in (".cli", ".config", ".data", ".diffusion", ".train",
                               ".models.unet", ".ops.flash_attention", ".utils.checkpoint",
                               ".utils.kernels", ".utils.weights")} <= set(result["imported"])
    # importing the port builds no kernel and needs neither triton nor a CUDA toolchain
    assert "triton" not in result["loaded"]
    bad = [m for m in result["loaded"] if _forbidden(m)]
    assert not bad, bad


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((REPO / PORT).rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(REPO)): m for f in files for m in _imports(f) if _forbidden(m)}
    assert not bad, bad
