"""The PyTorch port stands alone: no JAX, no flax, nothing of the JAX package,
and nothing of the repository's ``benchmarks``, ``bench`` or ``tests``.

Checked twice: by importing every module of the port, and each of its
examples (``examples/*_torch.py``), in a fresh interpreter and listing what
got loaded, and by scanning the port's sources (and ``chip_smoke.py``,
``bench_torch.py`` and the examples) for import statements.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = "aliasfree_diffusion_models_pytorch_tpu_torch"
JAX_PKG = "aliasfree_diffusion_models_pytorch_tpu"
FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "optax", "orbax", "benchmarks", "bench", "tests"}
EXAMPLES = ["quickstart_torch", "conditional_cfg_torch"]


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
    assert _forbidden("benchmarks.exp_micro") and _forbidden("bench") and _forbidden("tests.x")
    assert not _forbidden("benchmark_utils") and not _forbidden(PORT + ".probes")


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
                               ".utils.kernels", ".utils.weights", ".ops.probes", ".probes",
                               ".eval", ".eval_inception", ".tasks", ".utils.io",
                               ".utils.plotting", ".utils.jax_random", ".reproduce",
                               ".utils.native", ".utils.torch_compat")} <= set(result["imported"])
    # importing the port builds no kernel and needs neither triton nor a CUDA toolchain
    assert "triton" not in result["loaded"]
    # the image and plotting libraries are imported where they are used, not at import
    assert not {"PIL", "matplotlib", "imageio"} & set(result["loaded"])
    bad = [m for m in result["loaded"] if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize("example", EXAMPLES)
def test_importing_each_example_loads_no_jax(example):
    """An example imported by its path (its ``main`` guarded) loads the port
    and nothing forbidden."""
    code = f"""
import importlib.util, json, sys
before = set(sys.modules)
spec = importlib.util.spec_from_file_location("{example}", "examples/{example}.py")
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
assert callable(module.main)
print(json.dumps(sorted(set(sys.modules) - before)))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert PORT + ".train" in loaded and "torch" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((REPO / PORT).rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "bench_torch.py"]
    files += [REPO / "examples" / f"{name}.py" for name in EXAMPLES]
    assert len(files) > 20
    names = {f.name for f in files}
    assert {"probes.py", "eval.py", "eval_inception.py", "tasks.py", "plotting.py",
            "jax_random.py", "reproduce.py", "native.py", "torch_compat.py"} <= names
    bad = {str(f.relative_to(REPO)): m for f in files for m in _imports(f) if _forbidden(m)}
    assert not bad, bad


def test_every_kernel_source_is_registered_and_present():
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

    assert set(kernels.SOURCES) == {"flash_fwd", "flash_bwd", "exp_chain", "qk_rowsum",
                                    "filtered_gelu", "plain_gelu", "layer_norm"}
    on_disk = {p.name for p in kernels.CSRC.glob("*.cu")}
    assert on_disk == set(kernels.SOURCES.values())
    for name, source in kernels.SOURCES.items():
        text = (kernels.CSRC / source).read_text()
        assert f'extern "C" int afdm_{name}(' in text
        assert "cudaGetLastError" in text
        # a hand-written kernel: no library product, no PyTorch headers
        for banned in ("cublas", "cutlass/gemm/device", "torch/extension.h", "ATen"):
            assert banned not in text, (source, banned)
    assert "--use_fast_math" not in kernels.NVCC_FLAGS and "-use_fast_math" not in kernels.NVCC_FLAGS


def test_the_port_builds_only_from_its_own_sources():
    """The C++ data binding compiles the port's own copy of the source into
    the port's build directory, never the JAX package's ``native/``."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels, native

    pkg = REPO / PORT
    assert native.SOURCE.resolve().is_relative_to(pkg) and native.SOURCE.exists()
    assert native.BUILD_DIR.resolve() == REPO / "build" / "torch_native"
    assert kernels.CSRC.resolve() == pkg / "csrc"
    text = (REPO / PORT / "utils" / "native.py").read_text()
    assert '"native"' not in text and "native/build" not in text
