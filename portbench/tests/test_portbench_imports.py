"""What the benchmark loads: never JAX, Flax or the JAX package; the
reference nothing of the port. Top-level module names are compared whole:
the port's name, ``aliasfree_diffusion_models_pytorch_tpu_torch``, begins
with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from portbench import run as bench_run
from portbench.lib import spec

JAX_SIDE = {"jax", "jaxlib", "flax", "aliasfree_diffusion_models_pytorch_tpu"}
PORT = "aliasfree_diffusion_models_pytorch_tpu_torch"


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _loaded_after(code: str) -> set[str]:
    """Top-level names of the modules loaded once ``code`` has run in a
    fresh interpreter at the checkout's root."""
    probe = (f"import sys; sys.path.insert(0, {str(spec.ROOT)!r})\n{code}\n"
             "print(sorted({m.split('.')[0] for m in list(sys.modules)}))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                          "HOME": str(spec.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))  # a list literal we printed


def test_no_source_imports_the_jax_side():
    for path in spec.BASE.rglob("*.py"):
        assert not (_imported(path) & JAX_SIDE), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (spec.BASE / "reference").rglob("*.py"):
        assert PORT not in _imported(path), path
    loaded = _loaded_after(
        "import portbench.reference.unet, portbench.reference.train, "
        "portbench.reference.diffusion, portbench.reference.data, "
        "portbench.reference.precision, portbench.reference.filters")
    assert PORT not in loaded and not (loaded & JAX_SIDE)


def test_a_run_loads_nothing_of_the_jax_side():
    """A whole tiny run on the CPU, the port's modules and the metric
    readers included; the check ``run.py`` makes after every run."""
    loaded = _loaded_after(
        "import tempfile, time\n"
        "from pathlib import Path\n"
        "from portbench import run\n"
        "from portbench.tests.helpers import tiny_bench\n"
        "tmp = Path(tempfile.mkdtemp())\n"
        "bench = tiny_bench(tmp)\n"
        "r = run.run_cell('tiny-ddim', 5, 0.2, False, 'cpu', bench=bench, base=tmp,"
        " t_start=time.perf_counter())\n"
        "assert r['correct'], r\n"
        "assert not run.forbidden_modules()")
    assert PORT in loaded
    assert not (loaded & JAX_SIDE), loaded & JAX_SIDE


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + ".probe", object())
    assert PORT not in bench_run.forbidden_modules()
    assert "aliasfree_diffusion_models_pytorch_tpu" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "aliasfree_diffusion_models_pytorch_tpu.ops", object())
    assert "aliasfree_diffusion_models_pytorch_tpu" in bench_run.forbidden_modules()


def test_no_card_no_result(capsys):
    """Without a CUDA card the command exits 2 and prints no result."""
    assert bench_run.main(["--workload", "train-D2N-b256", "--seed", "1", "--seconds", "1",
                           "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""
