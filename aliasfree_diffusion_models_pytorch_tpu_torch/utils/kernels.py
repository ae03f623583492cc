"""Build and load the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``. Libraries
go to ``build/torch_kernels/`` at the root of the checkout, named by a hash of
the source, of every shared header in ``csrc/`` (``*.cuh``) and of the flags,
so an edited source or header is rebuilt and an unchanged one is reused. Nothing is built at import: the first launch builds its kernel,
and :func:`build` builds several at once (one ``nvcc`` process per source,
all started together).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# kernel name -> source file in csrc/
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "exp_chain": "exp_chain.cu", "qk_rowsum": "qk_rowsum.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (CUDA_HOME unset and no CUDA toolkit on PATH): "
            "the port's CUDA kernels are built from source at first use"
        )
    return nvcc


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the kernel's library goes: named by a hash of its source, the
    headers of ``csrc`` (any of them may be included) and the flags."""
    digest = hashlib.sha256((csrc / SOURCES[name]).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> list[BuildResult]:
    """Compile the named kernels (default: all) that are not built yet.

    All ``nvcc`` processes start together and are all waited for; a failed
    compile raises with its log after the others have finished.
    """
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, running = [], []
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            results.append(BuildResult(name, out, 0.0, "already built"))
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failures = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        results.append(BuildResult(name, out, seconds, log))
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


_LOADED: dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
