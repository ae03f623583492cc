"""Build and load the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``. Libraries
go to ``build/torch_kernels/`` at the root of the checkout, named by a hash of
the source, of every shared header in ``csrc/`` (``*.cuh``) and of the flags,
so an edited source or header is rebuilt and an unchanged one is reused.
Nothing is built at import: the first launch builds its kernel,
and :func:`build` builds several at once (one ``nvcc`` process per source,
all started together). Nothing is built or loaded while a CUDA graph is
being captured: :func:`load` raises there (``utils/graphs.py`` runs every
step once eagerly before it captures it).

This module is the one seam between the op modules and the libraries. Each
library exports one entry point, ``int afdm_<name>(..., void* stream)``
(``csrc/entry.cuh``), which an op module declares once as an :class:`Entry`
and calls with tensors and numbers: the entry sets the C signature, launches
under the tensors' device on its current stream, and turns a non-zero return
into a ``RuntimeError`` with the decoded error. :func:`on_card` is the wrappers'
one device check, :func:`sm_count` the one place the SM count is read, for
every launcher that sizes by it. Every wrapper that launches a kernel counts
its launches in its own ``launches`` attribute and is listed in
:data:`COUNTED` (:func:`count_launches`), so that a CUDA graph can add the
launches it captured once per replay.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# kernel name -> source file in csrc/
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "exp_chain": "exp_chain.cu", "qk_rowsum": "qk_rowsum.cu",
           "filtered_gelu": "filtered_gelu.cu", "plain_gelu": "plain_gelu.cu",
           "layer_norm": "layer_norm.cu"}

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
# C argument kinds of the entry points (csrc/entry.cuh): pointers, int, long long, float.
PTR, INT, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# A return at or above this is TENSOR_MAP_ERROR + the CUresult of a refused TMA
# tensor map (csrc/entry.cuh: kTensorMapError); below it, a cudaError_t.
TENSOR_MAP_ERROR = 100000

# The wrappers whose ``launches`` attribute counts their kernel launches.
COUNTED: list = []


def count_launches(wrapper):
    """Give ``wrapper`` a launch count of 0 and list it in :data:`COUNTED`."""
    wrapper.launches = 0
    COUNTED.append(wrapper)
    return wrapper


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, asked once: the launchers size
    their grids from it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed. Raises while the
    current stream is being captured into a CUDA graph: a build or a load
    must not happen under capture."""
    lib = _LOADED.get(name)
    if lib is None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"kernel library {name!r} first needed under CUDA graph "
                               "capture: run the step once eagerly before capturing it")
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib


def on_card(x: torch.Tensor, fn: str, cpu: bool = True) -> bool:
    """Whether ``fn`` launches its kernel for ``x``: True on a CUDA tensor;
    False on a CPU tensor where ``fn`` has a plain version (``cpu``); else
    raises ``ValueError``."""
    if x.device.type == "cuda":
        return True
    if cpu and x.device.type == "cpu":
        return False
    raise ValueError(f"{fn} runs on {'cpu or cuda' if cpu else 'cuda'}, got {x.device}")


class Entry:
    """The entry point ``afdm_<name>`` of the kernel library ``name``, whose
    arguments before the stream are of the C kinds ``argtypes`` (:data:`PTR`,
    :data:`INT`, :data:`I64`, :data:`F32`).

    ``entry(device, *args)`` loads the library at its first call (through
    :func:`load`, so not under CUDA-graph capture), passes a tensor as its
    data pointer and None as a null one, launches under ``device`` on its
    current stream, and raises ``RuntimeError("<name> launch failed: ...")``
    on a non-zero return.
    """

    def __init__(self, name: str, argtypes):
        self.name = name
        self.argtypes = tuple(argtypes)
        self._fn = self._error = None

    def _bind(self) -> None:
        lib = load(self.name)
        fn = getattr(lib, f"afdm_{self.name}")
        fn.argtypes, fn.restype = [*self.argtypes, PTR], INT
        lib.afdm_cuda_error_string.argtypes = [INT]
        lib.afdm_cuda_error_string.restype = ctypes.c_char_p
        self._fn, self._error = fn, lib.afdm_cuda_error_string

    def __call__(self, device: torch.device, *args) -> None:
        if self._fn is None:
            self._bind()
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(device):  # a no-op when device is the current one
            err = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            detail = (f" (CUresult {err - TENSOR_MAP_ERROR})" if err >= TENSOR_MAP_ERROR
                      else "")
            raise RuntimeError(
                f"{self.name} launch failed: {self._error(err).decode()}{detail}")
