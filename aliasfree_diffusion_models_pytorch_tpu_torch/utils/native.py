"""ctypes binding to the port's host-side C++ data-loading runtime.

Counterpart of ``aliasfree_diffusion_models_pytorch_tpu/utils/native.py``.
Wraps ``csrc/csv_loader.cpp`` (the port's own copy): single-pass CSV parsing
and the splitmix64 Fisher-Yates permutation, which the data path uses, and the
batch gather, which it does not: numpy indexing is faster at the trainer's
batches, and ``chip_smoke.py`` times the two against each other. The library is
compiled with ``g++ -O3`` at first data use into ``build/torch_native/`` at
the root of the checkout, named by a hash of the source and the flags, so an
edited source is rebuilt. Without a compiler every caller keeps its numpy
path, which gives the same results; the run header records which one was
active (``native_loader``).

This is host CPU work (parsing and copying), not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "csv_loader.cpp"
BUILD_DIR = _PKG.parent / "build" / "torch_native"
_ARCH = platform.machine() or "unknown"
# x86-64-v3 (AVX2, 2015 on) rather than -march=native: a tree shared between
# hosts never loads a binary built for another CPU.
GXX_FLAGS = ("-O3", *(("-march=x86-64-v3",) if _ARCH in ("x86_64", "AMD64") else ()),
             "-std=c++17", "-fPIC", "-shared")


def library_path() -> Path:
    """Where the library goes: named by the host architecture and a hash of
    the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libafdm_native-{_ARCH}-{digest.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """Compile the library; None where that is not possible. The output is
    written to a per-process file and renamed into place, so processes that
    race the build each load a whole library."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    final = library_path()
    tmp = final.with_name(f".{final.name}.{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, final)
    except (OSError, subprocess.SubprocessError) as e:
        logger.info("native loader build skipped (%s); numpy path active", e)
        return None
    finally:
        tmp.unlink(missing_ok=True)
    logger.info("native loader compiled on first use: %s", final)
    return final


# Memo rather than lru_cache: a probe (native_status) must not mark the build
# as tried, so a later data call can still build.
_cache: dict = {"lib": None, "build_tried": False}


def load_native(build: bool = True):
    """The loaded library, or None. ``build=True`` (the data path) compiles
    it on first use; ``build=False`` only loads what is already built."""
    if _cache["lib"] is not None:
        return _cache["lib"]
    path = library_path()
    if not path.exists():
        if not build or _cache["build_tried"]:
            return None
        _cache["build_tried"] = True
        if _build() is None:
            return None
    lib = ctypes.CDLL(str(path))
    i64, p = ctypes.c_int64, ctypes.POINTER
    lib.afdm_csv_count_rows.restype = i64
    lib.afdm_csv_count_rows.argtypes = [ctypes.c_char_p]
    lib.afdm_parse_label_pixel_csv.restype = i64
    lib.afdm_parse_label_pixel_csv.argtypes = [
        ctypes.c_char_p, i64, p(ctypes.c_int32), p(ctypes.c_float), i64]
    lib.afdm_shuffled_permutation.restype = None
    lib.afdm_shuffled_permutation.argtypes = [i64, ctypes.c_uint64, ctypes.c_uint64, p(i64)]
    lib.afdm_gather_batch.restype = None
    lib.afdm_gather_batch.argtypes = [p(ctypes.c_float), p(i64), i64, i64, i64, p(ctypes.c_float)]
    _cache["lib"] = lib
    return lib


def native_status() -> str:
    """The run header's ``native_loader``; never builds."""
    if load_native(build=False) is not None:
        return "loaded"
    return "not built (builds on first data use)"


def parse_label_pixel_csv(path: str, cols: int = 784):
    """``(labels int32 [N], pixels float32 [N, cols] in [0, 1])`` of a CSV
    with a header line and ``label,p0,...`` rows; None if the library is
    unavailable or the file does not parse."""
    lib = load_native()
    if lib is None:
        return None
    n = lib.afdm_csv_count_rows(path.encode())
    if n <= 0:
        return None
    labels = np.empty(n, np.int32)
    pixels = np.empty((n, cols), np.float32)
    got = lib.afdm_parse_label_pixel_csv(
        path.encode(), cols,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pixels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
    )
    if got <= 0:
        return None
    return labels[:got], pixels[:got]


def shuffled_permutation(n: int, seed: int, epoch: int) -> np.ndarray | None:
    """The splitmix64 Fisher-Yates permutation of ``range(n)``; None if the
    library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    out = np.empty(n, np.int64)
    lib.afdm_shuffled_permutation(n, seed, epoch, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def gather_batch(images: np.ndarray, perm: np.ndarray, start: int,
                 bsz: int) -> np.ndarray | None:
    """``images[perm[start:start + bsz]]`` for C-contiguous f32 ``images``;
    None if the library is unavailable. Off the data path (see above)."""
    lib = load_native()
    if lib is None:
        return None
    flat = np.ascontiguousarray(images.reshape(images.shape[0], -1))
    stride = flat.shape[1]
    out = np.empty((bsz, stride), np.float32)
    lib.afdm_gather_batch(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        np.ascontiguousarray(perm, np.int64).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        start, bsz, stride,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out.reshape((bsz,) + images.shape[1:])
