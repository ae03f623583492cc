"""The two probe kernels' wrappers and their plain versions.

Counterparts of the Pallas kernels of the JAX package's two micro-probes:

* :func:`exp_chain` is ``benchmarks/exp_micro.py``'s ``kern`` (:96-100): per
  element, ``chain`` times, ``acc = op(acc) − 1`` for one of the probe's ten
  ops (:57-89, :125-136), plus ``exp_fast`` (``__expf``, the exponential of
  the port's f32 attention kernels; the bf16 ones take ``exp2``). It answers
  what an exponential costs on the card beside a polynomial on the FMA units.
* :func:`qk_rowsum` is ``benchmarks/attn_headpack.py``'s ``qk_rowsum_kernel``
  (:84-92): ``out[n, 0, q] = Σ_k Σ_d K[n, k, d]·Qᵀ[n, d, q]`` with the logits
  formed in registers and only their sums written. It answers what the
  matrix unit charges for QKᵀ at head dim 8 against 32 (block-diagonal
  packing) and 128.

A CPU tensor takes the plain version (:func:`exp_chain_plain`,
:func:`qk_rowsum_plain`); a CUDA tensor launches ``csrc/exp_chain.cu`` /
``csrc/qk_rowsum.cu`` on the current stream or raises. Each wrapper's
``launches`` attribute counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

__all__ = ["OPS", "exp_chain", "exp_chain_plain", "qk_rowsum", "qk_rowsum_plain",
           "block_diagonal_pack", "QK_HEAD_DIMS", "QK_QUERY_BLOCK"]

# The op's index here is the kernel's `op` argument (csrc/exp_chain.cu: enum Op).
OPS = ("copy", "mul2", "poly4", "exp", "exp2", "fastexp2", "tanh", "erf", "rsqrt1p",
       "logistic", "exp_fast")

LOG2E = float(math.log2(math.e))
_POLY4 = (0.5, 0.25, 0.125, 0.0625)
# 2^f on [-0.5, 0.5], degree 3: the JAX probe's four constants (exp_micro.py:83-85).
_FASTEXP2 = (0.05550410866, 0.2402265069, 0.6931471806, 1.0)


def _fastexp2(v: torch.Tensor) -> torch.Tensor:
    """exp(v) as 2^(v·log2e): round, subtract, degree-3 polynomial for 2^f,
    2^n by an add into the exponent field of the bit pattern. Below about −87
    the biased exponent is negative and the shift reaches the sign bit; the
    int32 arithmetic here wraps exactly as the JAX form's does."""
    y = v * LOG2E
    n = torch.round(y)  # half to even, as jnp.round
    f = y - n
    p = _FASTEXP2[0] * f + _FASTEXP2[1]
    p = p * f + _FASTEXP2[2]
    p = p * f + _FASTEXP2[3]
    biased = (n.to(torch.int32) + 127) << 23
    return p * biased.view(torch.float32)


def _poly4(v: torch.Tensor) -> torch.Tensor:
    acc = v
    for c in _POLY4:
        acc = acc * v + c
    return acc


_PLAIN = {
    "copy": lambda v: v,
    "mul2": lambda v: v * 2.0,
    "poly4": _poly4,
    "exp": torch.exp,
    "exp2": torch.exp2,
    "fastexp2": _fastexp2,
    "tanh": torch.tanh,
    "erf": torch.erf,
    "rsqrt1p": lambda v: torch.rsqrt(1.0 + v * v),
    "logistic": torch.sigmoid,
    "exp_fast": torch.exp,  # the plain version of __expf is the exponential itself
}


def exp_chain_plain(x: torch.Tensor, op: str, chain: int = 16,
                    subtract: bool = True) -> torch.Tensor:
    """``chain`` applications of ``acc = op(acc) − 1`` (or ``acc = op(acc)``
    without ``subtract``) on an f32 tensor, in plain PyTorch."""
    if op not in _PLAIN:
        raise ValueError(f"unknown op {op!r}; one of {OPS}")
    fn = _PLAIN[op]
    acc = x
    for _ in range(int(chain)):
        acc = fn(acc)
        if subtract:
            acc = acc - 1.0
    return acc.clone() if acc is x else acc


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """The kernel's library with its C signatures declared."""
    lib = kernels.load(name)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "exp_chain":
        lib.afdm_exp_chain.argtypes = [vp, vp, ctypes.c_longlong, ci, ci, ci, vp]
        lib.afdm_exp_chain.restype = ci
    else:
        lib.afdm_qk_rowsum.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.afdm_qk_rowsum.restype = ci
    lib.afdm_cuda_error_string.argtypes = [ci]
    lib.afdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def exp_chain(x: torch.Tensor, op: str, chain: int = 16, subtract: bool = True) -> torch.Tensor:
    """``chain`` applications of ``acc = op(acc) − 1`` per element of the f32
    tensor ``x``; returns a new tensor of the same shape.

    CPU tensors take :func:`exp_chain_plain`. CUDA tensors launch the
    hand-written kernel on the current stream (each element read once and
    written once); anything it cannot take raises. ``subtract=False`` with
    ``chain=1`` is a single application of ``op``.
    """
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; one of {OPS}")
    chain = int(chain)
    if chain < 0:
        raise ValueError(f"chain must be >= 0, got {chain}")
    if x.device.type == "cpu":
        return exp_chain_plain(x, op, chain, subtract)
    if x.device.type != "cuda":
        raise ValueError(f"exp_chain runs on cpu or cuda, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"exp_chain takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (a view into the middle of a tensor is not)")
    out = torch.empty_like(x)
    lib = _lib("exp_chain")
    with torch.cuda.device(x.device):
        err = lib.afdm_exp_chain(
            x.data_ptr(), out.data_ptr(), x.numel(), OPS.index(op), chain, int(bool(subtract)),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"exp_chain launch failed: {lib.afdm_cuda_error_string(err).decode()}")
    exp_chain.launches += 1
    return out


exp_chain.launches = 0

QK_HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernel's template instantiations
QK_QUERY_BLOCK = 128  # queries per block: s must be a multiple
# The plain version holds the (chunk, s, s) f32 logits in memory: it walks n in
# chunks that keep them under this many bytes.
PLAIN_LOGITS_BYTES = 2**30


def qk_rowsum_plain(k: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """``out[n, 0, q] = Σ_k Σ_d k[n, k, d]·qt[n, d, q]`` in plain PyTorch: the
    f32 logits of as many groups at a time as fit in ``PLAIN_LOGITS_BYTES``,
    summed over the keys."""
    n, s, _ = k.shape
    chunk = max(1, min(n, PLAIN_LOGITS_BYTES // (4 * s * s)))
    out = torch.empty((n, 1, s), dtype=torch.float32, device=k.device)
    for i in range(0, n, chunk):
        logits = torch.bmm(k[i:i + chunk].float(), qt[i:i + chunk].float())
        out[i:i + chunk] = logits.sum(dim=1, keepdim=True)
    return out


def _check_qk(k: torch.Tensor, qt: torch.Tensor) -> None:
    if k.dim() != 3 or qt.dim() != 3:
        raise ValueError(f"expected k (n, s, d) and qt (n, d, s), got {tuple(k.shape)} "
                         f"and {tuple(qt.shape)}")
    n, s, d = k.shape
    if tuple(qt.shape) != (n, d, s):
        raise ValueError(f"qt must be {(n, d, s)} for k {(n, s, d)}, got {tuple(qt.shape)}")
    if qt.device != k.device:
        raise ValueError(f"k on {k.device} but qt on {qt.device}")
    if n < 1 or s < 1:
        raise ValueError(f"empty input {tuple(k.shape)}")


def qk_rowsum(k: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """Row sums over the keys of the logits ``k·qt``: k (n, s, d) and qt
    (n, d, s) in bf16 → (n, 1, s) f32.

    CPU tensors take :func:`qk_rowsum_plain`. CUDA tensors launch the
    hand-written kernel on the current stream, which forms every logit in
    registers on the tensor cores (``mma.sync``) and writes only the sums.
    Anything the kernel cannot take raises.
    """
    _check_qk(k, qt)
    if k.device.type == "cpu":
        return qk_rowsum_plain(k, qt)
    if k.device.type != "cuda":
        raise ValueError(f"qk_rowsum runs on cpu or cuda, got {k.device}")
    n, s, d = k.shape
    if k.dtype != torch.bfloat16 or qt.dtype != torch.bfloat16:
        raise TypeError(f"qk_rowsum takes bfloat16, got {k.dtype} and {qt.dtype}")
    if d not in QK_HEAD_DIMS:
        raise ValueError(f"depth {d} not in {QK_HEAD_DIMS}")
    if s % QK_QUERY_BLOCK:
        raise ValueError(f"s must be a multiple of {QK_QUERY_BLOCK}, got {s}")
    if n > 65535:
        raise ValueError(f"n must be at most 65535 (the grid's second axis), got {n}")
    if not (k.is_contiguous() and qt.is_contiguous()):
        raise ValueError("k and qt must be contiguous")
    out = torch.empty((n, 1, s), dtype=torch.float32, device=k.device)
    lib = _lib("qk_rowsum")
    with torch.cuda.device(k.device):
        err = lib.afdm_qk_rowsum(
            k.data_ptr(), qt.data_ptr(), out.data_ptr(), n, s, d,
            torch.cuda.current_stream(k.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"qk_rowsum launch failed: {lib.afdm_cuda_error_string(err).decode()}")
    qk_rowsum.launches += 1
    return out


qk_rowsum.launches = 0


def block_diagonal_pack(k: torch.Tensor, qt: torch.Tensor, heads: int):
    """Pack ``heads`` consecutive groups into one block-diagonal operand pair,
    as ``attn_headpack.py:134-142`` does: k (b·h, s, d), qt (b·h, d, s) →
    (b, h·s, h·d) and (b, h·d, h·s), head i on the i-th diagonal block and
    zeros elsewhere. The packed product holds the heads' own logits on its
    diagonal blocks and cross-head products off them."""
    bh, s, d = k.shape
    if bh % heads:
        raise ValueError(f"{bh} groups do not divide into {heads} heads")
    b = bh // heads
    kp = k.new_zeros((b, heads * s, heads * d))
    qtp = qt.new_zeros((b, heads * d, heads * s))
    k4, qt4 = k.reshape(b, heads, s, d), qt.reshape(b, heads, d, s)
    for h in range(heads):
        kp[:, h * s:(h + 1) * s, h * d:(h + 1) * d] = k4[:, h]
        qtp[:, h * d:(h + 1) * d, h * s:(h + 1) * s] = qt4[:, h]
    return kp, qtp
