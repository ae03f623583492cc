"""The two probe kernels' wrappers and their plain versions.

Counterparts of the Pallas kernels of the JAX package's two micro-probes:

* :func:`exp_chain` is ``benchmarks/exp_micro.py``'s ``kern`` (:96-100): per
  element, ``chain`` times, ``acc = op(acc) − 1`` for one of the probe's ten
  ops (:57-89, :125-136), plus ``exp_fast`` (``__expf``, the exponential of
  the port's f32 attention kernels; the bf16 ones take ``exp2``). It answers
  what an exponential costs on the card beside a polynomial on the FMA units.
* :func:`qk_rowsum` is ``benchmarks/attn_headpack.py``'s ``qk_rowsum_kernel``
  (:84-92): ``out[n, 0, q] = Σ_k Σ_d K[n, k, d]·Qᵀ[n, d, q]`` with every
  logit formed on the tensor cores (``wgmma``, K and Qᵀ tiles brought by
  TMA) and only the sums over the keys written. It answers what the matrix unit charges
  for QKᵀ at head dim 8 against 32 (block-diagonal packing) and 128.
  :func:`qk_plan` is its launch plan.

A CPU tensor takes the plain version (:func:`exp_chain_plain`,
:func:`qk_rowsum_plain`); a CUDA tensor launches ``csrc/exp_chain.cu`` /
``csrc/qk_rowsum.cu`` on the current stream or raises. Each wrapper's
``launches`` attribute counts its kernel launches.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.kernels import I64, INT, PTR

__all__ = ["OPS", "exp_chain", "exp_chain_plain", "qk_rowsum", "qk_rowsum_plain", "qk_plan",
           "QkPlan", "block_diagonal_pack", "QK_HEAD_DIMS", "QK_SEQ_MULTIPLE"]

# The op's index here is the kernel's `op` argument (csrc/exp_chain.cu: enum Op).
OPS = ("copy", "mul2", "poly4", "exp", "exp2", "fastexp2", "tanh", "erf", "rsqrt1p",
       "logistic", "exp_fast")

# The C entry points, each argument before the stream. exp_chain: x, out; n; op, chain,
# subtract, sms. qk_rowsum: k, qt, out; n, s, d and the plan's keys_per_tile, acc_keys,
# queries_per_block, stages, swizzle, smem_bytes, grid.
_EXP_CHAIN = kernels.Entry("exp_chain", [PTR, PTR, I64, INT, INT, INT, INT])
_QK_ROWSUM = kernels.Entry("qk_rowsum", [PTR] * 3 + [INT] * 10)

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
    if not kernels.on_card(x, "exp_chain"):
        return exp_chain_plain(x, op, chain, subtract)
    if x.dtype != torch.float32:
        raise TypeError(f"exp_chain takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (a view into the middle of a tensor is not)")
    out = torch.empty_like(x)
    _EXP_CHAIN(x.device, x, out, x.numel(), OPS.index(op), chain, int(bool(subtract)),
               kernels.sm_count(x.device.index))
    exp_chain.launches += 1
    return out


kernels.count_launches(exp_chain)

QK_HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernel's template instantiations
QK_SEQ_MULTIPLE = 128  # a consumer warpgroup's queries: s must be a multiple
# The kernel's tile by depth (csrc/qk_rowsum.cu: Tile): keys a wgmma (the
# accumulator's columns), ring stages, TMA swizzle width of a key tile in bytes
# (0: none), blocks an SM.
QK_TILES = {8: (64, 8, 0, 2), 16: (64, 8, 32, 2), 32: (128, 8, 64, 1), 64: (128, 6, 128, 1),
            128: (128, 4, 128, 1)}
QK_KEYS = 128      # keys a TMA tile and ring stage
QK_WARPGROUPS = 2  # consumer warpgroups a block, and one producer warpgroup
QK_ROW_TILES = 2   # m64 query tiles a consumer warpgroup
QK_ALIGN = 1024    # every stage starts on this boundary (a swizzled tile's)
# Registers a thread starts with, by blocks an SM (csrc/qk_rowsum.cu: Registers):
# the setmaxnreg hand-over adds up only at these counts, and the launch refuses others.
QK_LAUNCH_REGS = {1: 168, 2: 80}
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


@dataclasses.dataclass(frozen=True)
class QkPlan:
    """Launch plan of ``csrc/qk_rowsum.cu`` for ``n`` groups of ``s`` keys
    and queries of depth ``d``."""

    keys_per_tile: int      # keys a TMA tile and a ring stage
    acc_keys: int           # N of wgmma m64nNk16: a tile is keys_per_tile / N products
    queries_per_block: int  # a work item: QK_WARPGROUPS x QK_ROW_TILES x 64 queries
    stages: int             # ring stages in shared memory
    swizzle: int            # a key tile's TMA swizzle (and wgmma layout) width in bytes; 0: none
    smem_bytes: int         # dynamic shared memory: alignment slack, the ring (each stage a
                            # key tile rounded up to QK_ALIGN), the queries' tile (d rows of
                            # 128 bytes an m64 tile), the mbarriers and d = 8's zeros
    items: int              # (group, block of queries_per_block queries)
    grid: int               # persistent blocks: as many as the SMs hold at once, at most items
    depth: int              # the MMA's depth: d, or 16 at d = 8 (zero-padded)
    issued_flops: int       # tensor-core FLOPs of the plan's wgmmas: 2 n s s depth


def qk_plan(n: int, s: int, d: int, sms: int) -> QkPlan:
    """The plan the kernel takes for k (n, s, d) and qt (n, d, s) on a card
    of ``sms`` SMs, as ``csrc/qk_rowsum.cu`` computes and checks it. Raises
    for a shape the kernel does not take."""
    if d not in QK_HEAD_DIMS:
        raise ValueError(f"depth {d} not in {QK_HEAD_DIMS}")
    if s < QK_SEQ_MULTIPLE or s % QK_SEQ_MULTIPLE:
        raise ValueError(f"s must be a multiple of {QK_SEQ_MULTIPLE}, got {s}")
    if n < 1 or n * s > 2**31 - 1:
        raise ValueError(f"n·s = {n * s} rows of k: the tensor map's int32 coordinates take "
                         "1 .. 2^31 - 1")
    acc_keys, stages, swizzle, per_sm = QK_TILES[d]
    keys = QK_KEYS
    stage_bytes = -(-keys * d * 2 // QK_ALIGN) * QK_ALIGN
    queries = QK_WARPGROUPS * QK_ROW_TILES * 64
    barriers = 2 * stages + 2
    items = n * -(-s // queries)
    depth = max(d, 16)
    return QkPlan(keys_per_tile=keys, acc_keys=acc_keys, queries_per_block=queries,
                  stages=stages, swizzle=swizzle,
                  smem_bytes=(QK_ALIGN + stages * stage_bytes
                              + QK_WARPGROUPS * QK_ROW_TILES * d * 128 + 8 * barriers
                              + 16 * QK_ROW_TILES),
                  items=items, grid=min(items, sms * per_sm),
                  depth=depth,
                  issued_flops=2 * n * s * s * depth)


def qk_rowsum(k: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """Row sums over the keys of the logits ``k·qt``: k (n, s, d) and qt
    (n, d, s) in bf16 → (n, 1, s) f32.

    CPU tensors take :func:`qk_rowsum_plain`. CUDA tensors launch the
    hand-written kernel on the current stream, which forms every logit on the
    tensor cores (``wgmma``, K and Qᵀ tiles brought by TMA) and writes only the
    sums, as :func:`qk_plan` lays it out. Anything the kernel cannot take
    raises.
    """
    _check_qk(k, qt)
    if not kernels.on_card(k, "qk_rowsum"):
        return qk_rowsum_plain(k, qt)
    n, s, d = k.shape
    if k.dtype != torch.bfloat16 or qt.dtype != torch.bfloat16:
        raise TypeError(f"qk_rowsum takes bfloat16, got {k.dtype} and {qt.dtype}")
    plan = qk_plan(n, s, d, kernels.sm_count(k.device.index))
    if not (k.is_contiguous() and qt.is_contiguous()):
        raise ValueError("k and qt must be contiguous")
    if k.data_ptr() % 16 or qt.data_ptr() % 16:  # TMA's base addresses
        raise ValueError("k and qt must be 16-byte aligned (a view into the middle of a tensor "
                         "is not)")
    out = torch.empty((n, 1, s), dtype=torch.float32, device=k.device)
    _QK_ROWSUM(k.device, k, qt, out, n, s, d, plan.keys_per_tile, plan.acc_keys,
               plan.queries_per_block, plan.stages, plan.swizzle, plan.smem_bytes, plan.grid)
    qk_rowsum.launches += 1
    return out


kernels.count_launches(qk_rowsum)


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
