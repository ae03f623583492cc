"""Flash attention: the CUDA kernels' wrappers, their plain versions and the
differentiable :func:`flash_mha`.

Counterpart of ``aliasfree_diffusion_models_pytorch_tpu/ops/flash_attention.py``
(``attention_reference`` :65-75, ``_fwd_kernel`` :126-163, ``_flash_fwd``
:395-444, ``_bwd_kernel`` :166-254, ``_bwd_kernel_strips`` :269-338,
``flash_mha`` with its custom vjp :506-532). The forward runs in the TPU
kernel's "fold" mode:

    logits = q·kᵀ·scale (f32);  m = max_j logits;  p = exp(logits − m);
    Σ = Σ_j p;  out = (p cast to the input dtype)·v, accumulated in f32, / Σ

or its "stats" mode, which also returns m and Σ as (B·H, 1, S) f32 arrays.
The backward recomputes p from the saved m and never holds an S×S array in
device memory:

    P = p cast to the input dtype (unnormalised);  δ = rowsum(g ⊙ out) (f32);
    dV = Pᵀ·(g/Σ);  dP = g·vᵀ;  dS = P ⊙ ((dP − δ)/Σ) cast to the input dtype;
    dQ = dS·k·scale;  dK = dSᵀ·q·scale     (all products accumulate in f32)

* :func:`attention_reference` and :func:`attention_backward_reference` are
  the plain PyTorch versions of those steps. The CPU takes them; on the card
  they are only the yardsticks the kernels are checked against.
* :func:`flash_attention_fwd` and :func:`flash_attention_bwd` are the
  wrappers: a CPU tensor takes the plain version, a CUDA tensor launches
  ``csrc/flash_fwd.cu`` / ``csrc/flash_bwd.cu`` or raises. bf16 runs the
  tensor-core kernels (``mma.sync``), f32 deterministic kernels on the FMA
  pipes (register micro-tiles, ``csrc/attn_f32.cuh``; one row a thread for
  the backward at small depths). Each wrapper's ``launches`` attribute counts
  its calls that reached the card.
* :func:`fwd_plan`, :func:`f32_plan` and :func:`bwd_scratch_shapes` are the
  launch plans the kernels are given: heads per block of the forward, the
  f32 kernels' tiles, blocks and shared memory, and the backward's scratch
  arrays, computed here so that the CPU tests reach them.
* :func:`flash_mha` ties them into a ``torch.autograd.Function``: stats-mode
  forward when a gradient is needed, fold-mode forward otherwise.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.kernels import F32, INT, PTR

__all__ = ["attention_reference", "attention_backward_reference", "flash_attention_fwd",
           "flash_attention_bwd", "flash_mha", "fwd_plan", "f32_plan", "bwd_scratch_shapes",
           "HEAD_DIMS"]

# The kernels' template instantiations, forward and backward alike: D = 128 is
# the 128-px UNet's 512-channel blocks (sa2, sa3 at base width 128).
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
# bf16 kernels: four warps a block, 16 rows a warp (csrc/flash_fwd.cu, csrc/flash_bwd.cu).
WARPS = 4
ROWS_PER_WARP = 16
BWD_KEY_BLOCK = WARPS * ROWS_PER_WARP  # keys per block of the backward
ALIGN = 16  # bytes: cp.async copies 16-byte rows

# The C entry points (csrc/flash_fwd.cu, csrc/flash_bwd.cu), each argument before the stream.
# flash_fwd: q, k, v, out, m, l; bh, s, d, scale, is_bf16, heads_per_block, sms.
_FWD = kernels.Entry("flash_fwd", [PTR] * 6 + [INT] * 3 + [F32, INT, INT, INT])
# flash_bwd: q, k, v, out, g, m, l, dq, dk, dv, consts, dq_acc, g_scaled; bh, s, d, scale, is_bf16.
_BWD = kernels.Entry("flash_bwd", [PTR] * 13 + [INT] * 3 + [F32, INT])


def _default_scale(q: torch.Tensor, scale) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def attention_reference(q, k, v, scale=None, with_stats=False):
    """softmax(q·kᵀ·scale)·v per (batch, head), (B, H, S, D) layout, in the
    kernel's steps: f32 logits and softmax, p cast to the input dtype before
    the PV product, the division by Σ after it.

    With ``with_stats`` returns ``(out, m, Σ)``, m and Σ as (B·H, 1, S) f32.
    """
    b, h, s, _ = q.shape
    scale = _default_scale(q, scale)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    ssum = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p.to(q.dtype).float(), v.float()) / ssum).to(q.dtype)
    if not with_stats:
        return out
    return out, m.reshape(b * h, 1, s), ssum.reshape(b * h, 1, s)


def attention_backward_reference(q, k, v, out, m, ssum, g, scale=None):
    """(dq, dk, dv) of ``out = softmax(q·kᵀ·scale)·v`` for the cotangent ``g``,
    (B, H, S, D) layout, in the backward kernel's steps (see the module
    docstring): explicit formulas and rounding points, not autograd.

    ``m`` and ``ssum`` are the forward's stats as (B·H, 1, S) f32. With both
    ``None`` they are recomputed here from the logits (local max and sum),
    and the same steps follow.
    """
    b, h, s, _ = q.shape
    dt = q.dtype
    scale = _default_scale(q, scale)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if m is None:
        m = logits.amax(dim=-1, keepdim=True)
        ssum = torch.exp(logits - m).sum(dim=-1, keepdim=True)
    else:
        m, ssum = m.reshape(b, h, s, 1), ssum.reshape(b, h, s, 1)
    inv = 1.0 / ssum
    p = torch.exp(logits - m).to(dt).float()  # unnormalised, in the input dtype
    dv = torch.matmul(p.transpose(-1, -2), gf * inv)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    ds = (p * ((dp - delta) * inv)).to(dt).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """Launch plan of the bf16 forward kernel (``csrc/flash_fwd.cu``)."""

    heads_per_block: int  # (b, h) pairs one block takes
    warps_per_head: int   # warps of 16 query rows on each head
    keys_per_tile: int    # keys of each head per shared-memory tile of 64 rows
    q_tiles: int          # blocks along the queries of one group of heads
    blocks: int


def fwd_plan(bh: int, s: int, d: int) -> FwdPlan:
    """Launch plan of the bf16 forward for ``bh`` heads of ``s`` queries of
    depth ``d``.

    A block has four warps of 16 query rows. At S <= 16 one warp covers a
    head, so a block takes four heads; at S <= 32 two warps a head and two
    heads; beyond, one head and 64 query rows a block. The 64 rows of a K/V
    tile are shared out among the block's heads, so no warp idles on rows
    past S where S is small. At D = 128 a block always takes one head: the
    kernel has no several-head instantiation there (they spill registers).
    """
    if bh < 1 or s < 1:
        raise ValueError(f"empty attention input: bh={bh}, s={s}")
    heads = 4 if s <= ROWS_PER_WARP else 2 if s <= 2 * ROWS_PER_WARP else 1
    if d == 128:
        heads = 1
    rows = WARPS * ROWS_PER_WARP
    q_tiles = 1 if heads > 1 else -(-s // rows)
    return FwdPlan(heads_per_block=heads, warps_per_head=WARPS // heads,
                   keys_per_tile=rows // heads, q_tiles=q_tiles,
                   blocks=-(-bh // heads) * q_tiles)


# The f32 kernels. Register micro-tiles (csrc/attn_f32.cuh): by kernel and
# head depth, rows a thread and columns a thread, (RI, CJ). A block of 128
# threads owns 16·RI rows and streams tiles of 8·CJ rows of the other operand
# (the forward and the dQ pass own queries and stream keys; the dK/dV pass
# owns keys and streams queries). The same table is written out in
# csrc/flash_fwd.cu (FwdTile) and csrc/flash_bwd.cu (DqTile, DkvTile). The
# backward at D <= 16, and at D = 32 where S <= 32, takes one row a thread
# instead (F32_ROWS).
F32_KERNELS = ("fwd", "bwd_dq", "bwd_dkv")
F32_TILES = {
    "fwd": {8: (4, 8), 16: (4, 8), 32: (4, 8), 64: (4, 8), 128: (4, 4)},
    "bwd_dq": {32: (4, 8), 64: (4, 8), 128: (2, 4)},
    "bwd_dkv": {32: (4, 8), 64: (2, 8), 128: (2, 4)},
}
# The forward at D <= 16 on a small grid: at most F32_SMALL_GRID_PER_SM blocks
# of 64 queries an SM of the card take these tiles (csrc/flash_fwd.cu:
# FwdSmallTile, kSmallGridPerSm).
F32_FWD_SMALL_TILES = {8: (4, 4), 16: (2, 8)}
F32_SMALL_GRID_PER_SM = 4
F32_THREADS = 128
F32_STAGED_FROM = 32  # depths from which the second product's weights go through shared memory
# One row a thread (csrc/flash_bwd.cu: kRowThreads, kRowTile): the backward
# at these depths, and at D = 32 where S fits one tile; 64 rows a block,
# tiles of 32 streamed rows.
F32_ROWS = {"depths": (8, 16), "short_depth": 32, "threads": 64, "tile": 32}
SMEM_DEFAULT = 48 * 1024  # bytes a block takes without cudaFuncSetAttribute
SMEM_MAX = 227 * 1024     # bytes a block can take on Hopper


@dataclasses.dataclass(frozen=True)
class F32Plan:
    """Launch plan of one f32 kernel (``csrc/attn_f32.cuh`` and its users)."""

    kernel: str           # "fwd", "bwd_dq" or "bwd_dkv"
    layout: str           # "lane_sums", "staged" (micro-tiles) or "rows" (one row a thread)
    threads: int          # a block
    rows_per_thread: int  # micro-tiles: a thread holds rows rg + 16·i, i < RI
    cols_per_thread: int  # micro-tiles: streamed rows cg + 8·j, j < CJ; rows: the whole tile
    rows: int             # rows a block owns, shared among `heads`
    cols: int             # streamed rows a tile, shared among `heads`
    heads: int            # (b, h) pairs a block (the forward at S <= 32)
    row_tiles: int        # blocks along the rows of one group of heads
    blocks: int
    smem_bytes: int       # shared memory a block
    raised_smem: bool     # above 48 KB: the launch raises the kernel's limit first


def f32_plan(kernel: str, bh: int, s: int, d: int, sms: int) -> F32Plan:
    """Launch plan of the f32 ``kernel`` for ``bh`` heads of ``s`` rows of
    depth ``d`` on a card of ``sms`` SMs: the tile of :data:`F32_TILES` (or
    :data:`F32_ROWS`), the blocks of the grid and the shared memory of one
    block, as the launch in ``csrc/`` computes them.

    The forward takes four (b, h) pairs a block where S fits a quarter of the
    block's rows, two where it fits half (at D = 128 one), as the bf16 plan
    does for its 64 rows, so that its rows are real queries; the tile of keys
    is then shared out among the heads too, and a pair of another head is
    masked. At D <= 16, where the grid of 64-query blocks is at most
    :data:`F32_SMALL_GRID_PER_SM` blocks an SM, it takes
    :data:`F32_FWD_SMALL_TILES`. The backward takes one head a block.

    Shared memory (f32, micro-tile rows padded to D + 4 floats): the
    forward's query tile, two K and two V tiles and the staged P; the dQ
    pass's Q and g tiles, two K and two V tiles and the staged dS; the dK/dV
    pass's K and V tiles, two Q and two g tiles, two tiles of the query
    constants (−m·log2e, 1/Σ, −δ/Σ) and the staged P/Σ and dS. One row a
    thread (the backward at D <= 16, and at D = 32 where S <= 32): two tiles
    of each streamed operand (and of the constants).
    """
    if kernel not in F32_KERNELS:
        raise ValueError(f"f32 kernel {kernel!r} not in {F32_KERNELS}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if bh < 1 or s < 1:
        raise ValueError(f"empty attention input: bh={bh}, s={s}")
    if kernel != "fwd" and (d in F32_ROWS["depths"]
                            or d == F32_ROWS["short_depth"] and s <= F32_ROWS["tile"]):
        rows, cols = F32_ROWS["threads"], F32_ROWS["tile"]
        floats = 2 * 2 * cols * d + (2 * 4 * cols if kernel == "bwd_dkv" else 0)
        return F32Plan(kernel=kernel, layout="rows", threads=rows, rows_per_thread=1,
                       cols_per_thread=cols, rows=rows, cols=cols, heads=1,
                       row_tiles=-(-s // rows), blocks=bh * -(-s // rows), smem_bytes=4 * floats,
                       raised_smem=False)
    if (kernel == "fwd" and d in F32_FWD_SMALL_TILES
            and bh * -(-s // 64) <= F32_SMALL_GRID_PER_SM * sms):
        ri, cj = F32_FWD_SMALL_TILES[d]
    else:
        ri, cj = F32_TILES[kernel][d]
    rows, cols = 16 * ri, 8 * cj
    staged = d >= F32_STAGED_FROM
    heads = 1
    if kernel == "fwd" and d != 128:
        heads = 4 if 4 * s <= rows else 2 if 2 * s <= rows else 1
    row_tiles = 1 if heads > 1 else -(-s // rows)
    stride, wstride = d + 4, rows + 4
    if kernel == "fwd":
        floats = rows * stride + 4 * cols * stride + (cols * wstride if staged else 0)
    elif kernel == "bwd_dq":
        floats = 2 * rows * stride + 4 * cols * stride + cols * wstride
    else:
        floats = 2 * rows * stride + 4 * cols * stride + 2 * 4 * cols + 2 * cols * wstride
    smem = 4 * floats
    return F32Plan(kernel=kernel, layout="staged" if staged else "lane_sums",
                   threads=F32_THREADS, rows_per_thread=ri, cols_per_thread=cj, rows=rows,
                   cols=cols, heads=heads, row_tiles=row_tiles,
                   blocks=-(-bh // heads) * row_tiles, smem_bytes=smem,
                   raised_smem=smem > SMEM_DEFAULT)


def bwd_scratch_shapes(bh: int, s: int, d: int, dtype: torch.dtype) -> dict:
    """Scratch arrays of one backward launch, name -> (shape, dtype), in the
    order ``afdm_flash_bwd`` takes them. The wrapper allocates them; the
    kernels allocate nothing.

    f32: per query the float4 (−m·log2e, 1/Σ, −δ/Σ, 0), written by the dQ
    pass and read by the dK/dV pass. bf16: per query the float4 (−m·log2e, 1/Σ, −δ/Σ,
    0), the f32 dQ accumulator that the main kernel adds into with atomics
    (zeroed by the pre-pass), and g/Σ rounded to bf16 (dV's operand).
    """
    if dtype == torch.bfloat16:
        return {"consts": ((bh, s, 4), torch.float32), "dq_acc": ((bh, s, d), torch.float32),
                "g_scaled": ((bh, s, d), torch.bfloat16)}
    return {"consts": ((bh, s, 4), torch.float32)}


def _check_aligned(**tensors) -> None:
    """Every kernel copies rows into shared memory with 16-byte cp.async."""
    for name, t in tensors.items():
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} must be {ALIGN}-byte aligned for the kernels "
                             "(a view into the middle of a tensor may not be)")


def _check_bf16_launch(scale: float, **tensors) -> None:
    """What the bf16 kernels need beyond shapes: 16-byte-aligned rows for
    cp.async and a positive scale (the row max is taken before scaling)."""
    if not scale > 0:
        raise ValueError(f"the bf16 kernels take a positive scale, got {scale}")
    _check_aligned(**tensors)


def _check(q, k, v) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, S, D) tensors, got shape {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must match q in shape, dtype and device: "
                f"{tuple(t.shape)} {t.dtype} {t.device} vs "
                f"{tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if q.shape[0] * q.shape[1] < 1 or q.shape[2] < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention_fwd(q, k, v, scale=None, with_stats=False):
    """Attention forward on (B, H, S, D) q, k, v (f32 or bf16).

    CPU tensors take :func:`attention_reference`. CUDA tensors launch the
    hand-written kernel on the current stream (bf16: the tensor-core kernel
    with the launch plan of :func:`fwd_plan`; f32: the FMA-pipe kernel with
    that of :func:`f32_plan`); anything it cannot take raises. Returns
    ``out``, or ``(out, m, Σ)`` with ``with_stats``.
    """
    if not kernels.on_card(q, "flash_attention_fwd"):
        return attention_reference(q, k, v, scale, with_stats)
    _check(q, k, v)
    b, h, s, d = q.shape
    scale = _default_scale(q, scale)
    bf16 = q.dtype == torch.bfloat16
    sms = kernels.sm_count(q.device.index)
    if bf16:
        _check_bf16_launch(scale, q=q, k=k, v=v)
        heads = fwd_plan(b * h, s, d).heads_per_block
    else:
        _check_aligned(q=q, k=k, v=v)
        heads = f32_plan("fwd", b * h, s, d, sms).heads
    out = torch.empty_like(q)
    m = ssum = None
    if with_stats:
        m = torch.empty((b * h, 1, s), dtype=torch.float32, device=q.device)
        ssum = torch.empty_like(m)
    _FWD(q.device, q, k, v, out, m, ssum, b * h, s, d, scale, int(bf16), heads, sms)
    flash_attention_fwd.launches += 1
    return (out, m, ssum) if with_stats else out


kernels.count_launches(flash_attention_fwd)


def _check_bwd(q, k, v, out, m, ssum, g) -> None:
    _check(q, k, v)
    for name, t in (("out", out), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must match q in shape, dtype and device: "
                f"{tuple(t.shape)} {t.dtype} {t.device} vs "
                f"{tuple(q.shape)} {q.dtype} {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    stats_shape = (q.shape[0] * q.shape[1], 1, q.shape[2])
    for name, t in (("m", m), ("ssum", ssum)):
        if (tuple(t.shape) != stats_shape or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 {stats_shape} tensor on {q.device}, "
                f"got {tuple(t.shape)} {t.dtype} {t.device}")


def flash_attention_bwd(q, k, v, out, m, ssum, g, scale=None):
    """Attention backward: ``(dq, dk, dv)`` for the cotangent ``g`` of ``out``.

    ``m`` and ``ssum`` are the stats of the stats-mode forward, or both
    ``None``: then they are recomputed first (on the card by one stats-mode
    launch of the forward kernel) and the same backward follows. CPU tensors
    take :func:`attention_backward_reference`. CUDA tensors launch the
    hand-written kernel on the current stream; anything it cannot take
    raises. A non-contiguous ``g`` is made contiguous here.

    Without stats the steps stay those of the stats mode: P is rounded to the
    input dtype unnormalised and 1/Σ applied afterwards. The TPU kernel's
    no-stats branch (``_bwd_kernel`` :201-207) rounds the normalised P. In f32
    the two agree to summation order; in bf16 single weights round one bf16
    ulp apart, so the gradients agree to a few ulps of their largest entry
    (``tests/test_torch_flash_backward.py`` holds them to that).

    ``launches`` counts calls that reached the card. A bf16 call runs three
    kernels on the tensor cores (a pre-pass for δ, g/Σ and the zeroed dQ
    scratch; one pass over all (query, key) pairs with one exp each; dQ's
    cast), an f32 call two passes on the FMA pipes, each recomputing P
    (dQ with each query's m, 1/Σ and δ, then dK/dV; :func:`f32_plan`). A call
    without stats also counts once in ``flash_attention_fwd.launches``.

    bf16 dQ is summed with atomics in an order that changes from run to run,
    so it varies in its last bits between runs; bf16 dK, dV and every f32
    gradient are deterministic.
    """
    if (m is None) != (ssum is None):
        raise ValueError("m and ssum come together: pass both or neither")
    if not kernels.on_card(q, "flash_attention_bwd"):
        return attention_backward_reference(q, k, v, out, m, ssum, g, scale)
    g = g.contiguous()
    scale = _default_scale(q, scale)
    if m is None:
        _, m, ssum = flash_attention_fwd(q, k, v, scale, with_stats=True)
    _check_bwd(q, k, v, out, m, ssum, g)
    b, h, s, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_bf16_launch(scale, q=q, k=k, v=v, out=out, g=g)
    else:
        _check_aligned(q=q, k=k, v=v, out=out, g=g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    scratch = [torch.empty(shape, dtype=dt, device=q.device)
               for shape, dt in bwd_scratch_shapes(b * h, s, d, q.dtype).values()]
    scratch += [None] * (3 - len(scratch))
    _BWD(q.device, q, k, v, out, g, m, ssum, dq, dk, dv, *scratch, b * h, s, d, scale, int(bf16))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


kernels.count_launches(flash_attention_bwd)


class _FlashMHA(torch.autograd.Function):
    """Forward saves (q, k, v, out, m, Σ); backward consumes them."""

    @staticmethod
    def forward(ctx, q, k, v, scale, stats):
        if stats:
            out, m, ssum = flash_attention_fwd(q, k, v, scale, with_stats=True)
            ctx.save_for_backward(q, k, v, out, m, ssum)
        else:
            out = flash_attention_fwd(q, k, v, scale)
            ctx.save_for_backward(q, k, v, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, *stats = ctx.saved_tensors
        m, ssum = stats if stats else (None, None)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, m, ssum, g, ctx.scale)
        return dq, dk, dv, None, None


def flash_mha(q, k, v, scale=None, stats=True):
    """softmax(q·kᵀ·scale)·v per (batch, head) on (B, H, S, D) tensors,
    differentiable through the hand-written backward.

    When a gradient is needed the forward runs in stats mode and saves
    (q, k, v, out, m, Σ) for the backward; ``stats=False`` saves no stats and
    lets the backward recompute them. Without grad (``torch.no_grad``,
    ``torch.inference_mode``, or inputs that need none) it is the fold-mode
    forward alone.
    """
    scale = _default_scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashMHA.apply(q, k, v, scale, stats)
    return flash_attention_fwd(q, k, v, scale)
