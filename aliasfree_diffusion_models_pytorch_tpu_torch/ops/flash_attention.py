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
  tensor-core kernels (``mma.sync``), f32 the CUDA-core kernels of the first
  port. Each wrapper's ``launches`` attribute counts its calls that reached
  the card.
* :func:`fwd_plan` and :func:`bwd_scratch_shapes` are the launch plan the
  bf16 kernels are given: heads per block of the forward and the backward's
  scratch arrays, computed here so that the CPU tests reach them.
* :func:`flash_mha` ties them into a ``torch.autograd.Function``: stats-mode
  forward when a gradient is needed, fold-mode forward otherwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

__all__ = ["attention_reference", "attention_backward_reference", "flash_attention_fwd",
           "flash_attention_bwd", "flash_mha", "fwd_plan", "bwd_scratch_shapes", "HEAD_DIMS"]

HEAD_DIMS = (8, 16, 32, 64)  # the kernel's template instantiations
_DTYPES = (torch.float32, torch.bfloat16)
# bf16 kernels: four warps a block, 16 rows a warp (csrc/flash_fwd.cu, csrc/flash_bwd.cu).
WARPS = 4
ROWS_PER_WARP = 16
BWD_KEY_BLOCK = WARPS * ROWS_PER_WARP  # keys per block of the backward
ALIGN = 16  # bytes: cp.async copies 16-byte rows


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


def fwd_plan(bh: int, s: int) -> FwdPlan:
    """Launch plan of the bf16 forward for ``bh`` heads of ``s`` queries.

    A block has four warps of 16 query rows. At S <= 16 one warp covers a
    head, so a block takes four heads; at S <= 32 two warps a head and two
    heads; beyond, one head and 64 query rows a block. The 64 rows of a K/V
    tile are shared out among the block's heads, so no warp idles on rows
    past S where S is small.
    """
    if bh < 1 or s < 1:
        raise ValueError(f"empty attention input: bh={bh}, s={s}")
    heads = 4 if s <= ROWS_PER_WARP else 2 if s <= 2 * ROWS_PER_WARP else 1
    rows = WARPS * ROWS_PER_WARP
    q_tiles = 1 if heads > 1 else -(-s // rows)
    return FwdPlan(heads_per_block=heads, warps_per_head=WARPS // heads,
                   keys_per_tile=rows // heads, q_tiles=q_tiles,
                   blocks=-(-bh // heads) * q_tiles)


def bwd_scratch_shapes(bh: int, s: int, d: int, dtype: torch.dtype) -> dict:
    """Scratch arrays of one backward launch, name -> (shape, dtype), in the
    order ``afdm_flash_bwd`` takes them. The wrapper allocates them; the
    kernels allocate nothing.

    f32: δ per query. bf16: per query the float4 (−m·log2e, 1/Σ, −δ/Σ, 0),
    the f32 dQ accumulator that the main kernel adds into with atomics
    (zeroed by the pre-pass), and g/Σ rounded to bf16 (dV's operand).
    """
    if dtype == torch.bfloat16:
        return {"consts": ((bh, s, 4), torch.float32), "dq_acc": ((bh, s, d), torch.float32),
                "g_scaled": ((bh, s, d), torch.bfloat16)}
    return {"consts": ((bh, s), torch.float32)}


def _check_bf16_launch(scale: float, **tensors) -> None:
    """What the bf16 kernels need beyond shapes: 16-byte-aligned rows for
    cp.async and a positive scale (the row max is taken before scaling)."""
    if not scale > 0:
        raise ValueError(f"the bf16 kernels take a positive scale, got {scale}")
    for name, t in tensors.items():
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} must be {ALIGN}-byte aligned for the bf16 kernels "
                             "(a view into the middle of a tensor may not be)")


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """The kernel's library with its C signatures declared."""
    lib = kernels.load(name)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "flash_fwd":
        lib.afdm_flash_fwd.argtypes = [vp] * 6 + [ci, ci, ci, ctypes.c_float, ci, ci, vp]
        lib.afdm_flash_fwd.restype = ci
    else:
        lib.afdm_flash_bwd.argtypes = [vp] * 13 + [ci, ci, ci, ctypes.c_float, ci, vp]
        lib.afdm_flash_bwd.restype = ci
    lib.afdm_cuda_error_string.argtypes = [ci]
    lib.afdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    with the launch plan of :func:`fwd_plan`; f32: the CUDA-core kernel);
    anything it cannot take raises. Returns ``out``, or ``(out, m, Σ)`` with
    ``with_stats``.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, with_stats)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cpu or cuda, got {q.device}")
    _check(q, k, v)
    b, h, s, d = q.shape
    scale = _default_scale(q, scale)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_bf16_launch(scale, q=q, k=k, v=v)
    out = torch.empty_like(q)
    m = ssum = None
    if with_stats:
        m = torch.empty((b * h, 1, s), dtype=torch.float32, device=q.device)
        ssum = torch.empty_like(m)
    lib = _lib("flash_fwd")
    with torch.cuda.device(q.device):  # a no-op when q is on the current device
        err = lib.afdm_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            m.data_ptr() if with_stats else None,
            ssum.data_ptr() if with_stats else None,
            b * h, s, d, scale, int(bf16), fwd_plan(b * h, s).heads_per_block if bf16 else 1,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: {lib.afdm_cuda_error_string(err).decode()}")
    flash_attention_fwd.launches += 1
    return (out, m, ssum) if with_stats else out


flash_attention_fwd.launches = 0


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
    cast), an f32 call the two CUDA-core kernels of the first port (dQ with
    δ, then dK/dV). A call without stats also counts once in
    ``flash_attention_fwd.launches``.

    bf16 dQ is summed with atomics in an order that changes from run to run,
    so it varies in its last bits between runs; bf16 dK, dV and every f32
    gradient are deterministic.
    """
    if (m is None) != (ssum is None):
        raise ValueError("m and ssum come together: pass both or neither")
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, out, m, ssum, g, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, got {q.device}")
    g = g.contiguous()
    scale = _default_scale(q, scale)
    if m is None:
        _, m, ssum = flash_attention_fwd(q, k, v, scale, with_stats=True)
    _check_bwd(q, k, v, out, m, ssum, g)
    b, h, s, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_bf16_launch(scale, q=q, k=k, v=v, out=out, g=g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    scratch = [torch.empty(shape, dtype=dt, device=q.device)
               for shape, dt in bwd_scratch_shapes(b * h, s, d, q.dtype).values()]
    ptrs = [t.data_ptr() for t in scratch] + [None] * (3 - len(scratch))
    lib = _lib("flash_bwd")
    with torch.cuda.device(q.device):
        err = lib.afdm_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            m.data_ptr(), ssum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *ptrs, b * h, s, d, scale, int(bf16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_bwd launch failed: {lib.afdm_cuda_error_string(err).decode()}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


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
