"""LayerNorm over the channels of the attention block's tokens, and its CUDA
kernel pair.

``SelfAttention`` (``models/blocks.py``) normalises its (n, S, C) tokens twice
a block, as the JAX package's ``nn.LayerNorm`` does: ``ln`` on the block's NCHW
map read in place as tokens (the view ``x.flatten(2).transpose(1, 2)``, in
which a channel's S tokens lie together: "channel-major") and ``ff_ln`` on the
residual sum, laid out in row order (a token's C channels together). Both are
:class:`TokenLayerNorm`, an ``nn.LayerNorm`` with its parameters under the same
names, whose forward is :func:`layer_norm_tokens`:

* off the card (the CPU, the meta device), ``F.layer_norm``, exactly what
  ``nn.LayerNorm`` computes;
* on the card, the kernel pair of ``csrc/layer_norm.cu`` (:func:`layer_norm_fwd`,
  :func:`layer_norm_bwd`, tied by a ``torch.autograd.Function``), which takes
  either layout as it lies (picked from the input's strides), writes the
  normalised tokens in row order for the projection that follows, keeps each
  token's mean and 1/σ in f32 for the backward, writes dx in the input's
  layout, and sums the weight and bias gradients in a fixed order.

The kernels take every channel count the card's attention block is built
with (4 heads of 8 to 128 channels, ``ops/flash_attention.py:HEAD_DIMS``:
C = 32 to 512), and the wrappers raise on what they do not take.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.kernels import F32, I64, INT, PTR

__all__ = [
    "LN_MAX_CHANNELS",
    "LnPlan",
    "ln_plan",
    "tile_tokens",
    "token_layout",
    "layer_norm_fwd",
    "layer_norm_bwd",
    "layer_norm_tokens",
    "TokenLayerNorm",
]

# The kernel pair's geometry (csrc/layer_norm.cu): blocks of LN_WARPS warps, a
# warp owns a tile of consecutive tokens of about LN_TILE_BYTES (at least 16
# bytes a channel, at most LN_MAX_TW tokens), rows go through `lpr` lanes each
# holding `cpl` 16-byte words, and the instantiations take these `cpl`.
LN_WARPS = 8
LN_TILE_BYTES = 4096
LN_MAX_TW = 64
LN_MAX_CHANNELS = 512
LN_CPL = {torch.bfloat16: (1, 2), torch.float32: (1, 2, 4)}
# Blocks an SM holds at most (2048 threads), so the rows of partial weight and
# bias gradients a backward launch may write: this many for each SM.
LN_BLOCKS_PER_SM = 2048 // (32 * LN_WARPS)
# A call's tiles grow (halving their count) only while it keeps this many: a
# call with fewer tiles than the card has warps runs each warp's tile passes
# one after another (H100: the step's and the sampler's calls timed at each
# tile size, PERF.md §6).
LN_WAVE_TILES = 1536
# The backward's tiles hold at most this many tokens, and at least two 16-byte
# words along S where it writes dx channel-major (whole 32-byte sectors).
LN_MAX_TW_BWD = 32

# The C entry point (csrc/layer_norm.cu), each argument before the stream: x, dy, weight, bias,
# out, mean, rstd, partials; partial_blocks; dweight, dbias; rows, tokens; channels, lpr, cpl,
# tw, swz_stride, swz_mask, layout, bf16_io; eps; sms.
_LAYER_NORM = kernels.Entry("layer_norm", [PTR] * 8 + [INT] + [PTR] * 2 + [I64] * 2 + [INT] * 8
                            + [F32, INT])


@dataclasses.dataclass(frozen=True)
class LnPlan:
    """How the kernels lay a call of C channels in ``dtype`` out."""

    vec: int  # elements in a 16-byte word: 8 bf16, 4 f32
    chunks: int  # 16-byte words a row (C / vec)
    lpr: int  # lanes a row: the power of two at or above min(chunks, 32)
    cpl: int  # words a lane holds of a row: the fewest of LN_CPL that hold it
    tw: int  # tokens of a warp's tile, a multiple of vec
    # the tile's word permutation: row r's word j lies at j ^ ((r // vec)·swz_stride & swz_mask),
    # so that the lanes of a channel-major move (consecutive 16-byte words along S of a few
    # channels) meet in no bank of shared memory
    swz_stride: int
    swz_mask: int
    tile_bytes: int
    smem_fwd: int  # shared memory of a forward block
    smem_bwd: int  # of a backward block: the dy and x tiles and the rows' mean and 1/σ


def ln_plan(channels: int, dtype: torch.dtype, tw: int | None = None) -> LnPlan:
    """The plan of a call over ``channels`` channels: any multiple of 8 (bf16)
    or 4 (f32) up to :data:`LN_MAX_CHANNELS`; raises on anything else. ``tw``
    (tokens a warp's tile) defaults to the most that fit :data:`LN_TILE_BYTES`."""
    if dtype not in LN_CPL:
        raise TypeError(f"the LayerNorm kernels take float32 or bfloat16, got {dtype}")
    size = torch.tensor([], dtype=dtype).element_size()
    vec = 16 // size
    if not 0 < channels <= LN_MAX_CHANNELS or channels % vec:
        raise ValueError(f"the LayerNorm kernels take a multiple of {vec} channels up to "
                         f"{LN_MAX_CHANNELS} in {dtype}, got {channels}")
    if tw is None:
        tw = min(LN_MAX_TW, vec * max(1, LN_TILE_BYTES // 16 // channels))
    chunks = channels // vec
    lpr = 1 << (min(chunks, 32) - 1).bit_length()
    cpl = next(c for c in LN_CPL[dtype] if c * lpr >= chunks)
    tile_bytes = tw * channels * size
    # an instantiation takes tiles up to 4 KB, or 16 bytes a channel of its widest rows
    if tw % vec or not vec <= tw <= LN_MAX_TW or tile_bytes > max(LN_TILE_BYTES, 512 * cpl * vec):
        raise ValueError(f"a tile of {tw} tokens of {channels} channels in {dtype}: a multiple "
                         f"of {vec} up to {LN_MAX_TW}, at most {LN_TILE_BYTES} bytes")
    return LnPlan(vec=vec, chunks=chunks, lpr=lpr, cpl=cpl, tw=tw, swz_stride=max(1, 32 // tw),
                  swz_mask=(chunks & -chunks) - 1, tile_bytes=tile_bytes,
                  smem_fwd=LN_WARPS * tile_bytes, smem_bwd=LN_WARPS * (2 * tile_bytes + 8 * tw))


def tile_tokens(channels: int, dtype: torch.dtype, rows: int, backward: bool = False,
                channel_major: bool = False) -> int:
    """The tile a call of ``rows`` tokens takes: the largest of vec·2^k tokens
    (up to :func:`ln_plan`'s default, and :data:`LN_MAX_TW_BWD` backward) that
    leaves the call :data:`LN_WAVE_TILES` tiles, else the smallest; a
    channel-major backward takes at least two 16-byte words along S."""
    full = ln_plan(channels, dtype)
    cap = min(full.tw, LN_MAX_TW_BWD) if backward else full.tw
    tw = full.vec
    while tw * 2 <= cap and -(-rows // (tw * 2)) >= LN_WAVE_TILES:
        tw *= 2
    if backward and channel_major:
        tw = max(tw, min(2 * full.vec, cap))
    return tw


def token_layout(x: torch.Tensor) -> str | None:
    """How an (n, S, C) tensor's elements lie: ``"rows"`` (row order,
    contiguous), ``"channels"`` (the transposed view of a contiguous (n, C, S)
    map), else None."""
    if x.dim() != 3:
        raise ValueError(f"expected (n, S, C) tokens, got shape {tuple(x.shape)}")
    if x.is_contiguous():
        return "rows"
    if x.transpose(1, 2).is_contiguous():
        return "channels"
    return None


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself where its storage starts on a 16-byte boundary, else a copy
    that does (with t's strides)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x: torch.Tensor, weight: torch.Tensor, others: tuple[torch.Tensor, ...],
           fn: str) -> str:
    """x's layout, after checking what the kernels take of x and the parameters."""
    kernels.on_card(x, fn, cpu=False)
    layout = token_layout(x)
    if layout is None:
        raise ValueError(f"{fn}: x must be (n, S, C) in row order or the transposed view of a "
                         f"contiguous (n, C, S) map, got strides {x.stride()}")
    for t in (weight, *others):
        if t.device != x.device or t.dtype != x.dtype or t.shape != (x.shape[2],):
            raise ValueError(f"{fn}: weight and bias must be ({x.shape[2]},) {x.dtype} on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    return layout


def _launch(x, dy, weight, bias, out, mean, rstd, partials, dweight, dbias, layout, plan,
            eps) -> None:
    n, s, c = x.shape
    _LAYER_NORM(x.device, x, dy, weight, bias, out, mean, rstd, partials,
                0 if partials is None else partials.shape[0], dweight, dbias, n * s, s, c,
                plan.lpr, plan.cpl, plan.tw, plan.swz_stride, plan.swz_mask,
                int(layout == "channels"), int(x.dtype == torch.bfloat16), eps,
                kernels.sm_count(x.device.index))


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel on (n, S, C) CUDA tokens in row order or channel-major
    (f32 or bf16; weight and bias (C,) alike): (y, mean, rstd), y (n, S, C) in
    row order, mean and rstd (n·S,) f32. ``launches`` counts the calls that
    reached the card."""
    layout = _check(x, weight, (bias,), "layer_norm_fwd")
    n, s, c = x.shape
    plan = ln_plan(c, x.dtype, tw=tile_tokens(c, x.dtype, n * s))
    y = torch.empty((n, s, c), dtype=x.dtype, device=x.device)
    mean = torch.empty(n * s, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if n * s == 0:
        return y, mean, rstd
    _launch(_aligned(x), None, _aligned(weight), _aligned(bias), y, mean, rstd, None, None, None,
            layout, plan, eps)
    layer_norm_fwd.launches += 1
    return y, mean, rstd


kernels.count_launches(layer_norm_fwd)


def layer_norm_bwd(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dweight, dbias) for the cotangent ``dy`` of :func:`layer_norm_fwd`'s
    y, from its mean and rstd: the backward kernel and the launch that sums
    its partial weight and bias gradients, on a CUDA tensor (dx laid out as
    x). ``launches`` counts the calls that reached the card."""
    layout = _check(x, weight, (), "layer_norm_bwd")
    n, s, c = x.shape
    plan = ln_plan(c, x.dtype, tw=tile_tokens(c, x.dtype, n * s, True, layout == "channels"))
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} {dy.dtype} against "
                         f"{tuple(x.shape)} {x.dtype}")
    for t in (mean, rstd):
        if t.dtype != torch.float32 or t.shape != (n * s,) or t.device != x.device:
            raise ValueError(f"mean and rstd must be ({n * s},) float32 on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if layout == "channels":
        dx = torch.empty((n, c, s), dtype=x.dtype, device=x.device).transpose(1, 2)
    else:
        dx = torch.empty((n, s, c), dtype=x.dtype, device=x.device)
    dweight = torch.empty(c, dtype=x.dtype, device=x.device)
    dbias = torch.empty_like(dweight)
    if n * s == 0:
        return dx, dweight.zero_(), dbias.zero_()
    partials = torch.empty((kernels.sm_count(x.device.index) * LN_BLOCKS_PER_SM, 2 * c),
                           dtype=torch.float32, device=x.device)
    _launch(_aligned(x), _aligned(dy.contiguous()), _aligned(weight), None, dx,
            mean.contiguous(), rstd.contiguous(), partials, dweight, dbias, layout, plan, 0.0)
    layer_norm_bwd.launches += 1
    return dx, dweight, dbias


kernels.count_launches(layer_norm_bwd)


class _LayerNorm(torch.autograd.Function):
    """Forward saves x (in a layout the kernels take: made contiguous first
    if it is in neither), the weight, and each token's mean and rstd; backward
    is the backward kernel pair."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        if token_layout(x) is None:
            x = x.contiguous()
        y, mean, rstd = layer_norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dweight, dbias = layer_norm_bwd(x, dy, weight, mean, rstd)
        return dx, dweight, dbias, None


def layer_norm_tokens(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """LayerNorm over the last dimension of (n, S, C) tokens: on a CUDA tensor
    the kernel pair (through an autograd Function), which raises on what it
    does not take (:func:`ln_plan`); ``F.layer_norm`` on any other device
    (the CPU, and the meta device of shape spies)."""
    if x.device.type != "cuda":
        return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)
    return _LayerNorm.apply(x, weight, bias, eps)


class TokenLayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the channels of (n, S, C) tokens (weight and bias
    under their usual names), computed by :func:`layer_norm_tokens`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_tokens(x, self.weight, self.bias, self.eps)
