"""Alias-free resampling ops (plain PyTorch).

Port of ``aliasfree_diffusion_models_pytorch_tpu/ops/resample.py``. Layout is
NCHW here (PyTorch's convolution layout); the JAX package's functions take
NHWC. Each op is the same cross-correlation with the same padding as its JAX
counterpart:

* ``downsample2x``: SAME depthwise FIR and decimation as one strided conv;
* ``upsample2x``: zero-stuffing by ``factor`` then a SAME depthwise FIR. The
  JAX version folds the stuffing into ``lhs_dilation``; here the stuffed
  tensor is built with its padding in place and convolved unpadded.

Parity trap preserved: the reference's ``custom_upsample`` does **not**
apply the ``factor**2`` gain compensation of StyleGAN3, so ``gain`` defaults
to 1.0 (the trained weights compensate).

``taps`` may be a NumPy array (design-time constant) or a tensor; the modules
hold them as buffers already on the right device and dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "same_pad",
    "downsample2x",
    "upsample2x",
    "filtered_gelu",
    "gelu_exact",
    "maxpool2x",
    "upsample_bilinear_align_corners",
    "resize_matrix_1d",
]


def same_pad(k: int) -> tuple[int, int]:
    """(lo, hi) spatial padding reproducing torch ``F.conv2d(padding='same')``:
    ``(k-1)//2`` low, ``k//2`` high (the extra tap of an even kernel goes high)."""
    return ((k - 1) // 2, k // 2)


def _taps(taps, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(taps, dtype=x.dtype, device=x.device)


def _depthwise(x: torch.Tensor, taps: torch.Tensor, stride: int) -> torch.Tensor:
    """Unpadded depthwise cross-correlation with one shared (kh, kw) filter."""
    c = x.shape[1]
    w = taps[None, None].expand(c, 1, *taps.shape)
    return F.conv2d(x, w, stride=stride, groups=c)


def downsample2x(x: torch.Tensor, taps, factor: int = 2) -> torch.Tensor:
    """Alias-free downsample (NCHW): SAME depthwise low-pass FIR, then keep
    every ``factor``-th sample — one strided conv."""
    t = _taps(taps, x)
    (hlo, hhi), (wlo, whi) = same_pad(t.shape[0]), same_pad(t.shape[1])
    return _depthwise(F.pad(x, (wlo, whi, hlo, hhi)), t, factor)


def upsample2x(x: torch.Tensor, taps, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """Alias-free upsample (NCHW): zero-stuff by ``factor``, SAME depthwise FIR.

    ``gain=1.0`` keeps the reference's un-compensated energy.
    """
    t = _taps(taps, x)
    if gain != 1.0:
        t = t * float(gain)
    n, c, h, w = x.shape
    (hlo, hhi), (wlo, whi) = same_pad(t.shape[0]), same_pad(t.shape[1])
    stuffed = x.new_zeros(n, c, hlo + h * factor + hhi, wlo + w * factor + whi)
    stuffed[:, :, hlo:hlo + h * factor:factor, wlo:wlo + w * factor:factor] = x
    return _depthwise(stuffed, t, 1)


# Minimax polynomial for gelu(x) = x·(0.5 + x_c·R(x_c²)), x_c = clip(x, ±XC):
# the JAX package's degree-15 bf16 fit (max |gelu err| 3.7e-4, an order below
# bf16 rounding), copied coefficient for coefficient.
_GELU_POLY_15 = (
    0.39847720532397357, -0.06533923798456039, 0.009128171697420397,
    -0.0008978316975850138, 5.914830951568466e-05, -2.454260270985954e-06,
    5.750126543924546e-08, -5.770954416805585e-10,
)
_GELU_CLAMP = 3.2 * float(np.sqrt(2.0))  # |erf(x/√2)| == 1 to f32 beyond


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU on f32; the degree-15 polynomial, evaluated in f32, on
    bf16 — the choice the JAX package makes by default."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x)
    xf = x.float()
    xc = xf.clamp(-_GELU_CLAMP, _GELU_CLAMP)
    t = xc * xc
    p = torch.full_like(t, _GELU_POLY_15[-1])
    for coef in _GELU_POLY_15[-2::-1]:
        p = p * t + coef
    return (xf * (0.5 + xc * p)).to(x.dtype)


def filtered_gelu(x: torch.Tensor, up_taps, down_taps, factor: int = 2) -> torch.Tensor:
    """Filtered nonlinearity (NCHW): 2x alias-free up → GELU → 2x down."""
    x = upsample2x(x, up_taps, factor)
    x = gelu_exact(x)
    return downsample2x(x, down_taps, factor)


def maxpool2x(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool (NCHW) — the baseline ``Down`` block's pool."""
    return F.max_pool2d(x, 2)


@functools.lru_cache(maxsize=32)
def resize_matrix_1d(
    in_size: int,
    out_size: int,
    align_corners: bool,
    dtype=np.float32,
) -> np.ndarray:
    """Dense 1D bilinear interpolation operator, shape (out_size, in_size).

    Built in float64, cast on return. The cached array is shared: do not
    write to it.
    """
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if in_size == 1:
        m[:, 0] = 1.0
        return m.astype(dtype)
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            src = (i + 0.5) * in_size / out_size - 0.5
        src = min(max(src, 0.0), in_size - 1.0)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m.astype(dtype)


def upsample_bilinear_align_corners(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Bilinear upsample with align_corners=True semantics (NCHW), as two
    separable matrix products — the JAX package's formulation."""
    _, _, h, w = x.shape
    mh = torch.as_tensor(resize_matrix_1d(h, h * factor, True), dtype=x.dtype, device=x.device)
    mw = torch.as_tensor(resize_matrix_1d(w, w * factor, True), dtype=x.dtype, device=x.device)
    x = torch.einsum("oh,nchw->ncow", mh, x)
    return torch.einsum("pw,ncow->ncop", mw, x)
