"""Grid-wrap rotation and translation for rotation-equivariant sampling.

Port of ``aliasfree_diffusion_models_pytorch_tpu/ops/rotation.py`` (:41-294).
For a fixed angle, ``scipy.ndimage.rotate(..., reshape=False,
mode='grid-wrap')`` with spline interpolation is a fixed linear map of the
pixels, built once and applied after every sampler step:

* up to 64 px, the dense ``(H*W, H*W)`` operator, built by pushing the
  identity basis through that scipy call and applied as one matrix product;
* above, a :class:`GatherRotation` plan at the same spline order: the exact
  separable grid-wrap prefilter (orders ≥ 2, two small matrix products), then
  (order+1)² gathers of B-spline taps and their weighted sum. Memory grows as
  (order+1)²·H² instead of H⁴.

Both are plain PyTorch (``torch.matmul``, ``einsum``, indexing), as the JAX
package leaves them to XLA. Integer grid-wrap translation is a roll;
fractional offsets apply scipy's 1-D spline shift operators per axis.

Tracing (``utils/spans.py``). While a torch.profiler session records, each
:func:`build_rotation` runs in the span ``rotation.build`` (the cache lookup,
the build on the host, the copy to the device) and counts ``rotation.built``:
1 when it built the operator or plan, 0 when a cache served it. The per-step
apply runs inside the sampler's CUDA graph, where no span runs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.utils import spans

# Largest image side for the dense (H*W, H*W) operator: 64 → 64 MB fp32.
# Above it, rotation takes the gather plan at the same spline order.
_MAX_DENSE_OPERATOR_SIZE = 64

_BUILD = spans.Span("rotation.build")


class GatherRotation(NamedTuple):
    """Grid-wrap spline rotation as (order+1)² gathers and a weighted sum.

    ``idx``: (T, H·W) flat source indices of the spline taps (T = (order+1)²);
    ``w``: (T, H·W) f32 B-spline tap weights; ``pre``: the (H, H) separable
    spline prefilter for orders ≥ 2 (scipy's periodic ``spline_filter1d``),
    applied along both axes before the gather, else None. numpy arrays from
    :func:`rotation_gather_plan`, tensors from :func:`build_rotation`.
    """

    idx: np.ndarray | torch.Tensor
    w: np.ndarray | torch.Tensor
    pre: np.ndarray | torch.Tensor | None = None


@functools.lru_cache(maxsize=8)
def spline_prefilter_operator(size: int, order: int = 3) -> np.ndarray:
    """Dense (size, size) grid-wrap spline-prefilter operator.

    With periodic boundaries scipy's prefilter is a linear map, so pushing the
    identity basis through ``spline_filter1d(mode='grid-wrap')`` gives it
    exactly. The 2-D prefilter is separable: ``coeffs = P @ img @ P.T``. The
    cached array is shared: do not write to it.
    """
    from scipy import ndimage

    return ndimage.spline_filter1d(
        np.eye(size, dtype=np.float64), order=order, axis=0, mode="grid-wrap"
    ).astype(np.float32)


def _bspline_weights(frac_to_taps: np.ndarray, order: int) -> np.ndarray:
    """Centred cardinal B-spline of degree ``order``, elementwise: scipy's
    interpolation weights (order 1 the linear hat, order 3 the cubic
    B-spline; other orders through ``scipy.interpolate.BSpline``)."""
    t = np.abs(frac_to_taps)
    if order == 1:
        return np.maximum(0.0, 1.0 - t)
    if order == 3:
        return np.where(
            t < 1, 2 / 3 - t * t + t**3 / 2,
            np.where(t < 2, (2 - t) ** 3 / 6, 0.0),
        )
    from scipy.interpolate import BSpline

    half = (order + 1) / 2.0
    basis = BSpline.basis_element(np.arange(order + 2) - half, extrapolate=False)
    return np.nan_to_num(basis(frac_to_taps), nan=0.0)


@functools.lru_cache(maxsize=32)
def rotation_gather_plan(size: int, degrees: float, order: int = 1) -> GatherRotation:
    """Grid-wrap spline rotation plan for any image size and spline order.

    Reproduces ``scipy.ndimage.rotate(img, degrees, reshape=False,
    mode='grid-wrap', order=order)``: each output pixel is pulled back through
    the inverse rotation about the centre ``(size-1)/2``, source coordinates
    wrap modulo ``size``, and the (order+1)² taps blend with B-spline weights;
    orders ≥ 2 carry the prefilter (:func:`spline_prefilter_operator`). The
    cached plan is shared: do not write to it.
    """
    theta = np.deg2rad(degrees)
    c = (size - 1) / 2.0
    yy, xx = np.meshgrid(
        np.arange(size, dtype=np.float64),
        np.arange(size, dtype=np.float64),
        indexing="ij",
    )
    # scipy.ndimage.rotate: input_coord = M @ (output_coord - c) + c with
    # M = [[cos, sin], [-sin, cos]] over the (rows, cols) plane.
    oy, ox = yy - c, xx - c
    sy = np.cos(theta) * oy + np.sin(theta) * ox + c
    sx = -np.sin(theta) * oy + np.cos(theta) * ox + c
    # First tap as scipy takes it: floor(x) - order//2 for odd orders,
    # floor(x + 0.5) - order//2 for even ones; order+1 taps per axis.
    if order % 2:
        y0 = np.floor(sy).astype(np.int64) - order // 2
        x0 = np.floor(sx).astype(np.int64) - order // 2
    else:
        y0 = np.floor(sy + 0.5).astype(np.int64) - order // 2
        x0 = np.floor(sx + 0.5).astype(np.int64) - order // 2

    taps = order + 1
    idx_rows, w_rows = [], []
    for ky in range(taps):
        wy = _bspline_weights(sy - (y0 + ky), order)
        for kx in range(taps):
            wx = _bspline_weights(sx - (x0 + kx), order)
            idx_rows.append(
                (((y0 + ky) % size) * size + ((x0 + kx) % size))
                .astype(np.int32).ravel()
            )
            w_rows.append((wy * wx).ravel())
    pre = spline_prefilter_operator(size, order) if order >= 2 else None
    return GatherRotation(
        idx=np.stack(idx_rows), w=np.stack(w_rows).astype(np.float32), pre=pre
    )


@functools.lru_cache(maxsize=32)
def rotation_operator(size: int, degrees: float, order: int = 3) -> np.ndarray:
    """Dense (size², size²) pixel-space rotation operator.

    ``out_flat = M @ in_flat`` reproduces ``scipy.ndimage.rotate(img, degrees,
    reshape=False, mode='grid-wrap', order=order)``. Its memory grows as
    size⁴, so it is refused above 64 px (:func:`build_rotation` takes the
    gather plan there). The cached array is shared: do not write to it.
    """
    if size > _MAX_DENSE_OPERATOR_SIZE:
        raise ValueError(
            f"rotation_operator: the dense (H², H²) operator is limited to "
            f"{_MAX_DENSE_OPERATOR_SIZE}x{_MAX_DENSE_OPERATOR_SIZE} images "
            f"(got {size}x{size}); use rotation_gather_plan above that")
    from scipy import ndimage

    basis = np.eye(size * size, dtype=np.float64).reshape(size * size, size, size)
    rotated = ndimage.rotate(
        basis, angle=degrees, axes=(1, 2), reshape=False, mode="grid-wrap", order=order
    )
    # Column k of M is the response to basis image k.
    return np.ascontiguousarray(
        rotated.reshape(size * size, size * size).T
    ).astype(np.float32)


def build_rotation(size: int, degrees: float, order: int = 3, device="cuda"):
    """The per-step rotation operand on ``device``: the dense operator up to
    64 px, else the :class:`GatherRotation` plan (both at the requested
    spline order, both scipy's map). Traced as ``rotation.build`` and
    ``rotation.built`` (module docstring)."""
    dense = size <= _MAX_DENSE_OPERATOR_SIZE
    cache = rotation_operator if dense else rotation_gather_plan
    with _BUILD:
        misses = cache.cache_info().misses if spans.live() else None
        if dense:
            operand = torch.from_numpy(rotation_operator(size, float(degrees), order)).to(device)
        else:
            plan = rotation_gather_plan(size, float(degrees), order)
            operand = GatherRotation(
                idx=torch.from_numpy(plan.idx).to(device=device, dtype=torch.long),
                w=torch.from_numpy(plan.w).to(device),
                pre=None if plan.pre is None else torch.from_numpy(plan.pre).to(device),
            )
        if misses is not None:
            spans.count("rotation.built", cache.cache_info().misses - misses)
    return operand


def apply_pixel_operator(x: torch.Tensor, m) -> torch.Tensor:
    """Apply a pixel-space linear operator to an NHWC batch: ``m`` is the
    dense (H·W, H·W) matrix or a :class:`GatherRotation` of tensors on
    ``x``'s device."""
    n, h, w, c = x.shape
    if isinstance(m, GatherRotation):
        if m.pre is not None:
            pre = m.pre.to(x.dtype)
            x = torch.einsum("ph,nhwc->npwc", pre, x)
            x = torch.einsum("qw,npwc->npqc", pre, x)
        taps = x.reshape(n, h * w, c)[:, m.idx]  # (n, T, H·W, c)
        out = (taps * m.w.to(x.dtype)[None, :, :, None]).sum(dim=1)
        return out.reshape(n, h, w, c)
    return torch.matmul(m.to(x.dtype), x.reshape(n, h * w, c)).reshape(n, h, w, c)


def rotate_nhwc(x: torch.Tensor, degrees: float, order: int = 3) -> torch.Tensor:
    """Rotate each (H, W) plane of an NHWC batch by a fixed angle on its
    device: the reference's ``rotate_2d_matrix`` without the trip to scipy."""
    _, h, w, _ = x.shape
    if h != w:
        raise ValueError(f"rotation requires square images, got {h}x{w}")
    return apply_pixel_operator(x, build_rotation(h, float(degrees), order, x.device))


@functools.lru_cache(maxsize=64)
def shift_operator_1d(size: int, offset: float, order: int = 3) -> np.ndarray:
    """Dense (size, size) 1-D grid-wrap sub-pixel shift operator, built by
    pushing the identity basis through ``scipy.ndimage.shift``. A 2-D shift
    is one such operator per axis. The cached array is shared: do not write
    to it."""
    from scipy import ndimage

    basis = np.eye(size, dtype=np.float64)
    shifted = ndimage.shift(basis, (0.0, offset), mode="grid-wrap", order=order)
    return np.ascontiguousarray(shifted.T).astype(np.float32)


def shift_nhwc(x: torch.Tensor, hshift: float, vshift: float = 0, order: int = 3) -> torch.Tensor:
    """Grid-wrap translation of each (H, W) plane by a fixed offset.

    Integer offsets are a circular roll (spline interpolation at grid points
    is the identity); fractional ones apply scipy's spline shift operator
    along each axis that moves.
    """
    if float(hshift).is_integer() and float(vshift).is_integer():
        return torch.roll(x, shifts=(int(vshift), int(hshift)), dims=(1, 2))
    _, h, w, _ = x.shape
    out = x
    if vshift:
        mv = torch.from_numpy(shift_operator_1d(h, float(vshift), order)).to(x.device, x.dtype)
        out = torch.einsum("ph,nhwc->npwc", mv, out)
    if hshift:
        mh = torch.from_numpy(shift_operator_1d(w, float(hshift), order)).to(x.device, x.dtype)
        out = torch.einsum("qw,nhwc->nhqc", mh, out)
    return out
