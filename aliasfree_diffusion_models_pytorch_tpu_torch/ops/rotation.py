"""Grid-wrap rotation and translation for rotation-equivariant sampling.

Port of the dense path of ``aliasfree_diffusion_models_pytorch_tpu/ops/rotation.py``
(:151-227, :268-294). For a fixed angle, ``scipy.ndimage.rotate(...,
reshape=False, mode='grid-wrap')`` with spline interpolation is a fixed
linear map of the pixels: the dense ``(H*W, H*W)`` operator is built once by
pushing the identity basis through that scipy call, and each sampler step
applies it as one matrix product. Images up to 64 px only; the gather plan
for larger images is not ported yet. Integer grid-wrap translation is a roll.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Largest image side for the dense (H*W, H*W) operator: 64 → 64 MB fp32.
_MAX_DENSE_OPERATOR_SIZE = 64


@functools.lru_cache(maxsize=32)
def rotation_operator(size: int, degrees: float, order: int = 3) -> np.ndarray:
    """Dense (size², size²) pixel-space rotation operator.

    ``out_flat = M @ in_flat`` reproduces ``scipy.ndimage.rotate(img, degrees,
    reshape=False, mode='grid-wrap', order=order)``. The cached array is
    shared: do not write to it.
    """
    if size > _MAX_DENSE_OPERATOR_SIZE:
        raise ValueError(
            f"rotation_operator: the dense (H², H²) operator is limited to "
            f"{_MAX_DENSE_OPERATOR_SIZE}x{_MAX_DENSE_OPERATOR_SIZE} images "
            f"(got {size}x{size}); the port has no gather-based rotation yet")
    from scipy import ndimage

    basis = np.eye(size * size, dtype=np.float64).reshape(size * size, size, size)
    rotated = ndimage.rotate(
        basis, angle=degrees, axes=(1, 2), reshape=False, mode="grid-wrap", order=order
    )
    # Column k of M is the response to basis image k.
    return np.ascontiguousarray(
        rotated.reshape(size * size, size * size).T
    ).astype(np.float32)


def build_rotation(size: int, degrees: float, order: int = 3, device="cuda") -> torch.Tensor:
    """The per-step rotation operator as a tensor on ``device``."""
    return torch.from_numpy(rotation_operator(size, float(degrees), order)).to(device)


def apply_pixel_operator(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Apply a dense (H·W, H·W) pixel-space linear operator to an NHWC batch."""
    n, h, w, c = x.shape
    return torch.matmul(m.to(x.dtype), x.reshape(n, h * w, c)).reshape(n, h, w, c)


def shift_nhwc(x: torch.Tensor, hshift: int, vshift: int = 0) -> torch.Tensor:
    """Integer grid-wrap translation of each (H, W) plane: a circular roll
    (spline interpolation at grid points is the identity)."""
    if int(hshift) != hshift or int(vshift) != vshift:
        raise ValueError("the port's shift_nhwc takes integer offsets only")
    return torch.roll(x, shifts=(int(vshift), int(hshift)), dims=(1, 2))
