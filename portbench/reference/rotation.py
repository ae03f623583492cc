"""Grid-wrap cubic B-spline rotation of square images, from its definition.

Config E rotates the latent after every reverse step by a fixed angle, as
the reference model does with ``scipy.ndimage.rotate(img, angle,
reshape=False, mode='grid-wrap', order=3)`` on each (H, W) plane. That map
is, for an image f of side N:

1. the periodic cubic B-spline coefficients c of f along each axis in turn:
   ``(c[i−1] + 4·c[i] + c[i+1])/6 = f[i]`` with indices modulo N, the
   inverse of a circulant, solved by the FFT (its spectrum
   ``2/3 + cos(2πk/N)/3`` is at least 1/3);
2. for each output pixel (row y, column x), the source point of the inverse
   rotation about the centre ``(N−1)/2``: with ``oy = y − (N−1)/2`` and
   ``ox = x − (N−1)/2``, ``sy = cos θ·oy + sin θ·ox + (N−1)/2`` and
   ``sx = −sin θ·oy + cos θ·ox + (N−1)/2``, which turns the image
   counter-clockwise by θ as it is displayed with row 0 at the top;
3. the sum over the 16 taps at rows ``floor(sy) − 1 … floor(sy) + 2`` and
   columns ``floor(sx) − 1 … floor(sx) + 2``, wrapped modulo N, of c at the
   tap times the cubic B-spline weights ``β(sy − row)·β(sx − column)`` with
   ``β(t) = 2/3 − t² + |t|³/2`` for ``|t| < 1``, ``(2 − |t|)³/6`` for
   ``1 ≤ |t| < 2``.

In float64, with TF32 off (``precision.exact_float32`` around the caller).
Departures from the reference's scipy call: none (the CPU tests hold it to
scipy within 1e-6 of the image's largest entry). It imports nothing of the
port, of JAX or of ``scipy.ndimage``.
"""

from __future__ import annotations

import math

import torch


def bspline3(t: torch.Tensor) -> torch.Tensor:
    """The centred cubic B-spline at ``t``."""
    a = t.abs()
    return torch.where(a < 1.0, 2.0 / 3.0 - a * a + a**3 / 2.0,
                       torch.where(a < 2.0, (2.0 - a) ** 3 / 6.0, torch.zeros_like(a)))


def prefilter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Periodic cubic B-spline coefficients of ``x`` along ``dim`` (step 1)."""
    n = x.shape[dim]
    k = torch.arange(n, dtype=torch.float64, device=x.device)
    spectrum = 2.0 / 3.0 + torch.cos(2.0 * math.pi * k / n) / 3.0
    shape = [1] * x.dim()
    shape[dim] = n
    return torch.fft.ifft(torch.fft.fft(x, dim=dim) / spectrum.view(shape), dim=dim).real


def taps(size: int, degrees: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 2 and 3 for every output pixel: the (16, size²) flat source
    indices of the taps and their float64 weights."""
    theta = math.radians(degrees)
    c = (size - 1) / 2.0
    grid = torch.arange(size, dtype=torch.float64, device=device)
    oy, ox = torch.meshgrid(grid - c, grid - c, indexing="ij")
    sy = math.cos(theta) * oy + math.sin(theta) * ox + c
    sx = -math.sin(theta) * oy + math.cos(theta) * ox + c
    y0, x0 = torch.floor(sy).long() - 1, torch.floor(sx).long() - 1
    idx, w = [], []
    for ky in range(4):
        for kx in range(4):
            row, col = y0 + ky, x0 + kx
            idx.append(((row % size) * size + col % size).flatten())
            w.append((bspline3(sy - row) * bspline3(sx - col)).flatten())
    return torch.stack(idx), torch.stack(w)


def rotate(x: torch.Tensor, degrees: float, operand=None) -> torch.Tensor:
    """Each (H, W) plane of the NHWC batch ``x`` turned by ``degrees``, in
    float64. ``operand``, when given, rounds the operands of the tap sum (the
    coefficients and the weights): a control that computes the rotation in a
    lower precision."""
    n, h, w, ch = x.shape
    if h != w:
        raise ValueError(f"rotation needs square images, got {h}x{w}")
    coeffs = prefilter(prefilter(x.to(torch.float64), 1), 2).reshape(n, h * w, ch)
    idx, weights = taps(h, float(degrees), x.device)
    if operand is not None:
        coeffs, weights = operand(coeffs), operand(weights)
    out = (coeffs[:, idx] * weights[None, :, :, None]).sum(dim=1)
    return out.reshape(n, h, w, ch)
