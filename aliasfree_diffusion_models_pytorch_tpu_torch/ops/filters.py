"""Low-pass FIR filter design (pure NumPy, design time).

The port's copy of ``aliasfree_diffusion_models_pytorch_tpu/ops/filters.py``;
the taps must be bit-equal to the JAX package's. Designed in float64 once per
configuration and held by the modules as constant buffers.

* ``circular_lowpass_kernel``: circularly-symmetric jinc
  ``omega_c * J1(omega_c * r) / (2*pi*r)`` with the odd-size centre value
  ``omega_c**2 / (4*pi)``, an optional 2D Kaiser window and sum-to-one
  normalisation.
* ``jinc_filter_2d``: the separable windowed-sinc design (diagnostics only).
"""

from __future__ import annotations

import numpy as np
from scipy.special import j1

__all__ = [
    "circular_lowpass_kernel",
    "jinc_filter_2d",
    "kernel_frequency_response",
]


def circular_lowpass_kernel(
    omega_c: float = np.pi,
    size: int = 6,
    beta: float | None = None,
    normalize: bool = True,
    dtype=np.float32,
) -> np.ndarray:
    """Circularly-symmetric 2D low-pass ("jinc") kernel, ``(size, size)``."""
    n = int(size)
    c = (n - 1) / 2.0
    x, y = np.meshgrid(np.arange(n, dtype=np.float64),
                       np.arange(n, dtype=np.float64), indexing="ij")
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        kernel = omega_c * j1(omega_c * r) / (2.0 * np.pi * r)
    if n % 2:
        # r == 0 at the center for odd sizes: analytic limit of the jinc.
        kernel[(n - 1) // 2, (n - 1) // 2] = omega_c**2 / (4.0 * np.pi)

    if beta is not None:
        w1d = np.kaiser(n, beta)
        kernel = kernel * np.outer(w1d, w1d)

    if normalize:
        kernel = kernel / np.sum(kernel)
    return kernel.astype(dtype)


def jinc_filter_2d(size: int = 6, beta: float = 14.0, dtype=np.float32) -> np.ndarray:
    """Separable windowed-sinc 2D kernel (diagnostics/visualization only)."""
    grid = np.linspace(-size / 2.0, size / 2.0, size)
    sinc_1d = np.sinc(grid) * np.kaiser(size, beta)
    kernel = np.outer(sinc_1d, sinc_1d)
    kernel = kernel / np.sum(kernel)
    return kernel.astype(dtype)


def kernel_frequency_response(kernel: np.ndarray, n_fft: int = 64) -> np.ndarray:
    """|FFT| magnitude response on an ``n_fft x n_fft`` grid (fftshifted)."""
    k = np.asarray(kernel, dtype=np.float64)
    padded = np.zeros((max(n_fft, k.shape[0]), max(n_fft, k.shape[1])))
    padded[: k.shape[0], : k.shape[1]] = k
    return np.abs(np.fft.fftshift(np.fft.fft2(padded)))
