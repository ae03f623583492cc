"""The low-pass taps of the alias-free layers, designed in float64.

A circularly symmetric jinc ``omega_c·J1(omega_c·r)/(2·pi·r)`` with the
centre value ``omega_c²/(4·pi)`` for an odd size, times a 2-D Kaiser window
(the outer product of two 1-D ones), normalised to sum to one when asked.
"""

from __future__ import annotations

import numpy as np
from scipy.special import j1


def lowpass_taps(omega_c: float, size: int, beta: float | None, normalize: bool) -> np.ndarray:
    """The ``(size, size)`` taps, float32."""
    n = int(size)
    c = (n - 1) / 2.0
    x, y = np.meshgrid(np.arange(n, dtype=np.float64), np.arange(n, dtype=np.float64),
                       indexing="ij")
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        taps = omega_c * j1(omega_c * r) / (2.0 * np.pi * r)
    if n % 2:
        taps[n // 2, n // 2] = omega_c**2 / (4.0 * np.pi)
    if beta is not None:
        w = np.kaiser(n, beta)
        taps = taps * np.outer(w, w)
    if normalize:
        taps = taps / taps.sum()
    return taps.astype(np.float32)


def design(filters: dict) -> tuple[np.ndarray, np.ndarray]:
    """(up taps, down taps) of a configuration's ``filters`` group."""
    k, beta, norm = filters["kernel_size"], filters["kaiser_beta"], filters["normalize"]
    return (lowpass_taps(filters["omega_c_up"], k, beta, norm),
            lowpass_taps(filters["omega_c_down"], k, beta, norm))
