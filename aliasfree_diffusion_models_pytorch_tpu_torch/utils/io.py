"""Image grids: the ``save_image_grid`` part of the JAX package's
``utils/io.py`` (own copy). Takes uint8 NHWC numpy arrays."""

from __future__ import annotations

import math
import os

import numpy as np


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)


def _to_pil(img: np.ndarray):
    from PIL import Image

    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[:, :, 0]
    return Image.fromarray(img)


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: int = 0) -> np.ndarray:
    """Tile an (N, H, W, C) uint8 batch into one image — torchvision
    ``make_grid`` geometry."""
    n, h, w, c = images.shape
    ncols = min(nrow, n)
    nrows = math.ceil(n / ncols)
    grid = np.full(
        (padding + nrows * (h + padding), padding + ncols * (w + padding), c),
        pad_value, dtype=images.dtype,
    )
    for i in range(n):
        r, col = divmod(i, ncols)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y : y + h, x : x + w] = images[i]
    return grid


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8) -> None:
    """Tile ``images`` into a grid and save it (PNG by extension)."""
    _ensure_dir(path)
    _to_pil(make_grid(images, nrow)).save(path)
