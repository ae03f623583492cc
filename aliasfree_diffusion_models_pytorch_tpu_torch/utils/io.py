"""Image and video IO: grids, per-image dumps, collages, videos, GIFs.

The port's own copy of the JAX package's ``utils/io.py``. Grids are tiled by
hand with ``torchvision.utils.make_grid``'s geometry; GIF export is native
PIL; mp4 export is attempted through imageio and falls back to a GIF with a
warning where imageio or its ffmpeg backend is missing. PIL and imageio are
imported inside the functions that need them.

All functions take uint8 NHWC numpy arrays (the samplers' output format).
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np

logger = logging.getLogger(__name__)


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


def save_gen_images(path_dir: str, data: np.ndarray, fileno) -> None:
    """Save a uint8 batch as ``image_{fileno[i]}.png`` files (the image sets
    the metrics are computed on)."""
    os.makedirs(path_dir, exist_ok=True)
    for i in range(data.shape[0]):
        _to_pil(data[i]).save(os.path.join(path_dir, f"image_{fileno[i]}.png"))


def save_dataset_images(path_dir: str, images_pm1: np.ndarray) -> None:
    """Export a [-1, 1] float NHWC dataset as PNGs (the metrics' reference set)."""
    x = np.clip((images_pm1 + 1.0) / 2.0 * 255.0, 0, 255).astype(np.uint8)
    save_gen_images(path_dir, x, np.arange(x.shape[0]))


def make_collage(
    filedir: str,
    savedir: str,
    images_per_collage: int,
    total_image: int,
    image_size: int,
) -> list[str]:
    """Tile ``image_{i}.png`` files into √n x √n collages, pasted in
    column-major order as the reference does."""
    from PIL import Image

    per_dim_total = int(math.isqrt(images_per_collage))
    per_dim = image_size * per_dim_total
    written = []
    for start_no in range(0, total_image, images_per_collage):
        files = [
            os.path.join(filedir, f"image_{i}.png")
            for i in range(start_no, start_no + images_per_collage)
        ]
        imgs = [Image.open(f).resize((image_size, image_size)) for f in files]
        collage = Image.new("RGB", (per_dim, per_dim))
        for i in range(per_dim_total):
            for j in range(per_dim_total):
                collage.paste(imgs[i * per_dim_total + j], (i * image_size, j * image_size))
        out = f"{savedir}_collage_{start_no}.png"
        _ensure_dir(out)
        collage.save(out)
        written.append(out)
    return written


def _normalize_frames(frames: np.ndarray) -> list[np.ndarray]:
    """Global min-max → a list of uint8 HWC frames (grey repeated to RGB)."""
    f = frames.astype(np.float64)
    f = (f - f.min()) / max(f.max() - f.min(), 1e-12)
    f = (f * 255).astype(np.uint8)
    out = []
    for frame in f:
        if frame.shape[-1] == 1:
            frame = np.repeat(frame, 3, axis=-1)
        out.append(frame)
    return out


def make_video(frames: np.ndarray, vname: str, fps: int = 1) -> str:
    """Write ``{vname}.mp4`` (imageio) or, where imageio or an ffmpeg backend
    is missing, ``{vname}.gif``; returns the path written.

    ``frames`` is (T, H, W, C) uint8 or float NHWC (the samplers' trajectory
    output).
    """
    frames_u8 = _normalize_frames(np.asarray(frames))
    try:
        import imageio

        path = f"{vname}.mp4"
        _ensure_dir(path)
        imageio.mimsave(path, frames_u8, fps=fps, format="mp4")
        return path
    except Exception as e:  # noqa: BLE001 — no imageio or no ffmpeg backend
        logger.warning("mp4 export unavailable (%s); writing GIF instead", e)
        return save_gif_frames(frames_u8, vname, fps)


def save_gif_frames(frames_u8: list[np.ndarray], filename: str, fps: int = 1,
                    scale: int | None = None) -> str:
    """Native-PIL GIF export of a list of uint8 frames; returns the path."""
    from PIL import Image

    imgs = [_to_pil(f) for f in frames_u8]
    if scale:
        imgs = [im.resize((scale, int(im.height * scale / im.width)),
                          Image.Resampling.LANCZOS) for im in imgs]
    path = f"{filename}.gif"
    _ensure_dir(path)
    imgs[0].save(
        path, save_all=True, append_images=imgs[1:],
        duration=max(int(1000 / fps), 20), loop=0,
    )
    return path


def save_gif(filename: str, fps: int, scale: int) -> str:
    """Convert ``{filename}.mp4`` to a GIF (re-read with imageio); where
    :func:`make_video` already wrote a GIF, return that."""
    mp4 = f"{filename}.mp4"
    if os.path.exists(mp4):
        import imageio

        frames = [np.asarray(f) for f in imageio.mimread(mp4, memtest=False)]
        return save_gif_frames(frames, filename, fps, scale)
    gif = f"{filename}.gif"
    if os.path.exists(gif):
        return gif
    raise FileNotFoundError(mp4)
