"""Matplotlib diagnostics (headless Agg backend).

The port's own copy of the JAX package's ``utils/plotting.py``: horizontal
image strips, per-panel image rows, loss curves and the filter kernel /
frequency-response panel. Every function takes ``save_path`` and returns the
figure. matplotlib is imported inside the functions; :func:`available` says
whether it is installed, so a pipeline can skip its figures on a machine
without it.
"""

from __future__ import annotations

import importlib.util

import numpy as np

from aliasfree_diffusion_models_pytorch_tpu_torch.ops.filters import kernel_frequency_response


def available() -> bool:
    """Whether matplotlib is installed."""
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_images(images: np.ndarray, save_path: str | None = None):
    """Horizontal strip of an (N, H, W, C) uint8 batch; gray colormap for C==1."""
    plt = _plt()
    fig = plt.figure(figsize=(2 * len(images), 2))
    strip = np.concatenate(list(images), axis=1)
    if strip.shape[-1] == 1:
        plt.imshow(strip[:, :, 0], cmap="gray")
    else:
        plt.imshow(strip)
    plt.xticks([]), plt.yticks([])
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_image_panels(
    images: list[np.ndarray],
    titles: list[str],
    save_path: str | None = None,
):
    """Row of individually sized image panels with titles: each float image
    is clamped to [-1, 1], mapped to uint8 and shown in its own subplot (the
    panels have different resolutions, so they are not concatenated)."""
    plt = _plt()
    fig, axs = plt.subplots(1, len(images), figsize=(3 * len(images), 3))
    if len(images) == 1:
        axs = [axs]
    for ax, img, title in zip(axs, images, titles):
        img = np.asarray(img, np.float64)
        img = ((np.clip(img, -1.0, 1.0) + 1.0) / 2.0 * 255.0).astype(np.uint8)
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[:, :, 0]
        ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_loss(loss_all, save_path: str | None = None):
    plt = _plt()
    fig = plt.figure(figsize=(6, 6))
    epochs = np.arange(1, len(loss_all) + 1)
    plt.plot(epochs, loss_all, label="loss")
    plt.xlabel("epoch"), plt.ylabel("Loss"), plt.legend()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_filter_and_response(kernel: np.ndarray, save_path: str | None = None,
                             show_freq: bool = True):
    """Kernel heatmap beside its |FFT| response."""
    plt = _plt()
    fig, axs = plt.subplots(1, 2, figsize=(6, 3))
    cax1 = axs[0].imshow(kernel, vmin=-1, vmax=1, cmap="bwr")
    axs[0].set_title("2D Filter")
    fig.colorbar(cax1, ax=axs[0])
    mag = kernel_frequency_response(kernel, n_fft=max(kernel.shape[0], 64))
    cax2 = axs[1].imshow(mag, cmap="viridis")
    axs[1].set_title("Frequency Response")
    if show_freq:
        n = mag.shape[0]
        freqs = np.fft.fftshift(np.fft.fftfreq(n))
        ticks = [0, n // 4, n // 2, 3 * n // 4, n - 1]
        axs[1].set_xticks(ticks)
        axs[1].set_xticklabels([f"{freqs[t]:.2f}" for t in ticks])
        axs[1].set_yticks(ticks)
        axs[1].set_yticklabels([f"{freqs[t]:.2f}" for t in ticks])
    fig.colorbar(cax2, ax=axs[1])
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig
