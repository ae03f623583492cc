"""Data pipelines (numpy, and the host-side C++ binding): MNIST-CSV,
image-folder trees, synthetic fallback, batch iterator.

The port's own copy of ``aliasfree_diffusion_models_pytorch_tpu/data.py``:

* :func:`load_mnist_csv`: CSV with a header line, the label in column 0 and
  784 pixel columns; ``/255`` → bilinear 28→32 resize (align_corners=False)
  → ``(x − 0.5)/0.5`` → [-1, 1]. The whole dataset is held in memory. The
  C++ parser (``utils/native.py``) reads it where it can be built, numpy
  otherwise, with the same values.
* :func:`load_image_folder`: a class-per-subdirectory image tree (CIFAR-10 or
  MNIST-M as PNGs), shorter-edge bilinear resize through PIL, ``/255`` →
  ``(x − 0.5)/0.5``; gray images keep one channel, the rest become RGB.
* :func:`synthetic_dataset`: procedural stand-in, bit-equal to the JAX
  package's for the same arguments.
* :class:`Dataloader`: deterministic shuffling (splitmix64 Fisher-Yates, the
  same order as the JAX package's loader for the same seed and epoch) through
  the C++ binding when it is built and numpy otherwise, with the same order;
  the batch gather is numpy indexing, which beats the binding's gather at the
  trainer's batches (PERF.md); NHWC float32 batches.
* :class:`PrefetchLoader`: background-thread prefetch.

Batches are numpy arrays; the trainer moves them to the card.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
from typing import Iterator

import numpy as np

from aliasfree_diffusion_models_pytorch_tpu_torch.ops.resample import resize_matrix_1d
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import native

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset: images NHWC float32 in [-1, 1], integer labels."""

    images: np.ndarray
    labels: np.ndarray

    def __post_init__(self):
        if self.images.ndim != 4:
            raise ValueError(f"images must be NHWC, got shape {self.images.shape}")
        if len(self.images) != len(self.labels):
            raise ValueError(f"{len(self.images)} images but {len(self.labels)} labels")

    def __len__(self) -> int:
        return len(self.images)


def resize_bilinear_np(x: np.ndarray, out_size: int) -> np.ndarray:
    """Bilinear resize of an NHWC batch via separable constant matrices
    (align_corners=False, the convention of torchvision's tensor ``Resize``)."""
    _, h, w, _ = x.shape
    if h == out_size and w == out_size:
        return x
    mh = resize_matrix_1d(h, out_size, align_corners=False, dtype=np.float32)
    mw = resize_matrix_1d(w, out_size, align_corners=False, dtype=np.float32)
    x = np.einsum("oh,nhwc->nowc", mh, x)
    return np.einsum("pw,nhwc->nhpc", mw, x)


def load_mnist_csv(path: str, image_size: int = 32) -> ArrayDataset:
    """MNIST from a CSV file: a header line, then ``label,p0,...,p783`` rows.

    The C++ parser multiplies each pixel by the f32 ``1/255``; the numpy path
    does the same, so the two give the same bits.
    """
    parsed = native.parse_label_pixel_csv(path, cols=784)
    if parsed is not None:
        labels, feats = parsed
    else:
        data = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float32, ndmin=2)
        if data.shape[1] != 785:
            raise ValueError(
                f"{path}: expected 785 columns (label + 784 pixels), got {data.shape[1]}")
        labels = data[:, 0].astype(np.int32)
        feats = data[:, 1:] * (np.float32(1.0) / np.float32(255.0))
    feats = resize_bilinear_np(feats.reshape(-1, 28, 28, 1), image_size)
    feats = (feats - 0.5) / 0.5
    return ArrayDataset(feats, labels)


def load_image_folder(root: str, image_size: int = 32) -> ArrayDataset:
    """An image tree with one subdirectory per class (sorted; the label is
    the index) as an in-memory NHWC dataset: shorter edge resized to
    ``image_size`` (bilinear, through PIL), ``/255``, ``(x − 0.5)/0.5``.
    Gray images keep one channel; everything else becomes RGB."""
    from PIL import Image

    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {root}")
    images, labels = [], []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if not fname.lower().endswith(IMAGE_EXTENSIONS):
                continue
            with Image.open(os.path.join(cdir, fname)) as opened:
                img = (opened.convert("L") if opened.mode in ("L", "1", "I;16")
                       else opened.convert("RGB"))
            w, h = img.size
            if min(w, h) != image_size:
                scale = image_size / min(w, h)
                img = img.resize((round(w * scale), round(h * scale)), Image.Resampling.BILINEAR)
            arr = np.asarray(img, dtype=np.float32) / 255.0
            if arr.ndim == 2:
                arr = arr[:, :, None]
            images.append(arr)
            labels.append(ci)
    x = np.stack(images)
    x = (x - 0.5) / 0.5
    return ArrayDataset(x, np.asarray(labels, np.int32))


def synthetic_dataset(
    n: int = 512, image_size: int = 32, channels: int = 1, seed: int = 0
) -> ArrayDataset:
    """Procedural stand-in (smooth random blobs in [-1, 1]) for runs with no
    dataset mounted. The class label determines the pattern's frequency band
    (class k → frequencies ≈ 0.5 + 0.28·k, small jitter), so a conditional
    model can learn the mapping."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    freq = (
        0.5
        + 0.28 * labels[:, None, None]
        + rng.uniform(0.0, 0.2, (n, 2, channels))
    )
    phase = rng.uniform(0, 2 * np.pi, (n, 2, channels))
    yy, xx = np.mgrid[0:image_size, 0:image_size] / image_size * 2 * np.pi
    img = np.sin(freq[:, 0, None, None, :] * yy[None, :, :, None] + phase[:, 0, None, None, :]) \
        * np.sin(freq[:, 1, None, None, :] * xx[None, :, :, None] + phase[:, 1, None, None, :])
    return ArrayDataset(img.astype(np.float32), labels)


_SM64_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_SM64_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_SM64_MIX2 = np.uint64(0x94D049BB133111EB)
_SM64_EPOCH_OFF = np.uint64(0xD1B54A32D192ED03)


def splitmix64_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """splitmix64 Fisher-Yates permutation of ``range(n)``: ``seed`` and
    ``epoch`` fully determine the order. The numbered-stream draws are
    vectorised; only the sequential swap loop runs in Python (O(n) per epoch).
    """
    out = np.arange(n, dtype=np.int64)
    if n <= 1:
        return out
    with np.errstate(over="ignore"):
        s0 = np.uint64(seed) * _SM64_GOLDEN + np.uint64(epoch) + _SM64_EPOCH_OFF
        # Draw k for swap index i = n-1-k uses stream state s0 + (k+1)*GOLDEN.
        z = s0 + np.arange(1, n, dtype=np.uint64) * _SM64_GOLDEN
        z = (z ^ (z >> np.uint64(30))) * _SM64_MIX1
        z = (z ^ (z >> np.uint64(27))) * _SM64_MIX2
        z ^= z >> np.uint64(31)
    ladder = np.arange(n, 1, -1, dtype=np.uint64)  # i+1 for i = n-1 .. 1
    js = (z % ladder).astype(np.int64)
    for k in range(n - 1):
        i = n - 1 - k
        j = js[k]
        out[i], out[j] = out[j], out[i]
    return out


class Dataloader:
    """Deterministic shuffling batch iterator over an :class:`ArrayDataset`.

    ``seed`` and the epoch count fully determine the order. ``drop_last=False``
    matches the torch ``DataLoader`` default: the last batch may be short.
    """

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        if self.shuffle:
            order = native.shuffled_permutation(n, self.seed, self.epoch)
            if order is None:
                _log_numpy_fallback_once()
                order = splitmix64_permutation(n, self.seed, self.epoch)
        else:
            order = np.arange(n)
        self.epoch += 1
        stop = n - n % self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            idx = order[start : start + self.batch_size]
            yield self.dataset.images[idx], self.dataset.labels[idx]


_NUMPY_FALLBACK_LOGGED = False


def _log_numpy_fallback_once() -> None:
    global _NUMPY_FALLBACK_LOGGED
    if not _NUMPY_FALLBACK_LOGGED:
        _NUMPY_FALLBACK_LOGGED = True
        logging.getLogger(__name__).info(
            "native loader unavailable; numpy shuffle (the same splitmix64 order)")


class PrefetchLoader:
    """Background-thread prefetch wrapper around any batch iterable: the
    host-side gather of the next batch overlaps the device step. A bounded
    queue keeps memory flat."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()

        def worker():
            # A loader exception must not look like an early end of epoch:
            # enqueue it and re-raise in the consumer.
            try:
                for item in self.loader:
                    q.put(item)
                q.put(sentinel)
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                t.join()
                raise item
            yield item
        t.join()


def get_data(
    dataset: str,
    dataset_path: str | None,
    image_size: int,
    batch_size: int,
    *,
    image_channels: int | None = None,
    seed: int = 0,
    drop_last: bool = False,
    synthetic_fallback: bool = False,
) -> tuple[Dataloader, ArrayDataset]:
    """``(dataloader, dataset)``: the synthetic dataset when no path is given
    (or, with ``synthetic_fallback``, when the path does not exist), the CSV
    loader for "MNIST", the image-folder loader for any other dataset."""
    if dataset_path is None or (
        synthetic_fallback and not os.path.exists(dataset_path)
    ):
        channels = image_channels or (1 if dataset == "MNIST" else 3)
        ds = synthetic_dataset(image_size=image_size, seed=seed, channels=channels)
    elif dataset == "MNIST":
        ds = load_mnist_csv(dataset_path, image_size)
    else:
        ds = load_image_folder(dataset_path, image_size)
    dl = Dataloader(ds, batch_size, shuffle=True, drop_last=drop_last, seed=seed)
    return dl, ds
