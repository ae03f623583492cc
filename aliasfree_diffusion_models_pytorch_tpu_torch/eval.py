"""Generative-quality metrics: Inception Score, FID, KID.

Counterpart of ``aliasfree_diffusion_models_pytorch_tpu/eval.py``. The metric
math is numpy float64 and carried over line for line, so equal features give
bit-equal numbers in the two packages:

* :func:`inception_score` — ``exp(E_x KL(p(y|x) || p(y)))`` over contiguous
  splits (torch-fidelity's protocol);
* :func:`fid` — ``|μ1−μ2|² + Tr(Σ1+Σ2−2(Σ1Σ2)^½)`` with a symmetric
  eigendecomposition square root;
* :func:`kid` — polynomial-kernel (degree 3, gamma 1/d, coef0 1) unbiased
  MMD² over random subsets (100 subsets of min(1000, N)).

Feature extractors (PyTorch, on ``device``):

* :class:`RandomFeatures` — a fixed-seed random conv stack, offline and
  deterministic: for RELATIVE comparison between configs, NOT comparable to
  published FID/IS/KID. Its weights are the JAX class's (drawn by
  ``utils/jax_random.py``, which reproduces ``jax.random``), so both packages
  stamp ``feature_space = 'random-conv-v2'`` on comparable numbers.
* :func:`InceptionV3Features` — the FID-Inception network of
  ``eval_inception.py``, from a local weight file.

Both run float32 convolutions in full float32 on the card (TF32 off for the
call), so a metric does not depend on the device that computed it beyond
summation order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Protocol

import numpy as np
import torch
import torch.nn.functional as F

from aliasfree_diffusion_models_pytorch_tpu_torch.utils import jax_random

__all__ = [
    "inception_score",
    "fid",
    "kid",
    "FeatureExtractor",
    "RandomFeatures",
    "InceptionV3Features",
    "evaluate_folders",
    "calculate_metrics",
]


# ---------------------------------------------------------------------------
# Metric math
# ---------------------------------------------------------------------------


def inception_score(probs: np.ndarray, splits: int = 10) -> tuple[float, float]:
    """IS from per-image class probabilities (N, num_classes).

    Returns (mean, std) over ``splits`` contiguous splits (torch-fidelity
    protocol).
    """
    probs = np.asarray(probs, np.float64)
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits : (i + 1) * n // splits]
        if len(part) == 0:
            continue
        marginal = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(marginal + 1e-16))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def _sqrtm_product(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
    """Tr((Σ1 Σ2)^0.5) via the symmetric form: Σ1^½ Σ2 Σ1^½ has the same
    nonzero eigenvalues as Σ1Σ2 and is PSD, so its root-trace is the sum of
    the square roots of its eigenvalues."""
    vals1, vecs1 = np.linalg.eigh(sigma1)
    vals1 = np.clip(vals1, 0, None)
    root1 = (vecs1 * np.sqrt(vals1)) @ vecs1.T
    m = root1 @ sigma2 @ root1
    vals = np.linalg.eigvalsh((m + m.T) / 2)
    return float(np.sqrt(np.clip(vals, 0, None)).sum())


def fid(feat1: np.ndarray, feat2: np.ndarray) -> float:
    """Fréchet distance between two feature clouds (N1, D) and (N2, D)."""
    f1 = np.asarray(feat1, np.float64)
    f2 = np.asarray(feat2, np.float64)
    mu1, mu2 = f1.mean(0), f2.mean(0)
    s1 = np.cov(f1, rowvar=False)
    s2 = np.cov(f2, rowvar=False)
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * _sqrtm_product(s1, s2))


def _poly_kernel(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def kid(
    feat1: np.ndarray,
    feat2: np.ndarray,
    *,
    subsets: int = 100,
    subset_size: int = 1000,
    seed: int = 0,
) -> tuple[float, float]:
    """Unbiased MMD² with the torch-fidelity polynomial-kernel protocol.

    Returns (mean, std) over subsets. Multiply by 100 for the "KID x 100"
    convention.
    """
    f1 = np.asarray(feat1, np.float64)
    f2 = np.asarray(feat2, np.float64)
    m = min(subset_size, len(f1), len(f2))
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(subsets):
        x = f1[rng.choice(len(f1), m, replace=False)]
        y = f2[rng.choice(len(f2), m, replace=False)]
        kxx = _poly_kernel(x, x)
        kyy = _poly_kernel(y, y)
        kxy = _poly_kernel(x, y)
        vals.append(
            (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
            + (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
            - 2.0 * kxy.mean()
        )
    return float(np.mean(vals)), float(np.std(vals))


# ---------------------------------------------------------------------------
# Feature extractors
# ---------------------------------------------------------------------------


class FeatureExtractor(Protocol):
    name: str

    def features(self, images_u8: np.ndarray) -> np.ndarray:
        """(N, H, W, C) uint8 → (N, D) pooled features."""
        ...

    def logits(self, images_u8: np.ndarray) -> np.ndarray:
        """(N, H, W, C) uint8 → (N, num_classes) class probabilities."""
        ...


# cuDNN's TF32 switch while the metrics' features are computed: off, so the
# convolutions keep about seven decimal digits instead of TF32's three.
EVAL_CUDNN_TF32 = False


@contextlib.contextmanager
def full_float32():
    """Float32 convolutions at cuDNN's :data:`EVAL_CUDNN_TF32` for the
    duration (full float32)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = EVAL_CUDNN_TF32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def xla_same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of XLA's ``"SAME"``: the output has
    ``ceil(size / stride)`` entries and the odd unit of padding goes after.
    At stride 2 on an even size with a 3-tap kernel that is (0, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


@dataclasses.dataclass
class RandomFeatures:
    """Fixed-seed random conv stack — offline and deterministic.

    3x [conv3x3-stride2 + tanh-form gelu] → global mean/std pool → ``dim``
    features; a random readout on the per-image standardised features, at
    ``temperature``, gives "class" probabilities for an IS-like diversity
    score. Relative comparisons only; ``feature_space='random-conv-v2'`` is
    stamped on every result. The four weight tensors are the JAX class's for
    the same ``seed``.
    """

    dim: int = 256
    num_classes: int = 128
    seed: int = 0
    temperature: float = 5.0
    name: str = "random-conv-v2"
    batch_size: int = 512  # images per forward: bounds device memory
    device: str = "cuda"

    def _weights(self, c_in: int) -> tuple[np.ndarray, ...]:
        """(w0, w1, w2, wr) as numpy float32: conv kernels HWIO, readout (dim, classes)."""
        ks = jax_random.split(jax_random.key(self.seed), 4)
        f32 = np.float32
        w0 = jax_random.normal(ks[0], (3, 3, c_in, 64)) / f32(np.sqrt(9 * c_in))
        w1 = jax_random.normal(ks[1], (3, 3, 64, 128)) / f32(np.sqrt(9 * 64))
        w2 = jax_random.normal(ks[2], (3, 3, 128, self.dim // 2)) / f32(np.sqrt(9 * 128))
        wr = jax_random.normal(ks[3], (self.dim, self.num_classes)) / f32(np.sqrt(self.dim))
        return w0, w1, w2, wr

    def _forward(self, x: torch.Tensor, weights) -> tuple[torch.Tensor, torch.Tensor]:
        """x: NHWC float32 in [-1, 1] → (features (N, dim), probabilities)."""
        w0, w1, w2, wr = weights
        h = x.permute(0, 3, 1, 2)
        for w in (w0, w1, w2):
            (hlo, hhi), (wlo, whi) = (xla_same_pad(s, 3, 2) for s in h.shape[2:])
            h = F.gelu(F.conv2d(F.pad(h, (wlo, whi, hlo, hhi)), w, stride=2),
                       approximate="tanh")
        mean = h.mean(dim=(2, 3))
        std = h.std(dim=(2, 3), unbiased=False)
        feats = torch.cat([mean, std], dim=-1)
        # Per-image standardisation is set-independent, so p(y|x) stays a
        # pure function of the image (required for IS).
        f = (feats - feats.mean(-1, keepdim=True)) / (
            feats.std(-1, keepdim=True, unbiased=False) + 1e-8)
        probs = torch.softmax(self.temperature * (f @ wr), dim=-1)
        return feats, probs

    @torch.inference_mode()
    def _run(self, images_u8: np.ndarray):
        device = torch.device(self.device)
        w0, w1, w2, wr = self._weights(images_u8.shape[-1])
        weights = [torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(device)
                   for w in (w0, w1, w2)] + [torch.from_numpy(wr).to(device)]
        feats, probs = [], []
        with full_float32():
            for i in range(0, len(images_u8), self.batch_size):
                x = torch.from_numpy(np.ascontiguousarray(images_u8[i : i + self.batch_size]))
                x = x.to(device).float() / 127.5 - 1.0
                f, p = self._forward(x, weights)
                feats.append(f.cpu().numpy())
                probs.append(p.cpu().numpy())
        return np.concatenate(feats), np.concatenate(probs)

    def features(self, images_u8: np.ndarray) -> np.ndarray:
        return self._run(images_u8)[0]

    def logits(self, images_u8: np.ndarray) -> np.ndarray:
        return self._run(images_u8)[1]


def InceptionV3Features(weights_path: str, batch_size: int = 64, device: str = "cuda"):
    """Published-number-comparable extractor: the FID-Inception network.

    Point ``weights_path`` at a local torchvision ``inception_v3`` /
    torch-fidelity ``pt_inception`` state dict (``.pt``) or a converted
    ``.npz``. Raises ``FileNotFoundError`` with instructions when absent; use
    :class:`RandomFeatures` for offline relative comparisons. See
    ``eval_inception.py``.
    """
    from aliasfree_diffusion_models_pytorch_tpu_torch.eval_inception import InceptionV3Torch

    return InceptionV3Torch(weights_path, batch_size=batch_size, device=device)


# ---------------------------------------------------------------------------
# Folder-level protocol
# ---------------------------------------------------------------------------


def _load_folder(path: str, limit: int | None = None) -> np.ndarray:
    from PIL import Image

    files = sorted(
        (f for f in os.listdir(path) if f.lower().endswith(".png")),
        key=lambda s: int("".join(ch for ch in s if ch.isdigit()) or 0),
    )
    if limit:
        files = files[:limit]
    imgs = []
    for f in files:
        arr = np.asarray(Image.open(os.path.join(path, f)))
        if arr.ndim == 2:
            arr = arr[:, :, None]
        imgs.append(arr)
    return np.stack(imgs)


def calculate_metrics(
    images1: np.ndarray,
    images2: np.ndarray,
    extractor: FeatureExtractor | None = None,
    *,
    isc: bool = True,
    compute_fid: bool = True,
    compute_kid: bool = True,
    device: str = "cuda",
) -> dict:
    """torch-fidelity-shaped metric dict from two uint8 NHWC image sets
    (input1 = generated, input2 = reference). Without an ``extractor`` it is
    :class:`RandomFeatures` on ``device``."""
    extractor = extractor or RandomFeatures(device=device)
    out: dict = {"feature_space": extractor.name}
    f1 = extractor.features(images1)
    f2 = extractor.features(images2)
    if isc:
        m, s = inception_score(extractor.logits(images1))
        out["inception_score_mean"] = m
        out["inception_score_std"] = s
    if compute_fid:
        out["frechet_inception_distance"] = fid(f1, f2)
    if compute_kid:
        m, s = kid(f1, f2)
        out["kernel_inception_distance_mean"] = m
        out["kernel_inception_distance_std"] = s
    return out


def evaluate_folders(
    generated_dir: str,
    reference_dir: str,
    extractor: FeatureExtractor | None = None,
    *,
    limit: int | None = None,
    save_path: str | None = None,
    device: str = "cuda",
) -> dict:
    """Folder-based protocol: generated PNGs against the training-set PNGs;
    with ``save_path`` writes the metrics as ``key: value`` text and as a
    ``.json`` beside it."""
    m = calculate_metrics(
        _load_folder(generated_dir, limit), _load_folder(reference_dir, limit),
        extractor, device=device,
    )
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        with open(save_path, "w") as f:
            f.write("\n".join(f"{k}: {v}" for k, v in m.items()))
        with open(os.path.splitext(save_path)[0] + ".json", "w") as f:
            json.dump(m, f, indent=2)
    return m
