"""``jax.random``'s Threefry-2x32 streams in numpy: ``key``, ``split``, ``normal``.

The port carries a few seeded weight tensors over from the JAX package (the
random conv stack of ``eval.RandomFeatures``), whose values come from
``jax.random``. This module reproduces those draws without JAX:

* :func:`key` — ``jax.random.key(seed)`` for a seed in [0, 2^32): the words
  (0, seed), as JAX builds them with 64-bit types off (its default);
* :func:`split` — ``jax.random.split(key, num)`` in the *partitionable*
  Threefry layout (``jax_threefry_partitionable=True``, the default of
  current JAX): child i is the block ``threefry2x32(key, (0, i))``;
* :func:`normal` — ``jax.random.normal(key, shape)`` in float32: one 32-bit
  word per element (the two output words of the block at the element's
  row-major index, xor-ed), its top 23 bits as the mantissa of a float in
  [1, 2), mapped to (−1, 1), then ``√2·erfinv(u)``.

The bits are equal to JAX's. ``erfinv`` is the float32 polynomial pair that
XLA evaluates (Giles' single-precision approximation, the same
coefficients), in numpy float32 arithmetic: about 95% of the normals are
bit-equal to JAX's on the CPU and the rest within a few float32 ulps (XLA may
contract a multiply-add that numpy rounds twice).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k0, k1, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher, 20 rounds: key words ``k0, k1``, counter
    words ``x0, x1`` (uint32 arrays of one shape) → two uint32 arrays."""
    k0, k1 = np.uint32(k0), np.uint32(k1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data for ``0 <= seed < 2**32``: ``[0, seed]``."""
    seed = int(seed)
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return np.array([0, seed], dtype=np.uint32)


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 child keys."""
    hi, lo = _counters(num)
    b0, b1 = threefry2x32(k[0], k[1], hi, lo)
    return np.stack([b0, b1], axis=-1)


def bits(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    n = int(np.prod(shape, dtype=np.int64))
    hi, lo = _counters(n)
    b0, b1 = threefry2x32(k[0], k[1], hi, lo)
    return (b0 ^ b1).reshape(shape)


# XLA's float32 erf_inv: p(w − 2.5) for w = −log1p(−x²) < 5, else q(√w − 3),
# times x; coefficients from the highest power down.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _horner32(coefs, w: np.ndarray) -> np.ndarray:
    p = np.full_like(w, np.float32(coefs[0]))
    for c in coefs[1:]:
        p = np.float32(c) + p * w
    return p


def erfinv32(x: np.ndarray) -> np.ndarray:
    """erf⁻¹ on float32 in (−1, 1), by XLA's float32 polynomials."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p(-(x * x))).astype(np.float32)
    small = _horner32(_ERFINV_SMALL, w - np.float32(2.5))
    large = _horner32(_ERFINV_LARGE, np.sqrt(w) - np.float32(3.0))
    return np.where(w < np.float32(5.0), small, large) * x


def normal(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` (float32)."""
    one = np.float32(1.0).view(np.uint32)
    floats = ((bits(k, shape) >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    span = np.float32(1.0) - lo  # rounds to 2.0 in float32, as it does in JAX
    u = np.maximum(lo, floats * span + lo)
    return np.float32(np.sqrt(2.0)) * erfinv32(u)
