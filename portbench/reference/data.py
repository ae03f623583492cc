"""The order in which a shuffling loader walks a dataset: a splitmix64
Fisher-Yates permutation, fixed by the loader's seed and the epoch.

Stream k (k = 0 … n−2) is ``s0 + (k + 1)·GOLDEN`` with
``s0 = seed·GOLDEN + epoch + 0xD1B54A32D192ED03`` (mod 2⁶⁴), mixed by
splitmix64's finaliser; swap k exchanges places i = n−1−k and
``stream_k mod (i + 1)``. Batches are consecutive runs of that order, the
last one short.
"""

from __future__ import annotations

import numpy as np

GOLDEN = np.uint64(0x9E3779B97F4A7C15)
MIX1 = np.uint64(0xBF58476D1CE4E5B9)
MIX2 = np.uint64(0x94D049BB133111EB)
EPOCH_OFFSET = np.uint64(0xD1B54A32D192ED03)


def permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    out = np.arange(n, dtype=np.int64)
    if n <= 1:
        return out
    with np.errstate(over="ignore"):
        s0 = np.uint64(seed) * GOLDEN + np.uint64(epoch) + EPOCH_OFFSET
        z = s0 + np.arange(1, n, dtype=np.uint64) * GOLDEN
        z = (z ^ (z >> np.uint64(30))) * MIX1
        z = (z ^ (z >> np.uint64(27))) * MIX2
        z ^= z >> np.uint64(31)
    js = (z % np.arange(n, 1, -1, dtype=np.uint64)).astype(np.int64)
    for k in range(n - 1):
        i, j = n - 1 - k, js[k]
        out[i], out[j] = out[j], out[i]
    return out

