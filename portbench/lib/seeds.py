"""Sub-seeds of ``--seed``: one stream a purpose, each a whole number that
every consumer takes (63 bits for torch generators, 31 bits where the port
packs a seed into a larger one: ``train.step_generator`` shifts the seed by
32 bits into a 64-bit Philox seed)."""

from __future__ import annotations

import hashlib


def derive(seed: int, purpose: str, bits: int = 63) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> (64 - bits)
