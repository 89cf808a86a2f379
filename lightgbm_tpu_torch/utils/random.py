"""Deterministic host-side RNG helpers.

The reference carries a tiny xorshift ``Random`` (``include/LightGBM/utils/random.h``)
used for bagging / feature-fraction / sampling so results are reproducible across
platforms.  We standardise on ``numpy.random.Generator`` seeded per purpose, which
gives the same reproducibility guarantee (bit-identical given a seed) without
porting the exact bit stream.
"""
from __future__ import annotations

import numpy as np


def make_rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(seed & 0xFFFFFFFF))


def sample_k(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """Sample k distinct indices from [0, n) (reference Random::Sample)."""
    k = min(k, n)
    if k <= 0:
        return np.empty(0, dtype=np.int64)
    return np.sort(rng.choice(n, size=k, replace=False))
