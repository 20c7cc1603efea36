"""Deterministic synthetic token stream, bit-exact with the JAX package's
``TokenDataset`` under jax 0.9.

:class:`TokenDataset` is an infinite, offset-addressable LM token stream
with a learnable structure (Zipf-distributed unigrams + a Markov kick), so
training losses actually decrease. Sample row ``i`` is a pure function of
``(seed, i)``, not of any batch index, so ``batch(offset, b)`` gives rows
``offset..offset+b`` identically under any batch partitioning.

The JAX package draws a row with ``jax.random`` (threefry2x32,
``jax_threefry_partitionable`` on, the default since jax 0.5). This module
computes the same bits in numpy: ``key(seed) = (0, seed)``;
``fold_in(key, d) = threefry(key, (0, d))``; ``uniform(key, (n,))`` takes
``bits[i] = x0 ^ x1`` of ``threefry(key, (0, i))``, keeps the top 23 bits
as the mantissa of a float in [1, 2) and subtracts 1; ``bernoulli(key, p)``
is ``uniform(key) < p`` in f32.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counts (x0, x1) under key
    (k0, k1), elementwise over broadcast uint32 arrays."""
    k0, k1, x0, x1 = (np.asarray(a, dtype=np.uint32) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int):
    return np.uint32(0), np.uint32(seed & 0xFFFFFFFF)


def fold_in(k, data):
    """``jax.random.fold_in`` of (arrays of) keys and data."""
    return threefry2x32(k[0], k[1], np.zeros_like(data, dtype=np.uint32),
                        np.asarray(data).astype(np.uint32))


def uniform(k, n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,))`` in f32; keys (K,) give (K, n)."""
    k0, k1 = (np.asarray(x, dtype=np.uint32)[..., None] for x in k)
    counts = np.arange(n, dtype=np.uint32)
    y0, y1 = threefry2x32(k0, k1, np.zeros_like(counts), counts)
    bits = ((y0 ^ y1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


@dataclass(frozen=True)
class TokenDataset:
    vocab_size: int
    seq_len: int
    seed: int = 0

    def sample(self, index) -> np.ndarray:
        """Row ``index`` of the stream: (S+1,) int32, pure in (seed, index)."""
        return self._rows(np.asarray([index]))[0]

    def _rows(self, idx: np.ndarray) -> np.ndarray:
        s = self.seq_len + 1
        k = fold_in(key(self.seed), idx)
        u = uniform(k, s)
        base = (np.square(u) * np.float32(self.vocab_size)).astype(np.int32)
        rolled = np.roll(base, 1, axis=-1)
        motif = (rolled * 31 + 7) % self.vocab_size
        pick = uniform(fold_in(k, np.ones_like(idx)), s) < np.float32(0.25)
        return np.where(pick, motif, base).astype(np.int32)

    def batch(self, offset: int, batch_size: int) -> dict:
        """Rows ``offset .. offset+batch_size``: tokens (B, S+1) int32 numpy
        (inputs + shifted labels), keyed by sample offset, so
        ``batch(0, 8)["tokens"][4:]`` equals ``batch(4, 4)["tokens"]``."""
        idx = offset + np.arange(batch_size, dtype=np.int64)
        return {"tokens": self._rows(idx)}
