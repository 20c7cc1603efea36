"""Deterministic synthetic data, equal to the JAX package's under jax 0.9:

- :class:`TokenDataset`, the LM token stream, bit for bit;
- :class:`QuadraticProblem`, the paper's synthetic problem (Eq. 11), whose
  data is numpy's and whose batches' indices equal
  ``jax.random.randint``'s bit for bit;
- :class:`ImageClassDataset`, CIFAR-shaped classification (the Fig. 3
  analog): labels and indices bit for bit, images within a few ulps (the
  normals' inverse error function, below).

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
is ``uniform(key) < p`` in f32. ``split(key, n)`` is ``threefry(key, (0,
i))`` for i < n (both words: the i-th key); ``random_bits`` of a shape is
``x0 ^ x1`` of ``threefry(key, (0, i))`` over the flat index i.
``randint(key, shape, lo, hi)`` splits the key in two, draws 32 bits with
each and folds them into the span in uint32 arithmetic, as
``jax.random.randint`` does. ``normal(key, shape)`` is ``sqrt(2) *
erfinv(u)`` with ``u`` uniform on ``[nextafter(-1, 0), 1)``; the inverse
error function is XLA's f32 polynomial (Giles'), with numpy's ``log1p``
where XLA has its own, so a normal can stand a few ulps from JAX's (the
tests state the bound).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counts (x0, x1) under key
    (k0, k1), elementwise over broadcast uint32 arrays."""
    k0, k1, x0, x1 = (np.asarray(a, dtype=np.uint32) for a in (k0, k1, x0, x1))
    shape = np.broadcast(k0, k1, x0, x1).shape
    # on 1-d arrays: numpy warns when a 0-d value wraps, and the hash wraps by design
    k0, k1, x0, x1 = (np.atleast_1d(a) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0.reshape(shape), x1.reshape(shape)


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


def split(k, num: int = 2):
    """``jax.random.split`` of (arrays of) keys: keys of shape
    ``k.shape + (num,)``."""
    k0, k1 = (np.asarray(x, dtype=np.uint32)[..., None] for x in k)
    counts = np.arange(num, dtype=np.uint32)
    return threefry2x32(k0, k1, np.zeros_like(counts), counts)


def unstack(keys):
    """The keys along the last axis of ``keys``, one (k0, k1) pair each."""
    return [(keys[0][..., i], keys[1][..., i]) for i in range(keys[0].shape[-1])]


def random_bits(k, shape) -> np.ndarray:
    """32 random bits of ``shape`` for each key of (arrays of) keys:
    ``k.shape + shape`` uint32."""
    shape = tuple(shape)
    k0, k1 = (np.asarray(x, dtype=np.uint32).reshape(np.shape(x) + (1,)) for x in k)
    counts = np.arange(int(np.prod(shape)), dtype=np.uint32)
    y0, y1 = threefry2x32(k0, k1, np.zeros_like(counts), counts)
    return (y0 ^ y1).reshape(np.shape(k[0]) + shape)


def randint(k, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) for each
    key of (arrays of) keys."""
    hi_key, lo_key = unstack(split(k))
    higher, lower = random_bits(hi_key, shape), random_bits(lo_key, shape)
    span = np.uint32(max(maxval - minval, 1))
    # (2^16 mod span)^2 wraps at 2^32 in XLA's uint32 product
    multiplier = np.uint32((2**16 % int(span)) ** 2 % 2**32 % int(span))
    offset = (higher % span) * multiplier + lower % span  # uint32, wrapping as XLA's does
    return (minval + (offset % span).astype(np.int64)).astype(np.int32)


# XLA's f32 inverse error function (xla/hlo/builder/lib/math.cc ErfInv32,
# chlo's erf_inv): a degree-8 polynomial in w = -log1p(-x^2) - 2.5 below 5,
# in sqrt(w) - 3 above
_ERFINV_LT5 = np.asarray([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                          -0.00125372503, -0.00417768164, 0.246640727, 1.50140941], dtype=np.float32)
_ERFINV_GE5 = np.asarray([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                          -0.0076224613, 0.00943887047, 1.00167406, 2.83297682], dtype=np.float32)


def erfinv(x: np.ndarray) -> np.ndarray:
    """The f32 inverse error function by XLA's polynomial."""
    x = np.asarray(x, dtype=np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, lo, hi).astype(np.float32) + p * w
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x).astype(np.float32)


_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def normal(k, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in f32 for each key of (arrays of)
    keys, within a few ulps (the module docstring)."""
    bits = random_bits(k, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    span = np.float32(1.0) - _NORMAL_LO  # 2.0 in f32, as XLA rounds it
    u = np.maximum(_NORMAL_LO, floats * span + _NORMAL_LO)
    return (np.float32(np.sqrt(2)) * erfinv(u)).astype(np.float32)


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


@dataclass(frozen=True)
class QuadraticProblem:
    """Paper Eq. (11): ``F(w) = (1/2n) Σ (w−ξᵢ)ᵀ D (w−ξᵢ)``, D = diag(1..d),
    ξᵢ ~ N(0, I) (numpy's, as in the JAX package). alpha=1, mu=1, L=d.
    ``loss``, ``full_loss`` and ``grad`` take tensors; ``sample_batch``
    draws a batch's rows on ``device``. The data is made once per
    instance (the JAX package remakes it at every use)."""

    n: int = 10_000
    d: int = 100
    seed: int = 42

    @functools.cached_property
    def data(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.standard_normal((self.n, self.d)).astype(np.float32)

    @property
    def diag(self) -> np.ndarray:
        return np.arange(1, self.d + 1, dtype=np.float32)

    @functools.cached_property
    def w_star(self) -> np.ndarray:
        return self.data.mean(axis=0)

    def loss(self, w: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        """Mean loss over a batch xi (B, d)."""
        diff = w[None, :] - xi
        diag = torch.from_numpy(self.diag).to(w.device)
        return 0.5 * torch.mean(torch.sum(diff * diff * diag[None, :], dim=-1))

    def full_loss(self, w: torch.Tensor) -> torch.Tensor:
        return self.loss(w, torch.from_numpy(self.data).to(w.device))

    def grad(self, w: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        """The loss's gradient in w: the batch mean of D (w − ξ)."""
        diag = torch.from_numpy(self.diag).to(w.device)
        return torch.mean((w[None, :] - xi) * diag[None, :], dim=0)

    def sample_indices(self, k, batch_size: int) -> np.ndarray:
        """The rows a batch takes: ``jax.random.randint(key, (b,), 0, n)``."""
        return randint(k, (batch_size,), 0, self.n)

    def sample_batch(self, k, batch_size: int, device="cuda") -> torch.Tensor:
        return torch.from_numpy(self.data[self.sample_indices(k, batch_size)]).to(device)

    # constants from the paper for this problem
    alpha: float = 1.0
    mu: float = 1.0

    @property
    def L(self) -> float:
        return float(self.d)


@dataclass(frozen=True)
class ImageClassDataset:
    """Synthetic CIFAR-shaped classification (paper Fig. 3 analog): each of
    ``num_classes`` classes is a fixed random spatial template; a sample is
    template + per-sample Gaussian noise. Finite train set of size ``n`` (so
    a generalization gap exists), infinite test stream from the same
    distribution. Batches are ``{"image": (B, H, W, C) f32, "label": (B,)
    int64}`` tensors on ``device``."""

    n: int = 20_000
    num_classes: int = 10
    image_size: int = 16
    channels: int = 3
    noise: float = 1.0
    seed: int = 0

    @functools.cached_property
    def _templates(self) -> np.ndarray:
        """The classes' templates, drawn once an instance."""
        return normal(key(self.seed), (self.num_classes, self.image_size, self.image_size, self.channels))

    def _examples(self, keys):
        """(images, labels) of a batch of keys (arrays of B)."""
        labels = randint(fold_in(keys, np.zeros_like(keys[0])), (), 0, self.num_classes)
        shape = (self.image_size, self.image_size, self.channels)
        noise = np.float32(self.noise) * normal(fold_in(keys, np.ones_like(keys[0])), shape)
        return self._templates[labels] + noise, labels

    def _batch(self, keys, device) -> dict:
        x, y = self._examples(keys)
        return {"image": torch.from_numpy(x).to(device), "label": torch.from_numpy(y.astype(np.int64)).to(device)}

    def train_batch(self, k, batch_size: int, device="cuda") -> dict:
        """Sample WITH replacement from the finite n-element train set."""
        idx = randint(k, (batch_size,), 0, self.n)
        return self._batch(fold_in(key(self.seed + 1), idx), device)

    def test_batch(self, k, batch_size: int, device="cuda") -> dict:
        return self._batch(split(fold_in(k, 999), batch_size), device)


def make_batch_iterator(ds: TokenDataset, batch_size: int, start: int = 0) -> Iterator[dict]:
    """Yield consecutive batches; ``start`` is a sample offset."""
    i = start
    while True:
        yield ds.batch(i, batch_size)
        i += batch_size
