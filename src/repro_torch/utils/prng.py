"""PRNG helpers: deterministic named key derivation, the JAX package's
``utils/prng.py`` over the port's threefry (``data/synthetic.py``), whose
keys are ``(k0, k1)`` pairs of uint32 with the bits of
``jax.random.key_data``.

Initialization that derives keys by *name* rather than by split order
(``models/vision.py``) gives every layer the same key whatever else the
model holds."""
from __future__ import annotations

import hashlib
from typing import Iterator, Tuple

import numpy as np

from repro_torch.data.synthetic import fold_in, split

Key = Tuple[np.uint32, np.uint32]


def fold_in_name(key: Key, name: str) -> Key:
    """Derive a subkey deterministically from a string name: ``fold_in`` of
    the first four bytes (little-endian) of the name's SHA-256."""
    digest = hashlib.sha256(name.encode("utf-8")).digest()
    return fold_in(key, int.from_bytes(digest[:4], "little"))


def key_iter(key: Key) -> Iterator[Key]:
    """Infinite iterator of fresh subkeys: ``key, sub = split(key)`` each time."""
    while True:
        k0, k1 = split(key, 2)
        key, sub = (k0[0], k1[0]), (k0[1], k1[1])
        yield sub
