"""Paged-attention and sampler inputs made with numpy from a seed, shared by
the port's kernel tests (this module imports numpy only, so the tests that
run on the card, where JAX is not installed, can use it)."""
import math

import numpy as np


def paged_setup(seed, *, slots, ps, mp, hkv, d, share=False, poison=False):
    """Random pools + per-slot tables, as numpy. positions[b] is the slot's
    decode write position; with ``share`` every odd slot aliases slot 0's
    first page; with ``poison`` scratch page 0 holds 1e4."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + slots * mp
    k = rng.normal(size=(num_pages, ps, hkv, d)).astype(np.float32)
    v = rng.normal(size=(num_pages, ps, hkv, d)).astype(np.float32)
    if poison:
        k[0], v[0] = 1e4, 1e4
    lengths = rng.integers(1, mp * ps + 1, size=slots)
    table = np.zeros((slots, mp), np.int32)
    nxt = 1
    for b in range(slots):
        n = math.ceil(int(lengths[b]) / ps)
        table[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    if share and slots > 1:
        table[1::2, 0] = table[0, 0]
    return k, v, table, (lengths - 1).astype(np.int32)


def sampler_inputs(seed, b, v, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, v)).astype(np.float32) * 4
    if ties:
        logits = rng.integers(0, 4, size=(b, v)).astype(np.float32)  # many exact ties
    temp = rng.choice([0.0, 0.3, 0.7, 1.0, 1.5], b).astype(np.float32)
    top_k = rng.choice([0, 1, 2, 5, v, v + 7], b).astype(np.int32)
    return logits, temp, top_k
