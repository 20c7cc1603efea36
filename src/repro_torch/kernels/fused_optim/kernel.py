"""Bind and launch the hand-written CUDA fused optimizer updates
(``csrc/fused_optim.cu``), built and loaded by
:mod:`repro_torch.kernels._cuda`.

Each launcher takes lists of leaves (one entry per parameter: the
parameter, its gradient and its optimizer state), checks that they are f32,
contiguous, of matching sizes and on one CUDA device, uploads the table of
pointers, element counts and first blocks that the kernel walks, and
updates the parameters and the state in place with one launch. It never
falls back to the plain versions; ``ops`` adds the launch counters and the
CPU path.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels._cuda import F, I, P, check, check_cuda, launch, register

CSRC = Path(__file__).resolve().parent / "csrc"
CHUNK = 2048  # elements per block (kChunk in fused_optim.cu)
_L = ctypes.c_int64
register("fused_optim", CSRC / "fused_optim.cu", {
    "fused_psgd": [P, I, _L, F, F, F],
    "fused_momentum": [P, I, _L, F, F],
    "fused_adagrad_da": [P, I, _L, F, F, F],
})


def _table(arrays: Sequence[Sequence[torch.Tensor]]):
    """The device table of ``arrays`` (each a list of leaves, all lists of
    one length), leaf-major, empty leaves left out. Returns (table, leaves,
    blocks, device)."""
    n = len(arrays[0])
    check(n > 0 and all(len(a) == n for a in arrays), "every list needs one entry per leaf")
    device = arrays[0][0].device
    ptrs, counts, firsts = [], [], []
    blocks = 0
    for i in range(n):
        leaf = [a[i] for a in arrays]
        check_cuda(device, **{f"array {j} leaf {i}": t for j, t in enumerate(leaf)})
        for j, t in enumerate(leaf):
            check(t.dtype == torch.float32, f"array {j} leaf {i} must be float32, got {t.dtype}")
            check(t.numel() == leaf[0].numel(), f"leaf {i}: sizes differ across the arrays")
        if leaf[0].numel() == 0:
            continue
        ptrs.extend(t.data_ptr() for t in leaf)
        counts.append(leaf[0].numel())
        firsts.append(blocks)
        blocks += -(-leaf[0].numel() // CHUNK)
    host = np.array(ptrs + counts + firsts + [blocks], dtype=np.uint64).view(np.int64)
    return torch.from_numpy(host).to(device), len(counts), blocks, device


def psgd_(params, grads, anchors, *, lr: float, gamma: float, denom: float) -> None:
    """w <- (gamma (w - lr g) + lr a) / denom, denom = gamma + lr in f32."""
    table, leaves, blocks, device = _table([params, grads, anchors])
    if leaves:
        launch("fused_optim", "fused_psgd", device, table.data_ptr(), leaves, blocks, lr, gamma, denom)


def momentum_(params, grads, us, *, lr: float, beta: float) -> None:
    """u <- beta u - lr g; w <- w + u."""
    table, leaves, blocks, device = _table([params, grads, us])
    if leaves:
        launch("fused_optim", "fused_momentum", device, table.data_ptr(), leaves, blocks, lr, beta)


def adagrad_da_(params, grads, anchors, zs, s2s, *, lr: float, delta2: float, nu: float) -> None:
    """z <- z + g; s2 <- s2 + g^2; w <- a - lr z / (delta2 + s2)^nu."""
    table, leaves, blocks, device = _table([params, grads, anchors, zs, s2s])
    if leaves:
        launch("fused_optim", "fused_adagrad_da", device, table.data_ptr(), leaves, blocks,
               lr, delta2, nu)
