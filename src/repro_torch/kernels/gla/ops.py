"""Public wrapper for chunked gated linear attention: (B, S, H, ·) layout,
any S, differentiable in every input. For CUDA tensors the forward and the
backward are the CUDA kernels (``kernel``); for CPU tensors they are the
plain versions (``ref``); for meta tensors (the dry run) they allocate the
kernels' outputs and scratch and compute nothing. Each call reports
:func:`cost` to the active counters (``kernels/accounting.py``).

The CPU path exists for the tests, and is taken only because the tensors
lie on the CPU: a CUDA tensor launches its kernel or raises, with no
fallback. :data:`LAUNCHES` counts, per kernel, the launches since the last
:func:`reset_launches`; a count is raised where the kernel is launched and
nowhere else.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.accounting import kernel_region
from repro_torch.kernels.gla import kernel, ref

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"gla_fwd": 0, "gla_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cuda", "cpu", "meta"):
        return t.device.type
    raise ValueError(f"gla runs on cuda (or its plain version on cpu, its count on meta), not {t.device}")


def _contiguous(*tensors):
    """Contiguous, and 16-byte aligned (a view may start anywhere; the bf16
    kernels load rows 16 bytes at a time)."""
    out = []
    for t in tensors:
        if t is not None:
            t = t.contiguous()
            if t.data_ptr() % 16:
                t = t.clone()
        out.append(t)
    return out


def products(s: int, kdim: int = kernel.DIM, vdim: int = kernel.DIM, backward: bool = False) -> int:
    """Multiply-adds x 2 of the chunked form's matrix products for one
    (batch, head) over S positions, in chunks of the kernels' 64 (the last
    as long as it is): forward A (L L K), A v (L L V), q S and k^T v (L K V
    each); the backward recomputes A and adds dA, A^T dy, dq and dk's
    pairwise (L L K each, L L V for the two with V) and four L K V products."""
    total = 0
    for t0 in range(0, s, kernel.CHUNK):
        n = min(kernel.CHUNK, s - t0)
        if backward:
            total += 2 * (3 * n * n * kdim + 2 * n * n * vdim + 4 * n * kdim * vdim)
        else:
            total += 2 * (n * n * kdim + n * n * vdim + 2 * n * kdim * vdim)
    return total


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def cost(q, k, v, log_w, bonus_u=None, initial_state=None, *, backward: bool = False,
         d_final=None) -> Tuple[float, float]:
    """(operations, bytes) of one call, from the shapes alone: B H
    :func:`products`; the forward reads q, k, v, log_w, the bonus and the
    initial state and writes y and the f32 final state; the backward reads
    q, k, v, dy, log_w, the bonus, the initial state and d_final and writes
    their gradients. The bounds of ``chip_smoke.py``'s kernel table are
    these counts over the card's rates."""
    b, s, h, kdim = q.shape
    ops = float(b * h * products(s, kdim, v.shape[-1], backward))
    if backward:
        return ops, float(_nbytes(q, k, v, v, log_w, bonus_u, initial_state, d_final)
                          + _nbytes(q, k, v, log_w, bonus_u, initial_state))
    return ops, float(_nbytes(q, k, v, log_w, bonus_u, initial_state) + _nbytes(v) + 4 * b * h * kdim * v.shape[-1])


def _meta_forward(q, v, save_states: bool):
    """The forward kernel's outputs and scratch, unwritten (kernel.gla_fwd's allocations)."""
    b, s, h, kdim = q.shape
    chunks = -(-s // kernel.CHUNK)
    y = torch.empty_like(v)
    final = q.new_empty((b, h, kdim, v.shape[-1]), dtype=torch.float32)
    tc = q.dtype == torch.bfloat16
    states = (q.new_empty((b, h, chunks, kernel.TC_SLOT), dtype=torch.float32) if tc else
              q.new_empty((b, h, chunks, kdim, v.shape[-1]), dtype=torch.float32) if save_states else None)
    wq = q.new_empty((b, h, chunks, kdim), dtype=torch.float32) if tc else None
    del wq
    return y, final, states if save_states else None


def _meta_backward(q, k, v, log_w, bonus_u, initial_state, include_current: bool):
    """The backward kernel's gradients and scratch, unwritten (kernel.gla_bwd's allocations)."""
    b, s, h, kdim = q.shape
    if include_current:
        bonus_u = None
    chunks = -(-s // kernel.CHUNK)
    dq, dk, dv, dlog_w = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), torch.empty_like(log_w)
    du = q.new_empty((h, kdim), dtype=torch.float32) if bonus_u is not None else None
    ds0 = q.new_empty((b, h, kdim, kdim), dtype=torch.float32) if initial_state is not None else None
    slots = b * h * chunks if q.dtype == torch.bfloat16 else 0
    parts = (slots if slots else b * h) * kdim if bonus_u is not None else 0
    scratch = q.new_empty(parts + slots * (kdim * kdim + 2 * kdim), dtype=torch.float32)
    del scratch
    return dq, dk, dv, dlog_w, du, ds0


def forward(q, k, v, log_w, bonus_u=None, initial_state=None, *, include_current: bool,
            save_states: bool = False):
    """(y, final state, chunk-start states or None): the kernel for CUDA
    tensors (the states only with ``save_states``), the plain version for
    CPU ones (no states), the kernel's outputs unwritten for meta ones."""
    route = _route(q)
    u = None if include_current else bonus_u
    with kernel_region("gla_fwd", *cost(q, k, v, log_w, u, initial_state), (q, k, v, log_w, u, initial_state)):
        if route == "cpu":
            y, final = ref.gla_fwd_ref(q, k, v, log_w, bonus_u=bonus_u, include_current=include_current,
                                       initial_state=initial_state)
            return y, final, None
        if route == "meta":
            return _meta_forward(q, v, save_states)
        out = kernel.gla_fwd(*_contiguous(q, k, v, log_w, bonus_u, initial_state),
                             include_current=include_current, save_states=save_states)
    LAUNCHES["gla_fwd"] += 1
    return out


def backward(q, k, v, log_w, bonus_u, initial_state, states, final, d_y, d_final, *,
             include_current: bool):
    """(dq, dk, dv, dlog_w, du, ds0): the kernel for CUDA tensors (from the
    forward's ``states`` and ``final``), autograd of the plain version for
    CPU ones, the kernel's gradients unwritten for meta ones. du is None
    without a bonus (or with ``include_current``), ds0 without an initial
    state."""
    route = _route(q)
    u = None if include_current else bonus_u
    with kernel_region("gla_bwd", *cost(q, k, v, log_w, u, initial_state, backward=True, d_final=d_final),
                       (q, k, v, log_w, u, initial_state, d_y, d_final)):
        if route == "cpu":
            return ref.gla_bwd_ref(q, k, v, log_w, bonus_u, initial_state, d_y, d_final,
                                   include_current=include_current)
        if route == "meta":
            return _meta_backward(q, k, v, log_w, bonus_u, initial_state, include_current)
        grads = kernel.gla_bwd(*_contiguous(q, k, v, log_w, bonus_u, states, final, d_y, d_final),
                               include_current=include_current, with_ds0=initial_state is not None)
    LAUNCHES["gla_bwd"] += 1
    return grads


class GLA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, log_w, bonus_u, initial_state, include_current):
        save = any(ctx.needs_input_grad)
        y, final, states = forward(q, k, v, log_w, bonus_u, initial_state,
                                   include_current=include_current, save_states=save)
        if save:
            ctx.save_for_backward(q, k, v, log_w, bonus_u, initial_state, states, final)
        ctx.include_current = include_current
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, d_y, d_final):
        q, k, v, log_w, bonus_u, initial_state, states, final = ctx.saved_tensors
        if d_y is None:
            d_y = torch.zeros_like(v)
        dq, dk, dv, dlog_w, du, ds0 = backward(
            q, k, v, log_w, bonus_u, initial_state, states, final, d_y, d_final,
            include_current=ctx.include_current)
        if bonus_u is None:
            du = None
        elif du is None:  # the bonus is not read with include_current
            du = torch.zeros_like(bonus_u)
        return dq, dk, dv, dlog_w, du, ds0, None


def gla_chunked(
    q: torch.Tensor,       # (B, S, H, K)
    k: torch.Tensor,       # (B, S, H, K)
    v: torch.Tensor,       # (B, S, H, V)
    log_w: torch.Tensor,   # (B, S, H, K) f32, <= 0
    *,
    bonus_u: Optional[torch.Tensor] = None,        # (H, K) f32
    include_current: bool = True,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, K, V) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated linear attention over any S. Returns (y (B, S, H, V) in v's
    type, final state (B, H, K, V) f32), both differentiable. The JAX
    package's ``gla_chunked`` with its TPU grid knobs (``chunk``,
    ``interpret``) left out: the kernel's chunk is 64 positions."""
    return GLA.apply(q, k, v, log_w, bonus_u, initial_state, include_current)
