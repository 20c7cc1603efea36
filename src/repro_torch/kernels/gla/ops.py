"""Public wrapper for chunked gated linear attention: (B, S, H, ·) layout,
any S, differentiable in every input. For CUDA tensors the forward and the
backward are the CUDA kernels (``kernel``); for CPU tensors they are the
plain versions (``ref``).

The CPU path exists for the tests, and is taken only because the tensors
lie on the CPU: a CUDA tensor launches its kernel or raises, with no
fallback. :data:`LAUNCHES` counts, per kernel, the launches since the last
:func:`reset_launches`; a count is raised where the kernel is launched and
nowhere else.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.gla import kernel, ref

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"gla_fwd": 0, "gla_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"gla runs on cuda (or its plain version on cpu), not {t.device}")


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


def forward(q, k, v, log_w, bonus_u=None, initial_state=None, *, include_current: bool,
            save_states: bool = False):
    """(y, final state, chunk-start states or None): the kernel for CUDA
    tensors (the states only with ``save_states``), the plain version for
    CPU ones (no states)."""
    if not _on_cuda(q):
        y, final = ref.gla_fwd_ref(q, k, v, log_w, bonus_u=bonus_u, include_current=include_current,
                                   initial_state=initial_state)
        return y, final, None
    out = kernel.gla_fwd(*_contiguous(q, k, v, log_w, bonus_u, initial_state),
                         include_current=include_current, save_states=save_states)
    LAUNCHES["gla_fwd"] += 1
    return out


def backward(q, k, v, log_w, bonus_u, initial_state, states, final, d_y, d_final, *,
             include_current: bool):
    """(dq, dk, dv, dlog_w, du, ds0): the kernel for CUDA tensors (from the
    forward's ``states`` and ``final``), autograd of the plain version for
    CPU ones. du is None without a bonus (or with ``include_current``), ds0
    without an initial state."""
    if not _on_cuda(q):
        return ref.gla_bwd_ref(q, k, v, log_w, bonus_u, initial_state, d_y, d_final,
                               include_current=include_current)
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
