"""Bind and launch the hand-written CUDA chunked-GLA kernels
(``csrc/gla.cu``), built and loaded by :mod:`repro_torch.kernels._cuda`.

The launchers take CUDA tensors only, in the (B, S, H, ·) layout with
K = V = 64, and check device, type, shape, contiguity and alignment; they
allocate the outputs and the scratch, and never fall back to the plain
versions. The C functions choose the route by type: bf16 runs the
chunk-parallel passes on the tensor cores, f32 the CUDA-core kernels. One
C call launches all of a direction's passes. ``ops`` adds the autograd
function, the launch counters and the CPU path.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._cuda import I, P, check, check_cuda, launch, register

CSRC = Path(__file__).resolve().parent / "csrc"
CHUNK = 64  # positions per chunk (kChunk in gla.cu)
DIM = 64    # K = V (kDim in gla.cu)
# a chunk's slot of the bf16 route's states (kSlot in gla.cu): its start state,
# then the forward's A (CHUNK x CHUNK) for the backward
TC_SLOT = DIM * DIM + CHUNK * CHUNK
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
register("gla", CSRC / "gla.cu", {
    "gla_fwd": [P] * 10 + [I] * 5,
    "gla_bwd": [P] * 19 + [I] * 5,
})


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _checks(q, k, v, log_w, bonus_u, **more):
    # messages are made only on failure: these checks run on every launch
    tensors = dict(q=q, k=k, v=v, log_w=log_w, **more)
    if bonus_u is not None:
        tensors["bonus_u"] = bonus_u
    check_cuda(q.device, **{n: t for n, t in tensors.items() if t is not None})
    check(q.dtype in _DTYPE_CODES, lambda: f"q must be float32 or bfloat16, got {q.dtype}")
    check(k.dtype == q.dtype and v.dtype == q.dtype, lambda: f"k and v must be {q.dtype} like q")
    check(q.ndim == 4 and q.shape[-1] == DIM and v.shape[-1] == DIM,
          lambda: f"q, k, log_w must be (B, S, H, {DIM}) and v (B, S, H, {DIM}), got q "
                  f"{tuple(q.shape)}, v {tuple(v.shape)}")
    check(k.shape == q.shape and log_w.shape == q.shape and v.shape == q.shape,
          "q, k, v and log_w must have one shape")
    check(log_w.dtype == torch.float32, lambda: f"log_w must be float32, got {log_w.dtype}")
    b, s, h, _ = q.shape
    check(s >= 1, "the sequence must not be empty")
    if q.dtype == torch.bfloat16:  # the tensor-core passes load rows 16 bytes at a time
        for name in ("q", "k", "v", "d_y"):
            t = tensors.get(name)
            check(t is None or t.data_ptr() % 16 == 0, lambda: f"{name} must be 16-byte aligned")
    if bonus_u is not None:
        check(bonus_u.dtype == torch.float32 and bonus_u.shape == (h, DIM),
              lambda: f"bonus_u must be ({h}, {DIM}) float32")
    for name, t in more.items():
        if t is not None and name in ("initial_state", "d_final", "final"):
            check(t.dtype == torch.float32 and t.shape == (b, h, DIM, DIM),
                  lambda: f"{name} must be ({b}, {h}, {DIM}, {DIM}) float32")
    return b, s, h


def _f32(*shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def gla_fwd(q, k, v, log_w, bonus_u=None, initial_state=None, *, include_current: bool,
            save_states: bool = False):
    """Returns (y (B, S, H, V) in v's type, final state (B, H, K, V) f32,
    the saved states for :func:`gla_bwd` or None). ``bonus_u`` is read only
    when ``include_current`` is False, as in the TPU kernel. The saved
    states are the chunk-start states, (B, H, chunks, K, V) f32 on the f32
    route, and on the bf16 route (B, H, chunks, TC_SLOT) f32: each chunk's
    start state followed by its intra-chunk scores A. The bf16 passes
    always write them (the output pass reads them); they are returned with
    ``save_states``."""
    if include_current:
        bonus_u = None
    b, s, h = _checks(q, k, v, log_w, bonus_u, initial_state=initial_state)
    y = torch.empty_like(v)
    final = _f32(b, h, DIM, DIM, device=q.device)
    chunks = -(-s // CHUNK)
    tc = q.dtype == torch.bfloat16
    states = (_f32(b, h, chunks, TC_SLOT, device=q.device) if tc else
              _f32(b, h, chunks, DIM, DIM, device=q.device) if save_states else None)
    wq = _f32(b, h, chunks, DIM, device=q.device) if tc else None
    launch(
        "gla", "gla_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), _ptr(bonus_u),
        _ptr(initial_state), y.data_ptr(), final.data_ptr(), _ptr(states), _ptr(wq),
        b, s, h, _DTYPE_CODES[q.dtype], int(include_current),
    )
    return y, final, states if save_states else None


def gla_bwd(q, k, v, log_w, bonus_u, states, final, d_y, d_final=None, *, include_current: bool,
            with_ds0: bool = False):
    """Gradients of :func:`gla_fwd` from its saved ``states`` and ``final``.
    Returns (dq, dk, dv in the inputs' type, dlog_w f32, du (H, K) f32 or
    None, ds0 (B, H, K, V) f32, or None unless ``with_ds0``)."""
    if include_current:
        bonus_u = None
    b, s, h = _checks(q, k, v, log_w, bonus_u, d_y=d_y, states=states, final=final,
                      d_final=d_final)
    chunks = -(-s // CHUNK)
    check(d_y.dtype == v.dtype and d_y.shape == v.shape, "d_y must have v's type and shape")
    tc = q.dtype == torch.bfloat16
    check(states.shape == ((b, h, chunks, TC_SLOT) if tc else (b, h, chunks, DIM, DIM))
          and states.dtype == torch.float32, "states must be the forward's saved states")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dlog_w = torch.empty_like(log_w)
    du = _f32(h, DIM, device=q.device) if bonus_u is not None else None
    ds0 = _f32(b, h, DIM, DIM, device=q.device) if with_ds0 else None
    # scratch, one allocation: du's partials, one per (batch, head) or, on the bf16
    # route, per (batch, head, chunk), which the C call sums in a fixed order; then
    # the bf16 route's dS slots, W_Q and dW_Q (floats a chunk: DIM * DIM, DIM, DIM)
    slots = b * h * chunks if tc else 0
    parts = (slots if tc else b * h) * DIM if bonus_u is not None else 0
    scratch = _f32(parts + slots * (DIM * DIM + 2 * DIM), device=q.device)
    base = scratch.data_ptr()
    ds_slots = base + 4 * parts
    launch(
        "gla", "gla_bwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), _ptr(bonus_u), d_y.data_ptr(),
        states.data_ptr(), final.data_ptr(), _ptr(d_final), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dlog_w.data_ptr(), base if parts else None, _ptr(du), _ptr(ds0),
        *((ds_slots, ds_slots + 4 * slots * DIM * DIM, ds_slots + 4 * slots * (DIM * DIM + DIM))
          if tc else (None, None, None)),
        b, s, h, _DTYPE_CODES[q.dtype], int(include_current),
    )
    return dq, dk, dv, dlog_w, du, ds0
