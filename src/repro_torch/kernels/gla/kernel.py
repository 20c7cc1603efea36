"""Bind and launch the hand-written CUDA chunked-GLA kernels
(``csrc/gla.cu``), built and loaded by :mod:`repro_torch.kernels._cuda`.

The launchers take CUDA tensors only, in the (B, S, H, ·) layout with
K = V = 64, and check device, type, shape and contiguity; they allocate the
outputs and never fall back to the plain versions. ``ops`` adds the
autograd function, the launch counters and the CPU path.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._cuda import I, P, check, check_cuda, launch, register

CSRC = Path(__file__).resolve().parent / "csrc"
CHUNK = 64  # positions per chunk (kChunk in gla.cu)
DIM = 64    # K = V (kDim in gla.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
register("gla", CSRC / "gla.cu", {
    "gla_fwd": [P] * 9 + [I] * 5,
    "gla_bwd": [P] * 15 + [I] * 5,
})


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _checks(q, k, v, log_w, bonus_u, **more):
    tensors = dict(q=q, k=k, v=v, log_w=log_w, **more)
    if bonus_u is not None:
        tensors["bonus_u"] = bonus_u
    check_cuda(q.device, **{n: t for n, t in tensors.items() if t is not None})
    check(q.dtype in _DTYPE_CODES, f"q must be float32 or bfloat16, got {q.dtype}")
    check(k.dtype == q.dtype and v.dtype == q.dtype, f"k and v must be {q.dtype} like q")
    check(q.ndim == 4 and q.shape[-1] == DIM and v.shape[-1] == DIM,
          f"q, k, log_w must be (B, S, H, {DIM}) and v (B, S, H, {DIM}), got q {tuple(q.shape)}, "
          f"v {tuple(v.shape)}")
    check(k.shape == q.shape and log_w.shape == q.shape and v.shape == q.shape,
          "q, k, v and log_w must have one shape")
    check(log_w.dtype == torch.float32, f"log_w must be float32, got {log_w.dtype}")
    b, s, h, _ = q.shape
    check(s >= 1, "the sequence must not be empty")
    if bonus_u is not None:
        check(bonus_u.dtype == torch.float32 and bonus_u.shape == (h, DIM),
              f"bonus_u must be ({h}, {DIM}) float32")
    for name, t in more.items():
        if t is not None and name in ("initial_state", "d_final", "final"):
            check(t.dtype == torch.float32 and t.shape == (b, h, DIM, DIM),
                  f"{name} must be ({b}, {h}, {DIM}, {DIM}) float32")
    return b, s, h


def gla_fwd(q, k, v, log_w, bonus_u=None, initial_state=None, *, include_current: bool,
            save_states: bool = False):
    """Returns (y (B, S, H, V) in v's type, final state (B, H, K, V) f32,
    chunk-start states (B, H, chunks, K, V) f32 or None). ``bonus_u`` is
    read only when ``include_current`` is False, as in the TPU kernel."""
    if include_current:
        bonus_u = None
    b, s, h = _checks(q, k, v, log_w, bonus_u, initial_state=initial_state)
    y = torch.empty_like(v)
    final = torch.empty((b, h, DIM, DIM), dtype=torch.float32, device=q.device)
    chunks = -(-s // CHUNK)
    states = (torch.empty((b, h, chunks, DIM, DIM), dtype=torch.float32, device=q.device)
              if save_states else None)
    launch(
        "gla", "gla_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), _ptr(bonus_u),
        _ptr(initial_state), y.data_ptr(), final.data_ptr(), _ptr(states),
        b, s, h, _DTYPE_CODES[q.dtype], int(include_current),
    )
    return y, final, states


def gla_bwd(q, k, v, log_w, bonus_u, states, final, d_y, d_final=None, *, include_current: bool,
            with_ds0: bool = False):
    """Gradients of :func:`gla_fwd` from its ``states`` and ``final``.
    Returns (dq, dk, dv in the inputs' type, dlog_w f32, du (H, K) f32 or
    None, ds0 (B, H, K, V) f32, or None unless ``with_ds0``)."""
    if include_current:
        bonus_u = None
    b, s, h = _checks(q, k, v, log_w, bonus_u, d_y=d_y, states=states, final=final,
                      d_final=d_final)
    check(d_y.dtype == v.dtype and d_y.shape == v.shape, "d_y must have v's type and shape")
    check(states.shape == (b, h, -(-s // CHUNK), DIM, DIM) and states.dtype == torch.float32,
          "states must be the forward's chunk-start states")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dlog_w = torch.empty_like(log_w)
    du_part = (torch.empty((b, h, DIM), dtype=torch.float32, device=q.device)
               if bonus_u is not None else None)
    ds0 = torch.empty((b, h, DIM, DIM), dtype=torch.float32, device=q.device) if with_ds0 else None
    launch(
        "gla", "gla_bwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), _ptr(bonus_u), d_y.data_ptr(),
        states.data_ptr(), final.data_ptr(), _ptr(d_final), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dlog_w.data_ptr(), _ptr(du_part), _ptr(ds0),
        b, s, h, _DTYPE_CODES[q.dtype], int(include_current),
    )
    du = None if du_part is None else du_part.sum(dim=0)  # over the batch, one fixed order
    return dq, dk, dv, dlog_w, du, ds0
