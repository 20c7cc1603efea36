"""Bind and launch the hand-written CUDA flash-attention kernels
(``csrc/flash_attention.cu``), built and loaded by
:mod:`repro_torch.kernels._cuda`.

The launchers take CUDA tensors only, in the (B, S, H, D) layout, and check
device, type, shape, contiguity and alignment; they allocate the outputs
and the backward's scratch, and never fall back to the plain versions. The
C functions choose the route by type: f32 on the CUDA cores, bf16 on the
tensor cores. ``ops`` adds the autograd function, the launch counters and
the CPU path.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels._cuda import F, I, P, check, check_cuda, launch, register

CSRC = Path(__file__).resolve().parent / "csrc"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head_dims each route takes: the f32 CUDA-core kernels hold a row as D / 64
#: groups of 64 columns; the bf16 tensor-core kernels pad a row to 64-column
#: sub-tiles, which takes zamba2's 80 too
HEAD_DIMS = {torch.float32: (64, 128), torch.bfloat16: (64, 80, 128)}
register("flash_attention", CSRC / "flash_attention.cu", {
    "flash_attention_fwd": [P] * 5 + [I] * 9 + [F],
    "flash_attention_bwd": [P] * 10 + [I] * 9 + [F],
})


def _checks(q, k, v, window: Optional[int], **more):
    # messages are made only on failure: these checks run on every launch
    check_cuda(q.device, q=q, k=k, v=v, **more)
    check(q.dtype in _DTYPE_CODES, lambda: f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in dict(k=k, v=v, **more).items():
        check(t.dtype == q.dtype, lambda: f"{name} must be {q.dtype} like q, got {t.dtype}")
    for name, t in dict(q=q, k=k, v=v, **more).items():
        check(t.data_ptr() % 16 == 0, lambda: f"{name} must be 16-byte aligned")
    check(q.ndim == 4 and k.ndim == 4 and v.shape == k.shape, "q must be (B, Sq, Hq, D), k and v (B, Sk, Hkv, D)")
    b, sq, hq, d = q.shape
    check(k.shape[0] == b and k.shape[3] == d, lambda: f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    check(d in HEAD_DIMS[q.dtype],
          lambda: f"head_dim {d} is outside the {q.dtype} flash kernels: they take {HEAD_DIMS[q.dtype]}")
    check(hq % k.shape[2] == 0, lambda: f"q heads {hq} % kv heads {k.shape[2]} != 0")
    check(window is None or window >= 1, lambda: f"sliding window must be >= 1, got {window}")
    return b, sq, k.shape[1], hq, k.shape[2], d


def bwd_workspace_floats(b: int, sq: int, sk: int, hq: int, d: int, dtype: torch.dtype) -> int:
    """Size of the backward's f32 scratch. f32: Di per query row. bf16:
    (lse log2 e, Di, 0, 0) per query row, then each query head's dK and dV,
    which the kernels sum over the group in a fixed order."""
    if dtype == torch.float32:
        return b * hq * sq
    return 4 * b * hq * sq + 2 * b * hq * sk * d


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D). Returns (out (B, Sq, Hq, D)
    in q's type, lse (B, Hq, Sq) f32)."""
    b, sq, sk, hq, hkv, d = _checks(q, k, v, window)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    launch(
        "flash_attention", "flash_attention_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, sq, sk, hq, hkv, d, _DTYPE_CODES[q.dtype], int(causal), window or 0, d**-0.5,
    )
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, d_out, *, causal: bool = True,
                        window: Optional[int] = None):
    """Gradients of the forward: (dq, dk, dv) in the inputs' type and shape.
    ``out`` and ``lse`` are what :func:`flash_attention_fwd` returned."""
    b, sq, sk, hq, hkv, d = _checks(q, k, v, window, out=out, d_out=d_out)
    check_cuda(q.device, lse=lse)
    check(out.shape == q.shape and d_out.shape == q.shape, "out and d_out must have q's shape")
    check(lse.dtype == torch.float32 and lse.shape == (b, hq, sq), "lse must be (B, Hq, Sq) float32")
    workspace = torch.empty(bwd_workspace_floats(b, sq, sk, hq, d, q.dtype), dtype=torch.float32,
                            device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch(
        "flash_attention", "flash_attention_bwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d_out.data_ptr(),
        lse.data_ptr(), workspace.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, hq, hkv, d, _DTYPE_CODES[q.dtype], int(causal), window or 0, d**-0.5,
    )
    return dq, dk, dv
