"""RMSNorm (the only norm used by the assigned decoder archs)."""
from __future__ import annotations

import torch


def init(d: int, dtype=torch.float32, device="cuda"):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}  # gemma-style (1 + scale)


def param_axes():
    """The logical axes of :func:`init`'s leaf."""
    return {"scale": ("embed",)}


def apply(params, x, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    out = normed * (1.0 + params["scale"].float())
    return out.to(x.dtype)
