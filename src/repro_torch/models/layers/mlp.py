"""SwiGLU MLP (llama/qwen/gemma family)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init(gen: torch.Generator, cfg, device="cuda"):
    d, dff = cfg.d_model, cfg.d_ff
    dtype = getattr(torch, cfg.param_dtype)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device) * scale

    return {
        "w_gate": normal((d, dff), d**-0.5),
        "w_up": normal((d, dff), d**-0.5),
        "w_down": normal((dff, d), dff**-0.5),
    }


def apply(params, x):
    dtype = x.dtype
    up = x @ params["w_up"].to(dtype)
    gate = x @ params["w_gate"].to(dtype)
    return (F.silu(gate) * up) @ params["w_down"].to(dtype)
