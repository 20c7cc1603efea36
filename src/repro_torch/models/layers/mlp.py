"""SwiGLU MLP (llama/qwen/gemma family).

Under tensor parallelism (a ``"tp"`` entry in the params, the sharded
step's group) ``w_gate`` and ``w_up`` hold the rank's columns of the hidden
dimension and ``w_down`` its rows, as JAX's ``constrain`` of the hidden
state to ``mlp`` splits them: the rank's block of the sequence is gathered,
and the partial products are summed over the ``model`` group onto it."""
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


def param_axes(cfg):
    """The logical axes of :func:`init`'s leaves."""
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}


def apply(params, x):
    tp = params.get("tp")
    if tp is not None:
        return tp.scatter(swiglu(params, tp.gather(x)))
    return swiglu(params, x)


def swiglu(params, x):
    """The MLP on x, no exchange: under tensor parallelism the rank's
    partial product over its slice of the hidden dimension."""
    dtype = x.dtype
    up = x @ params["w_up"].to(dtype)
    gate = x @ params["w_gate"].to(dtype)
    return (F.silu(gate) * up) @ params["w_down"].to(dtype)
