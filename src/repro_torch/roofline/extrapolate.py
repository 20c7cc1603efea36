"""Depth-extrapolated cost numbers for the roofline, the JAX package's
``roofline/extrapolate.py``.

XLA's cost analysis counts while-loop bodies once, so the JAX package
compiles each combo unrolled at segment-repeat r=1 and r=2 and
extrapolates linearly to the full depth (every layer in a segment is
identical):

    cost(r) = base + r · per_layer_cost
    cost_full = cost(1) + (R − 1) · (cost(2) − cost(1))

The port's layers are a Python loop and its dry run counts every one, at
full depth. Here the extrapolation is a check: the counts at r=1 and r=2,
extrapolated, must equal the count at r=R (``roofline/run.py``).

:func:`ssm_recurrence_flops` is JAX's analytic correction for the SSM/GLA
sequence scan, which XLA counts once. It is kept for parity and not added
to the port's counts: the GLA kernels report their own operations
(``kernels/gla/ops.py``'s ``cost``), which the count already holds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape


def scaled_config(cfg: ModelConfig, r: int) -> ModelConfig:
    segs = tuple(dataclasses.replace(s, repeat=r) for s in cfg.segments)
    return cfg.replace(segments=segs, scan_layers=False, attn_chunk=None)


def ssm_recurrence_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Analytic FLOPs of the per-step GLA recurrence (JAX's correction)."""
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    per_layer = 0.0
    for seg in cfg.segments:
        for b in seg.body:
            if b.mixer == "mamba2":
                d_in = cfg.ssm_expand * cfg.d_model
                nh = d_in // cfg.ssm_head_dim
                per_layer += 5.0 * cfg.ssm_state * cfg.ssm_head_dim * nh * seg.repeat
            elif b.mixer == "rwkv6":
                nh = cfg.d_model // cfg.rwkv_head_dim
                per_layer += 5.0 * cfg.rwkv_head_dim**2 * nh * seg.repeat
    mult = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd ≈ 3× fwd
    return per_layer * tokens * mult


def extrapolate_costs(summary_r1: Dict, summary_r2: Dict, full_repeat: int,
                      ssm_correction: float = 0.0) -> Dict:
    """Linear depth extrapolation of flops / bytes / collective bytes."""

    def pick(s):
        return (
            s["cost"]["flops"],
            s["cost"]["bytes_accessed"],
            s["collectives"]["total_bytes"],
        )

    f1, b1, c1 = pick(summary_r1)
    f2, b2, c2 = pick(summary_r2)
    r = full_repeat
    out = {
        "flops": f1 + (r - 1) * (f2 - f1) + ssm_correction,
        "bytes_accessed": b1 + (r - 1) * (b2 - b1),
        "collective_bytes": c1 + (r - 1) * (c2 - c1),
        "per_layer": {
            "flops": f2 - f1,
            "bytes_accessed": b2 - b1,
            "collective_bytes": c2 - c1,
        },
        "ssm_correction_flops": ssm_correction,
    }
    return out
