"""Rotary position embeddings (half-rotation form used by llama/qwen/gemma),
computed in float32 and cast back to the input's type."""
from __future__ import annotations

import torch


def _freqs(head_dim: int, theta: float, device):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    inv = _freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * inv  # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
