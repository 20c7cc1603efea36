"""The paper's ResNet-20-style CIFAR network with GroupNorm (its Fig. 3
trains ResNet-20 on CIFAR-10), the port of the JAX package's
``models/vision.py``.

Functional like the language model: ``params = init(seed, cfg)``, then
``logits = apply(params, x, cfg)``. The parameters keep the JAX package's
layout (convolutions ``(k, k, cin, cout)``, HWIO; images ``(N, H, W, C)``,
NHWC), so its trees carry over unchanged (``bridge.vision_params_from_numpy``);
``apply`` moves the activations to NCHW once and runs
``torch.nn.functional.conv2d`` (``lax.conv`` in JAX: no Pallas kernel).

GroupNorm, not batch norm: batch-size independent, which matters when SEBS
changes the batch size mid-training. Convolutions pad as XLA's ``"SAME"``
does: the total padding ``max((out - 1) s + k - n, 0)`` split with the
smaller half first, which at stride 2 on an even input is (0, 1), not
``conv2d(padding=1)``'s (1, 1).

``init`` draws the JAX package's random stream (``jax.random.normal`` under
its key names, ``data.synthetic.normal``), so a seed gives the JAX
weights within the normals' few ulps.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.data.synthetic import fold_in, key, normal
from repro_torch.utils.prng import fold_in_name


@dataclass(frozen=True)
class VisionConfig:
    num_classes: int = 10
    width: int = 16          # ResNet-20: 16/32/64
    blocks_per_stage: int = 3  # ResNet-20: 3 stages × 3 blocks × 2 convs + 2
    image_size: int = 32
    channels: int = 3
    groups: int = 4


def _conv_init(k, cin, cout, size=3) -> np.ndarray:
    fan_in = cin * size * size
    return normal(k, (size, size, cin, cout)) * np.float32((2.0 / fan_in) ** 0.5)


def _stages(cfg: VisionConfig):
    """(stage, block, stride, cin, width) of every residual block in order."""
    widths = [cfg.width, 2 * cfg.width, 4 * cfg.width]
    cin = cfg.width
    for si, w in enumerate(widths):
        for bi in range(cfg.blocks_per_stage):
            yield si, bi, 2 if (bi == 0 and si > 0) else 1, cin, w
            cin = w


def init(seed: int = 0, cfg: VisionConfig = VisionConfig(), device="cuda"):
    """The JAX package's ``vision.init(jax.random.key(seed), cfg)``, as f32
    tensors on ``device``."""
    root = key(seed)
    params = {"stem": _conv_init(fold_in_name(root, "stem"), cfg.channels, cfg.width)}
    cin = cfg.width
    for si, bi, _, cin, w in _stages(cfg):
        k = fold_in_name(root, f"s{si}b{bi}")
        blk = {
            "conv1": _conv_init(fold_in(k, 1), cin, w),
            "conv2": _conv_init(fold_in(k, 2), w, w),
            "gn1_scale": np.ones((w,), np.float32), "gn1_bias": np.zeros((w,), np.float32),
            "gn2_scale": np.ones((w,), np.float32), "gn2_bias": np.zeros((w,), np.float32),
        }
        if cin != w:
            blk["proj"] = _conv_init(fold_in(k, 3), cin, w, size=1)
        params[f"s{si}b{bi}"] = blk
        cin = w
    params["head"] = {
        "w": normal(fold_in_name(root, "head"), (cin, cfg.num_classes)) * np.float32(cin**-0.5),
        "b": np.zeros((cfg.num_classes,), np.float32),
    }

    def to_tensor(tree):
        if isinstance(tree, dict):
            return {k_: to_tensor(v) for k_, v in tree.items()}
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)

    return to_tensor(params)


def _same_pad(n: int, size: int, stride: int):
    """XLA's "SAME" padding (before, after) of one spatial axis."""
    out = -(-n // stride)
    total = max((out - 1) * stride + size - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """x (N, C, H, W); w (k, k, cin, cout), HWIO."""
    size = w.shape[0]
    (top, bottom), (left, right) = (_same_pad(n, size, stride) for n in x.shape[2:])
    if (top, left) == (bottom, right):  # conv2d pads both sides alike
        return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=(top, left))
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _group_norm(x, scale, bias, groups: int):
    """x (N, C, H, W): each group of C/groups contiguous channels normalized
    over its channels and positions (the population variance, eps 1e-5),
    then scaled and shifted per channel, as the JAX package's
    ``_group_norm``; one library call."""
    return F.group_norm(x, groups, scale, bias, eps=1e-5)


def apply(params, x, cfg: VisionConfig = VisionConfig()):
    """x: (N, H, W, C) float32 → logits (N, num_classes)."""
    h = _conv(x.permute(0, 3, 1, 2), params["stem"])
    for si, bi, stride, _, _ in _stages(cfg):
        blk = params[f"s{si}b{bi}"]
        y = _conv(h, blk["conv1"], stride)
        y = F.relu(_group_norm(y, blk["gn1_scale"], blk["gn1_bias"], cfg.groups))
        y = _conv(y, blk["conv2"])
        y = _group_norm(y, blk["gn2_scale"], blk["gn2_bias"], cfg.groups)
        skip = h
        if "proj" in blk:
            skip = _conv(h, blk["proj"], stride)
        elif stride != 1:
            skip = h[:, :, ::stride, ::stride]
        h = F.relu(y + skip)
    pooled = h.mean(dim=(2, 3))
    return pooled @ params["head"]["w"] + params["head"]["b"]
