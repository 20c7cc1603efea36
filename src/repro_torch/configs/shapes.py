"""Assigned input shapes and meta-tensor stand-ins for the dry run, the
JAX package's ``configs/shapes.py``.

Shapes (assigned):
    train_4k     seq_len=4096    global_batch=256   (training)
    prefill_32k  seq_len=32768   global_batch=32    (inference-prefill)
    decode_32k   seq_len=32768   global_batch=128   (inference-decode)
    long_500k    seq_len=524288  global_batch=1     (long-context-decode)

Decode shapes run ``decode_step`` (one new token against a KV/state cache
of ``seq_len``), not the train step. ``long_500k`` uses each dense arch's
sliding-window variant (``CONFIG_LONG``); rwkv6/zamba2 run their native
configs; whisper-tiny is skipped (its decoder has 448 positions).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.configs.base import VISION_EMBED_DIM, ModelConfig
from repro_torch.configs.registry import _MODULES, get_config


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: str, shape: str) -> bool:
    """whisper-tiny has no 524k decode (enc-dec, 448-pos decoder)."""
    if shape == "long_500k" and arch == "whisper-tiny":
        return False
    return True


def config_for(arch: str, shape: str) -> ModelConfig:
    """Resolve the config variant for an (arch, shape) pair.

    ``long_500k`` picks the sliding-window variant for full-attention archs
    (CONFIG_LONG); SSM/hybrid archs run their native config.
    """
    if not shape_applicable(arch, shape):
        raise ValueError(f"{arch} × {shape} is inapplicable (whisper-tiny's decoder has 448 positions)")
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.supports_long_context:
        mod = importlib.import_module(_MODULES[arch])
        if hasattr(mod, "CONFIG_LONG"):
            return mod.CONFIG_LONG
    return cfg


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for the model-input batch (no allocation).

    For the stubbed frontends this is where the precomputed embeddings
    enter: whisper gets (B, encoder_seq, d_model) frame embeddings,
    internvl2 gets (B, 256, 1024) patch embeddings, both in the compute
    dtype; tokens are int32.
    """
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    specs = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    compute = getattr(torch, cfg.compute_dtype)
    if cfg.is_encoder_decoder:
        specs["audio_embeds"] = torch.empty((b, cfg.encoder_seq, cfg.d_model), dtype=compute, device="meta")
    if cfg.num_vision_tokens and shape.kind != "decode":
        specs["vision_embeds"] = torch.empty((b, cfg.num_vision_tokens, VISION_EMBED_DIM), dtype=compute,
                                             device="meta")
    return specs
