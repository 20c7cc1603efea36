"""Architecture registry: ``get_config("<arch>")`` / ``--arch`` resolution.

Each assigned architecture module defines ``CONFIG`` (the exact published
shape, cited) and ``smoke()`` (a reduced same-family variant: ≤2 layers,
d_model ≤ 512, ≤ 4 experts) for CPU tests.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

ARCHS: List[str] = [
    "qwen2.5-3b",
    "deepseek-7b",
    "gemma2-9b",
    "rwkv6-1.6b",
    "zamba2-2.7b",
    "arctic-480b",
    "whisper-tiny",
    "dbrx-132b",
    "deepseek-67b",
    "internvl2-1b",
]

_MODULES = {name: "repro_torch.configs." + name.replace("-", "_").replace(".", "_") for name in ARCHS}


def get_config(name: str, variant: str = "full") -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    mod = importlib.import_module(_MODULES[name])
    if variant == "full":
        return mod.CONFIG
    if variant == "smoke":
        return mod.smoke()
    raise ValueError(f"unknown variant {variant!r}")


def list_archs() -> List[str]:
    return list(ARCHS)
