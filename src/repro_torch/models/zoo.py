"""Model factory: config → LanguageModel."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LanguageModel


def build_model(cfg: ModelConfig) -> LanguageModel:
    return LanguageModel(cfg)
