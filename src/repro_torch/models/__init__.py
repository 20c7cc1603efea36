from repro_torch.models.lm import LanguageModel
from repro_torch.models.zoo import build_model

__all__ = ["LanguageModel", "build_model"]
