from repro_torch.models.lm import LanguageModel

__all__ = ["LanguageModel"]
