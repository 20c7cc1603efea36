"""Optimizer registry. The adaptive baselines (adamw, lars, lamb) come with
a later slice."""
from __future__ import annotations

from repro_torch.optim.adagrad import adagrad, adagrad_da
from repro_torch.optim.base import Optimizer
from repro_torch.optim.sgd import momentum, psgd, sgd

_REGISTRY = {
    "sgd": sgd,
    "psgd": psgd,
    "momentum": momentum,
    "msgd": momentum,
    "adagrad": adagrad,
    "adagrad_da": adagrad_da,
}
LATER = ("adamw", "lars", "lamb")


def make_optimizer(name: str, **hp) -> Optimizer:
    if name in LATER:
        raise NotImplementedError(f"optimizer {name!r} comes with the adaptive-optimizer slice")
    if name not in _REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**hp)


__all__ = ["Optimizer", "make_optimizer", "sgd", "psgd", "momentum", "adagrad", "adagrad_da"]
