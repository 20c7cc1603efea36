"""Optimizer registry."""
from __future__ import annotations

from repro_torch.optim.adagrad import adagrad, adagrad_da
from repro_torch.optim.adaptive import adamw, lamb, lars
from repro_torch.optim.base import Optimizer
from repro_torch.optim.sgd import momentum, psgd, sgd

_REGISTRY = {
    "sgd": sgd,
    "psgd": psgd,
    "momentum": momentum,
    "msgd": momentum,
    "adagrad": adagrad,
    "adagrad_da": adagrad_da,
    "adamw": adamw,
    "lars": lars,
    "lamb": lamb,
}
OPTIMIZERS = tuple(_REGISTRY)


def make_optimizer(name: str, **hp) -> Optimizer:
    if name not in _REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**hp)._replace(recipe=(name, tuple(sorted(hp.items()))))


__all__ = ["Optimizer", "OPTIMIZERS", "make_optimizer", "sgd", "psgd", "momentum", "adagrad",
           "adagrad_da", "adamw", "lars", "lamb"]
