"""Train state: params + optimizer state + step counter. The optimizer
updates the parameter and state tensors in place, so a state is built once
and carried through the run; ``step`` is a host integer."""
from __future__ import annotations

from typing import Any, NamedTuple


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def init_train_state(model, optimizer, seed: int = 0, device="cuda") -> TrainState:
    """Random parameters from ``seed`` on ``device`` and a fresh optimizer state."""
    params = model.init(seed, device=device)
    return TrainState(params, optimizer.init(params), 0)
