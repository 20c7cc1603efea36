"""Train state: params + optimizer state + step counter. The optimizer
updates the parameter and state tensors in place, so a state is built once
and carried through the run; ``step`` is a host integer.

The logical sharding tree rides along, as in the JAX package: optimizer
state slots that mirror the params (momentum, AdaGrad's accumulators, the
pSGD anchor) take each parameter's axes (ZeRO-1-style placement with no
extra rules), and host integers are replicated (``()``)."""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.sharding.partitioning import is_axes_leaf, map_axes


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def init_train_state(model, optimizer, seed: int = 0, device="cuda") -> TrainState:
    """Random parameters from ``seed`` on ``device`` and a fresh optimizer state."""
    params = model.init(seed, device=device)
    return TrainState(params, optimizer.init(params), 0)


def _structure(tree) -> Any:
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    return None


def unstack_axes(axes, params):
    """The JAX package's axes tree (``LanguageModel.param_axes``: each
    segment's body stacked under a leading ``"layers"`` entry) laid over the
    port's ``params`` tree: a per-layer list where ``params`` has one, each
    layer's leaves without the ``"layers"`` entry (which is never sharded,
    so a layer's spec is the stacked leaf's without its first entry)."""
    if isinstance(params, list) and not isinstance(axes, list):
        def drop(a):
            if not a or a[0] != "layers":
                raise ValueError(f"a per-layer leaf's axes {a} lack the leading 'layers' entry")
            return a[1:]

        layer = map_axes(drop, axes)
        return [unstack_axes(layer, p) for p in params]
    if isinstance(params, dict):
        return {k: unstack_axes(axes[k], v) for k, v in params.items()}
    if isinstance(params, list):
        return [unstack_axes(a, p) for a, p in zip(axes, params, strict=True)]
    if not is_axes_leaf(axes):
        raise ValueError(f"no axes for a leaf: {axes!r}")
    return axes


def opt_state_axes(opt_state, params, param_axes):
    """Logical-axes tree matching ``opt_state``: param-shaped slots copy the
    param axes, host integers (``stage``, ``count``) are replicated."""
    axes = unstack_axes(param_axes, params)
    structure = _structure(params)
    return {k: axes if _structure(v) == structure else () for k, v in opt_state.items()}


def state_axes(state: TrainState, param_axes) -> TrainState:
    """The logical axes of every leaf of ``state`` (the step replicated)."""
    return TrainState(params=unstack_axes(param_axes, state.params),
                      opt_state=opt_state_axes(state.opt_state, state.params, param_axes), step=())
