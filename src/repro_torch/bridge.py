"""Parameters between the JAX package and the port.

:func:`params_from_numpy` takes the JAX package's ``LanguageModel.init``
parameter tree with numpy (or torch) leaves and returns the port's tree: the
same names and layouts (``wq (d, hq, hd)``, ``wo (hq, hd, d)``, ...), with
each segment's scanned ``layers`` axis unstacked into a list of per-layer
trees (the ``seg<i>`` segments, and an encoder-decoder model's
``encoder``, of ``encoder_layers`` layers). :func:`opt_state_from_numpy` does the same for an optimizer state
(the integer slots ``stage`` and ``count``, and the parameter-shaped
slots: pSGD's ``anchor``, momentum's and LARS's ``u``, AdaGrad's ``z`` and
``s2``, Adam's and LAMB's ``m`` and ``v``), so both frameworks can start
from one ``TrainState``. :func:`params_to_numpy` and
:func:`opt_state_to_numpy` go the other way, re-stacking each segment's
layers, so the port's state is written in the JAX package's layout
(``repro_torch.checkpoint``). :func:`load_checkpoint` reads the JAX package's checkpoint format
(``step_<N>/arrays.npz`` keyed by ``|``-joined tree paths, bfloat16 leaves
stored as a uint16 view and named in ``meta.json["_dtypes"]``) without
importing JAX, so a checkpoint written there serves here.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

SEP = "|"


def _tensor(leaf, device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    arr = np.asarray(leaf)
    if torch.device(device).type == "cpu" or not arr.flags.writeable:
        # the port updates its tensors in place: on the CPU a tensor made by
        # from_numpy would rewrite the caller's array (and it needs a
        # writable one); a copy to the card is a copy already
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _unstack(tree, n: int, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, n, i) for k, v in tree.items()}
    if tree.shape[0] != n:
        raise ValueError(f"layers axis {tree.shape[0]} != the segment's repeat {n}")
    return tree[i]


def _repeat(key: str, cfg: ModelConfig):
    """The layer count of the segment that top-level ``key`` names (a
    ``seg<i>``, or an encoder-decoder model's ``encoder``), else None."""
    if key == "encoder" and cfg.is_encoder_decoder:
        return cfg.encoder_layers
    m = re.fullmatch(r"seg(\d+)", key)
    return None if m is None else cfg.segments[int(m.group(1))].repeat


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """The port's parameter tree (tensors on ``device``, dtypes kept) from
    the JAX package's ``LanguageModel.init`` tree."""
    params = {}
    for key, sub in tree.items():
        repeat = _repeat(key, cfg)
        if repeat is None:
            params[key] = _convert(sub, device)
            continue
        params[key] = {
            name: (
                _convert(block, device)  # zamba2's weight-tied shared block
                if name == "shared"
                else [_convert(_unstack(block, repeat, r), device) for r in range(repeat)]
            )
            for name, block in sub.items()
        }
    return params


def vision_params_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The port's ResNet parameters (``models.vision``) from the JAX
    package's ``vision.init`` tree: the same names and layouts (HWIO
    convolutions), as tensors on ``device``."""
    return _convert(tree, device)


INT_SLOTS = ("stage", "count")


def opt_state_from_numpy(state: Dict[str, Any], cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """The port's optimizer state from the JAX package's: ``stage`` and
    ``count`` as host integers, each parameter-shaped slot as
    :func:`params_from_numpy` makes it."""
    out: Dict[str, Any] = {}
    for key, value in state.items():
        if isinstance(value, dict):
            out[key] = params_from_numpy(value, cfg, device)
        elif key in INT_SLOTS:
            out[key] = int(np.asarray(value))
        else:
            raise ValueError(f"optimizer state slot {key!r} is not ported")
    return out


def _host(t: torch.Tensor):
    """A host copy that owns its memory: numpy, or a CPU tensor for
    bfloat16 (which numpy lacks). On the CPU ``.numpy()`` alone would alias
    the live tensor, which the optimizers update in place."""
    t = t.detach().to("cpu", copy=True)
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return _host(tree)


def _stack(layers: List[Any], n: int):
    """The layers stacked on a new leading axis, straight into one host
    buffer: one copy of each layer, and no stacked copy on the device."""
    if len(layers) != n:
        raise ValueError(f"{len(layers)} layers != the segment's repeat {n}")
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers], n) for k in first}
    out = torch.empty((n, *first.shape), dtype=first.dtype)
    for i, t in enumerate(layers):
        out[i].copy_(t.detach())
    return out if out.dtype == torch.bfloat16 else out.numpy()


def params_to_numpy(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX package's parameter tree from the port's: each segment's
    per-layer lists stacked on a leading ``layers`` axis, host copies that
    own their memory (numpy leaves, bfloat16 ones as CPU tensors)."""
    out: Dict[str, Any] = {}
    for key, sub in params.items():
        repeat = _repeat(key, cfg)
        if repeat is None:
            out[key] = _to_host(sub)
            continue
        out[key] = {name: _to_host(block) if name == "shared" else _stack(block, repeat)
                    for name, block in sub.items()}
    return out


def opt_state_to_numpy(state: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX package's optimizer state from the port's: ``stage`` and
    ``count`` as 0-d int32 arrays, each parameter-shaped slot as
    :func:`params_to_numpy` makes it."""
    out: Dict[str, Any] = {}
    for key, value in state.items():
        if isinstance(value, dict):
            out[key] = params_to_numpy(value, cfg)
        elif key in INT_SLOTS:
            out[key] = np.asarray(value, dtype=np.int32)
        else:
            raise ValueError(f"optimizer state slot {key!r} is not ported")
    return out


def _bf16(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)


def load_checkpoint(directory: str, step: int) -> Tuple[Dict[str, Any], dict]:
    """Read ``<directory>/step_<step:08d>`` as written by the JAX package's
    ``save_checkpoint``. Returns (tree, meta): a nested dict rebuilt from
    the path keys, with numpy leaves and bfloat16 leaves as CPU tensors
    (numpy has no bfloat16), ready for :func:`params_from_numpy`."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.pop("_dtypes", {})
    tree: Dict[str, Any] = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key in data.files:
            arr = data[key]
            leaf = _bf16(arr) if dtypes.get(key) == "bfloat16" else arr
            *parents, last = key.split(SEP)
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = leaf
    return tree, meta
