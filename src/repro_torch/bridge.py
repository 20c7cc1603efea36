"""Parameters from the JAX package into the port.

:func:`params_from_numpy` takes the JAX package's ``LanguageModel.init``
parameter tree with numpy (or torch) leaves and returns the port's tree: the
same names and layouts (``wq (d, hq, hd)``, ``wo (hq, hd, d)``, ...), with
each segment's scanned ``layers`` axis unstacked into a list of per-layer
trees. :func:`opt_state_from_numpy` does the same for an optimizer state
(``stage`` and the parameter-shaped slots: pSGD's ``anchor``, momentum's
``u``, AdaGrad's ``z`` and ``s2``), so both frameworks can start from one
``TrainState``. :func:`load_checkpoint` reads the JAX package's checkpoint format
(``step_<N>/arrays.npz`` keyed by ``|``-joined tree paths, bfloat16 leaves
stored as a uint16 view and named in ``meta.json["_dtypes"]``) without
importing JAX, so a checkpoint written there serves here.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

SEP = "|"


def _tensor(leaf, device) -> torch.Tensor:
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.array(leaf))  # a writable copy
    return leaf.to(device)


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


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """The port's parameter tree (tensors on ``device``, dtypes kept) from
    the JAX package's ``LanguageModel.init`` tree."""
    params = {}
    for key, sub in tree.items():
        m = re.fullmatch(r"seg(\d+)", key)
        if m is None:
            params[key] = _convert(sub, device)
            continue
        seg = cfg.segments[int(m.group(1))]
        params[key] = {
            name: (
                _convert(block, device)  # zamba2's weight-tied shared block
                if name == "shared"
                else [_convert(_unstack(block, seg.repeat, r), device) for r in range(seg.repeat)]
            )
            for name, block in sub.items()
        }
    return params


def opt_state_from_numpy(state: Dict[str, Any], cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """The port's optimizer state from the JAX package's: ``stage`` as a host
    integer, each parameter-shaped slot as :func:`params_from_numpy` makes
    it."""
    out: Dict[str, Any] = {}
    for key, value in state.items():
        if isinstance(value, dict):
            out[key] = params_from_numpy(value, cfg, device)
        elif key == "stage":
            out[key] = int(np.asarray(value))
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
