"""Tree checkpointing in the JAX package's format: npz tensors + json metadata.

Layout: ``<dir>/step_<N:08d>/arrays.npz`` (leaves keyed by their ``|``-joined
tree paths) and ``meta.json`` (step, run state, and ``_dtypes``, which names
the bfloat16 leaves, stored as a uint16 view). A path is built as JAX's
``tree_flatten_with_path`` builds it: a dict key as itself, a list index as
its number, a NamedTuple field as ``.<name>``; dict entries are written in
sorted key order, as JAX flattens them. So a directory written here loads
through the JAX package's ``load_checkpoint`` and one written there loads
here (:func:`load_checkpoint`, the reader of ``repro_torch.bridge``).

Two layers, as in the JAX package:

- :func:`save_checkpoint` / :func:`load_checkpoint` / :func:`latest_step`:
  one-shot primitives (synchronous, no retention).
- :class:`CheckpointManager`: bounded retention (``keep_last``),
  crash-atomic publication (write into ``<step>.tmp``, then ``os.rename``:
  a kill mid-write leaves only an ignored ``.tmp`` directory) and a writer
  thread that keeps the disk I/O off the training loop. The copy to the
  host happens before :meth:`CheckpointManager.save` returns: the
  optimizers update the parameter and state tensors in place, so the next
  update would rewrite memory that the writer is still saving.

Leaves may be torch tensors (on any device), which ``save`` copies to the
host, or numpy arrays and Python numbers, which it writes as they are (as
the JAX package does): the caller must not change such an array before the
write ends. :func:`train_state_tree` puts the port's ``TrainState`` into the
JAX package's layout, making the one host copy of each leaf, and
:func:`train_state_from_tree` takes it back; :meth:`CheckpointManager.restore`
returns numpy leaves, and bfloat16 ones as CPU tensors (numpy has no
bfloat16).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.bridge import SEP
from repro_torch.train.state import TrainState
from repro_torch.utils.tree import tree_leaves

_STEP_DIR = re.compile(r"step_(\d+)")


def _host(leaf) -> Tuple[np.ndarray, bool]:
    """(a host array, whether the leaf is bfloat16): a tensor copied to the
    host, into memory of its own (on the CPU, .numpy() of the tensor itself
    would alias memory that the next in-place update rewrites); anything
    else as it is."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(leaf), False


def _walk(tree, prefix: str, out: Dict[str, np.ndarray], dtypes: Dict[str, str]) -> None:
    def child(name) -> str:
        return f"{prefix}{SEP}{name}" if prefix else str(name)

    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], child(k), out, dtypes)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        for name in tree._fields:
            _walk(getattr(tree, name), child(f".{name}"), out, dtypes)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, child(i), out, dtypes)
    else:
        arr, bf16 = _host(tree)
        out[prefix] = arr
        if bf16:
            dtypes[prefix] = "bfloat16"


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Returns (arrays, dtype_map): host copies keyed by tree path."""
    out: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    _walk(tree, "", out, dtypes)
    return out, dtypes


def _write(path: str, arrays: dict, meta: dict) -> str:
    """Write into ``<path>.tmp`` then rename: readers never observe a
    partially-written checkpoint, and a kill mid-write is harmless."""
    tmp = path + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.isdir(path):
        # re-saving an existing step: move the old directory aside before
        # the rename, never delete-then-rename: a kill between those two
        # operations must not lose the only copy of this step
        old = path + ".old"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, path)
    return path


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, tree: Any, meta: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays, dtypes = _flatten(tree)
    return _write(_step_path(directory, step), arrays, {"step": step, "_dtypes": dtypes, **(meta or {})})


def _recover_interrupted_swaps(directory: str) -> None:
    """A kill between _write's two renames can leave ``step_N.old`` with no
    ``step_N``: the displaced checkpoint is complete, so put it back. Only
    safe with no concurrent writer: CheckpointManager's read paths wait()
    first."""
    for d in os.listdir(directory):
        m = re.fullmatch(r"(step_\d+)\.old", d)
        if m and not os.path.isdir(os.path.join(directory, m.group(1))):
            os.rename(os.path.join(directory, d), os.path.join(directory, m.group(1)))


def _steps(directory: str):
    return sorted(int(m.group(1)) for d in os.listdir(directory) if (m := _STEP_DIR.fullmatch(d)))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    _recover_interrupted_swaps(directory)
    steps = _steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, step: int) -> Tuple[Dict[str, Any], dict]:
    """Read ``<directory>/step_<step:08d>``. Returns (tree, meta): a nested
    dict rebuilt from the path keys (NamedTuple fields keep their leading
    ``.``), numpy leaves and bfloat16 ones as CPU tensors."""
    return bridge.load_checkpoint(directory, step)


def train_state_tree(state: TrainState, cfg) -> Dict[str, TrainState]:
    """The tree both packages' trainers save: ``{"train_state":
    TrainState(params, opt_state, step)}`` in the JAX package's layout (each
    segment's layers stacked, ``stage``/``count``/``step`` 0-d int32), its
    leaves host copies that own their memory, so the next in-place update
    cannot reach them."""
    return {"train_state": TrainState(bridge.params_to_numpy(state.params, cfg),
                                      bridge.opt_state_to_numpy(state.opt_state, cfg),
                                      np.asarray(state.step, dtype=np.int32))}


def _in_order_of(target, tree):
    """``tree`` with its dicts in the key order of ``target``'s (a key that
    ``target`` has and ``tree`` lacks raises KeyError)."""
    if isinstance(target, dict):
        return {k: _in_order_of(v, tree[k]) for k, v in target.items()}
    if isinstance(target, list):
        return [_in_order_of(t, x) for t, x in zip(target, tree)]
    return tree


def train_state_from_tree(tree: Dict[str, Any], like: TrainState, cfg) -> TrainState:
    """The port's ``TrainState`` from a loaded :func:`train_state_tree`
    (either package's), on the device of ``like``'s parameters and with its
    dicts in ``like``'s key order: the leaf order fixes the order of every
    sum over leaves (gradient norms), so the bits depend on it."""
    saved = tree["train_state"]
    device = tree_leaves(like.params)[0].device
    return TrainState(_in_order_of(like.params, bridge.params_from_numpy(saved[".params"], cfg, device)),
                      _in_order_of(like.opt_state, bridge.opt_state_from_numpy(saved[".opt_state"], cfg, device)),
                      int(saved[".step"]))


class CheckpointManager:
    """Retention and asynchronous writes on top of the one-shot primitives.

    ``save`` copies tensor leaves to the host *synchronously* and hands the disk
    write to one background thread. ``wait`` drains pending writes and
    re-raises the first writer error. Retention runs in the writer thread
    after each publication: all but the newest ``keep_last`` ``step_*``
    directories are deleted.
    """

    def __init__(self, directory: str, keep_last: int = 3):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1 (got {keep_last})")
        self.directory = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: list[Future] = []

    # -- write path ---------------------------------------------------------

    def save(self, step: int, tree: Any, meta: Optional[dict] = None) -> None:
        arrays, dtypes = _flatten(tree)  # tensors copied, before the next update
        full_meta = {"step": step, "_dtypes": dtypes, **(meta or {})}
        path = _step_path(self.directory, step)
        # backpressure: at most one write in flight; block on the previous
        # one (re-raising its errors) so a slow disk cannot queue unbounded
        # full-model host copies
        self.wait()
        self._pending.append(self._pool.submit(self._write_and_retain, path, arrays, full_meta))

    def _write_and_retain(self, path: str, arrays: dict, meta: dict) -> None:
        _write(path, arrays, meta)
        for s in _steps(self.directory)[: -self.keep_last]:
            shutil.rmtree(_step_path(self.directory, s), ignore_errors=True)

    def wait(self) -> None:
        """Block until all queued writes are on disk; re-raise writer errors."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- read path ----------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        self.wait()  # recovery inside latest_step must not race the writer
        return latest_step(self.directory)

    def restore(self, step: Optional[int] = None):
        """Checkpoint ``step`` (default: the latest). Returns (tree, meta)."""
        if step is not None:
            self.wait()  # never read a checkpoint still being written
            _recover_interrupted_swaps(self.directory)
            return load_checkpoint(self.directory, step)
        out = self.restore_latest()
        if out is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return out

    def restore_latest(self):
        """Like :meth:`restore` but returns ``None`` when the directory holds
        no checkpoint yet (a fresh start) instead of raising."""
        step = self.latest_step()
        if step is None:
            return None
        return load_checkpoint(self.directory, step)
