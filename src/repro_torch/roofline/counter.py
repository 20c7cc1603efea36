"""Counting a step op by op, the port's counterpart of XLA's
``cost_analysis()`` and ``memory_analysis()``.

:class:`StepCounter` is a dispatch mode: every aten op the step runs passes
through it, on meta tensors (the dry run: nothing is computed or
allocated) or on real ones (the same count, for the tests). It keeps

- ``flops``: each op's count from ``torch.utils.flop_counter``'s formulas
  (FlopCounterMode's: matrix products, convolutions, attention), plus the
  operations each kernel reports (``kernels/accounting.py``);
- ``bytes_accessed``: each op's tensor inputs read once and outputs written
  once (views, which move nothing, and bare allocations left out), plus the
  bytes each kernel reports. The port runs eager, unfused ops, so every op
  moves its operands through memory;
- which of the storages it is told to :meth:`~StepCounter.watch` the
  step reads (an op or a kernel takes it as an input before anything
  overwrites it whole), as XLA keeps only the arguments a step uses;
- the live bytes of the storages the step creates, and their high-water
  mark ``peak_bytes``: an op's output that aliases none of its inputs is a
  new storage, counted until its last tensor dies (a weak reference's
  callback). Storages that exist before the count (the arguments) are
  not counted, nor are shape descriptors (``accounting.descriptors``) in
  any way; ``largest_host_bytes`` is the largest new storage that is not a
  meta tensor's.

Ops run inside a kernel's call (a plain version on the CPU) are left out
of the flops and bytes: the kernel's own report stands for them.
"""
from __future__ import annotations

import functools
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import accounting
from repro_torch.utils.tree import tree_leaves

aten = torch.ops.aten
# ops that overwrite their first argument without reading it
_OVERWRITES = {aten.zero_, aten.fill_, aten.copy_}
# allocations that write nothing: no bytes accessed
_ALLOCATIONS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided}


def _tensors(tree):
    """The tensors in an op's arguments or results (tensors, and lists and
    tuples of them, one level down as aten's schemas have them)."""
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


class _OpInfo:
    """What the count needs of an op, looked up once: which results are new
    storages, its flop formula, whether it moves bytes."""

    __slots__ = ("fresh", "formula", "moves")

    def __init__(self, func):
        self.fresh = [r.alias_info is None for r in func._schema.returns]
        packet = func.overloadpacket
        self.formula = flop_registry.get(packet)
        self.moves = not func.is_view and packet not in _ALLOCATIONS


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_INFO: dict = {}


class StepCounter(TorchDispatchMode):
    """Counts the ops run while it is active (``with StepCounter() as c:``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.kernels = defaultdict(lambda: {"calls": 0, "ops": 0.0, "bytes": 0.0})
        self.live_bytes = 0
        self.peak_bytes = 0
        self.largest_host_bytes = 0
        self._storages = weakref.WeakKeyDictionary()
        self._watched = weakref.WeakKeyDictionary()  # storage -> read (True), overwritten (False), None
        self._refs = set()  # the callbacks' weak references, alive while their storages are

    # -- kernels ------------------------------------------------------------------
    def kernel(self, name: str, ops: float, nbytes: float, inputs=()) -> None:
        for t in inputs:
            if t is not None:
                self._touch(t, read=True)
        k = self.kernels[name]
        k["calls"] += 1
        k["ops"] += ops
        k["bytes"] += nbytes
        self.flops += ops
        self.bytes_accessed += nbytes

    # -- reads ----------------------------------------------------------------------
    def watch(self, tensors) -> None:
        """Note which of ``tensors`` (their storages) the step goes on to read."""
        for t in tensors:
            self._watched[t.untyped_storage()] = None

    def was_read(self, t: torch.Tensor) -> bool:
        return bool(self._watched.get(t.untyped_storage()))

    def _touch(self, t: torch.Tensor, read: bool) -> None:
        st = t.untyped_storage()
        if st in self._watched and self._watched[st] is None:
            self._watched[st] = read

    def _first_touches(self, func, args, kwargs) -> None:
        overwrites = func.overloadpacket in _OVERWRITES
        for i, t in enumerate(_tensors(args)):
            whole = t.storage_offset() == 0 and _nbytes(t) == t.untyped_storage().nbytes()
            self._touch(t, read=not (i == 0 and overwrites and whole))
        for t in _tensors(kwargs.values()):
            self._touch(t, read=True)

    # -- storages -----------------------------------------------------------------
    def _freed(self, size: int, ref) -> None:
        self.live_bytes -= size
        self._refs.discard(ref)

    def _new_storage(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        size = st.nbytes()
        self._storages[st] = size
        self._refs.add(weakref.ref(st, functools.partial(self._freed, size)))
        self.live_bytes += size
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        if t.device.type != "meta":
            self.largest_host_bytes = max(self.largest_host_bytes, size)

    def live_of(self, tensors) -> int:
        """Bytes of the distinct counted storages among ``tensors``."""
        seen, total = set(), 0
        for t in tree_leaves(tensors):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._storages and id(st) not in seen:
                seen.add(id(st))
                total += self._storages[st]
        return total

    # -- the mode -----------------------------------------------------------------
    def __enter__(self):
        accounting.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        accounting.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if len(self._watched) and not func.is_view:
            self._first_touches(func, args, kwargs)
        out = func(*args, **kwargs)
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _OpInfo(func)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if accounting.describing():  # shape descriptors: no storage, no traffic
            return out
        for fresh, t in zip(info.fresh, outs):
            if fresh and isinstance(t, torch.Tensor):
                self._new_storage(t)
        if accounting.in_kernel():
            return out
        if info.formula is not None:
            self.flops += info.formula(*args, **kwargs, out_val=out)
        if info.moves:
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(args))
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(kwargs.values()))
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(outs))
        return out
