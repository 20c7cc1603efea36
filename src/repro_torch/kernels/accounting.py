"""What the kernels report to a count in progress, and the regions they run in.

The dry run (``launch/dryrun.py``) counts a step's operations and bytes
op by op under a dispatch mode (``roofline/counter.py``). A kernel is one
call to it: the CUDA kernels are ctypes calls that no dispatch mode sees,
and on meta tensors they compute nothing. So each kernel wrapper runs its
call (the kernel, its plain version on the CPU, or its meta path) inside
:func:`kernel_region`, which reports the kernel's own ``cost(...)`` (the
operations its inputs need and the bytes it must move) to every active
counter, and hides the ops run inside (the plain version's) from the
counters and from the remat policies (``models/blocks.py``): a policy that
saves matrix products cannot see into a kernel on the card, and it saves
none inside a plain version on the CPU either, so the saved tensors are
the same on both.

:func:`descriptors` marks the making of meta tensors that only describe a
shape and dtype (a collective's "likes", ``distributed/``): on a meta run
they would look like the step's own allocations, and a counter tracks no
storage made inside.

One region at a time per process: the autograd engine runs a backward in
the calling thread's stead, never beside it.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import List

#: active counters, innermost last: each has ``kernel(name, ops, nbytes, inputs)``
COUNTERS: List = []
_depth = 0
_describing = 0


def describing() -> bool:
    """Whether shape descriptors are being made (:func:`descriptors`)."""
    return _describing > 0


@contextmanager
def descriptors():
    """Around the making of meta tensors that stand for a shape and dtype
    only: they hold no memory on any device."""
    global _describing
    _describing += 1
    try:
        yield
    finally:
        _describing -= 1


def in_kernel() -> bool:
    """Whether a kernel's call (a plain version or a meta path) is running."""
    return _depth > 0


@contextmanager
def kernel_region(name: str, ops: float, nbytes: float, inputs=()):
    """Report one call of kernel ``name`` (``ops`` and ``nbytes`` of its
    ``cost``, the tensors it reads) to the active counters, and hide the ops
    run inside from them and from the remat policies."""
    global _depth
    if _depth == 0:
        for counter in COUNTERS:
            counter.kernel(name, ops, nbytes, inputs)
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
