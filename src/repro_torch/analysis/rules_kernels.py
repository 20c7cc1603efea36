"""R4xx — kernel layout, the JAX package's ``rules_pallas.py`` for the port.

The port has no Pallas, so R401 (a ``BlockSpec`` index map's arity against
its grid) and R403 (a grid that does not divide its array) have no
counterpart: its kernels are CUDA C++ built by ``kernels/_cuda.py``, whose
launch geometry the kernel tests check on the card. R402 has one: every
kernel is held against a plain PyTorch version, on the CPU always and on the
card by the card tests and ``chip_smoke.py``, so a kernel directory whose
wrapper (``ops.py``) has no ``ref.py`` beside it cannot be checked. The
file keeps its own name because Pallas is not what it checks.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator

from repro_torch.analysis.core import Module, Rule, Violation


class PlainVersion(Rule):
    """R402: a kernel directory without a plain ``ref.py``."""

    id = "R402"
    title = "kernel directory without a plain ref.py"
    hint = (
        "keep the kernel's plain PyTorch version in ref.py beside ops.py: the wrapper uses it on CPU "
        "tensors, and the tests and chip_smoke.py hold the kernel against it."
    )
    applies = ("repro_torch/kernels/",)

    def check(self, mod: Module) -> Iterator[Violation]:
        parts = mod.rel.split("/")
        if len(parts) < 3 or parts[-1] != "ops.py" or parts[-3] != "kernels":
            return
        path = Path(mod.path)
        if path.exists() and not (path.parent / "ref.py").exists():
            yield Violation(rule=self.id, path=mod.path, line=1, col=0,
                            message="kernel directory has no sibling ref.py plain version", hint=self.hint)


RULES = [PlainVersion()]
