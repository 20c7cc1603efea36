"""R2xx — host syncs in step functions, the JAX package's
``rules_trace.py`` for the port.

JAX's R201 (Python control flow on a traced value) and R202 (unhashable
``jax.jit`` static arguments) have no counterpart: nothing in the port is
traced, and nothing is compiled per argument. R203 has one. A step
function (a serving tick, an optimizer update; the literal
``contracts.STEP_FUNCTIONS``) that reads a tensor's value on the host
(``.item()``, ``.tolist()``, ``float()`` / ``int()`` / ``bool()`` of a
tensor) waits there for the card to drain its queue, once a tick or an
update, and the host stops feeding it.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.contracts import step_functions_for
from repro_torch.analysis.core import Module, Rule, Violation, function_table, own_statements

_HOST_SYNC_METHODS = ("item", "tolist")
_HOST_CAST_BUILTINS = ("float", "int", "bool")
#: attributes and calls that give host values (shapes, sizes, counts), never a tensor's
_HOST_VALUED = {"shape", "ndim", "numel", "size", "element_size", "dtype", "device", "is_cuda", "nbytes"}


def _may_be_tensor(node: ast.AST) -> bool:
    """Whether a cast's argument may be a tensor: an attribute, subscript or
    call chain that reads no shape, size or count (a bare name or constant
    is taken as a host value: the rule looks for reads of step results)."""
    if not isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        return False
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in _HOST_VALUED:
            return False
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id in ("len", "range", "sum", "max",
                                                                                        "min", "round", "abs"):
            return False
    return True


class HostSyncInStep(Rule):
    """R203: a host sync inside a step function."""

    id = "R203"
    title = "host sync (.item()/float()) inside a step function"
    hint = (
        "a step function runs once a tick or an update: keep its values on the card and read them "
        "on the host where the caller needs them (the trainer reads `float(metrics['loss'])` after "
        "the step); a sync that must stay is suppressed on its line, with the reason."
    )
    applies = ("repro_torch/",)

    def check(self, mod: Module) -> Iterator[Violation]:
        steps = step_functions_for(mod.rel)
        if not steps:
            return
        for qual, fn in function_table(mod.tree):
            if qual not in steps:
                continue
            for stmt in own_statements(fn):
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    func = node.func
                    if isinstance(func, ast.Attribute) and func.attr in _HOST_SYNC_METHODS and not node.args:
                        yield self.violation(mod, node, f"`.{func.attr}()` inside step function `{qual}`")
                    elif (isinstance(func, ast.Name) and func.id in _HOST_CAST_BUILTINS
                          and func.id not in mod.aliases and len(node.args) == 1
                          and _may_be_tensor(node.args[0])):
                        yield self.violation(mod, node, f"`{func.id}(...)` host cast inside step function `{qual}`")


RULES = [HostSyncInStep()]
