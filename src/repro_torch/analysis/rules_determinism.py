"""R1xx — determinism rules, the JAX package's ``rules_determinism.py`` for
the port.

The port's equivalence guarantees (bit-identical resume, bit-identical
elastic widths and sharded layouts, token-identical paged serving) reduce
to one discipline: no operation whose result depends on a backend's
reduction order, hash-salted iteration order, or ambient host state.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import Module, Rule, Violation, dotted_name, enclosing_function, function_table

#: collectives whose reduction order is the backend's choice, not ours
_ORDERED_COLLECTIVES = {
    f"torch.distributed.{name}": name
    for name in ("all_reduce", "reduce", "reduce_scatter", "reduce_scatter_tensor", "all_reduce_coalesced")
}

_STATE_PATHS = (
    "repro_torch/core/",
    "repro_torch/train/",
    "repro_torch/checkpoint/",
    "repro_torch/data/",
    "repro_torch/distributed/",
    "repro_torch/optim/",
    # serving timestamps feed request-lifecycle accounting and the tracer feeds
    # every measurement: both draw time only through the injected clock
    "repro_torch/serve/",
    "repro_torch/obs/",
)

_WALLCLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow", "datetime.date.today",
    "os.urandom", "uuid.uuid1", "uuid.uuid4", "secrets.token_bytes", "secrets.token_hex",
}

#: numpy.random entry points that are fine: explicitly seeded constructors
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox"}

#: torch's samplers: fine only with an explicit ``generator=``
_TORCH_SAMPLERS = {
    f"torch.{name}" for name in ("rand", "randn", "randint", "randperm", "rand_like", "randn_like",
                                 "randint_like", "normal", "bernoulli", "multinomial", "poisson")
}


class BackendOrderedCollective(Rule):
    """R101: a backend-ordered reduction in a bit-identity path."""

    id = "R101"
    title = "backend-ordered reduction in train/distributed path"
    hint = (
        "float reduction order must be a function of the accumulation count, not the topology: "
        "move bytes (all-gather, all-to-all) and sum with span_tree_sum "
        "(repro_torch.distributed.step). Suppress with a justification only where cross-width "
        "bit-identity is explicitly out of contract."
    )
    applies = ("repro_torch/train/", "repro_torch/distributed/")

    def check(self, mod: Module) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func, mod.aliases)
                if name in _ORDERED_COLLECTIVES:
                    yield self.violation(mod, node, f"raw torch.distributed.{_ORDERED_COLLECTIVES[name]} — the "
                                                    "backend picks the reduction order, so results change "
                                                    "with topology/width")


def _is_set_expr(node: ast.AST, mod: Module) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return dotted_name(node.func, mod.aliases) in ("set", "frozenset")
    return False


class SetIteration(Rule):
    """R102: iterating a set — order is hash-salted per process."""

    id = "R102"
    title = "iteration over a set"
    hint = (
        "set iteration order is salted by PYTHONHASHSEED and differs across processes; iterate "
        "sorted(...) (or keep a list/dict, which preserve insertion order) before the order can "
        "reach tree construction, RNG folds, or float accumulation."
    )
    applies = ("repro_torch/",)

    def check(self, mod: Module) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                if _is_set_expr(node.iter, mod):
                    yield self.violation(mod, node.iter, "for-loop iterates a set directly")
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                for gen in node.generators:
                    if _is_set_expr(gen.iter, mod):
                        yield self.violation(mod, gen.iter, "comprehension iterates a set directly")


class AmbientEntropy(Rule):
    """R103: wall-clock or unseeded randomness where state is checkpointed."""

    id = "R103"
    title = "wall-clock or unseeded randomness in checkpointed-state path"
    hint = (
        "kill-equivalence requires every stochastic or time-dependent input to live in "
        "checkpointed state: draw from the trainer's host_rng, a seeded torch.Generator passed as "
        "generator=, or np.random.default_rng(seed), never from wall-clock or a process-global RNG. "
        "Timing code uses the injected clock: accept `clock: Callable[[], float] = time.perf_counter` "
        "as a default-arg REFERENCE (never called there) and read time only through the clock "
        "(repro_torch.obs.trace.Tracer.clock is the seam; tests swap in a fake counter)."
    )
    applies = _STATE_PATHS

    def check(self, mod: Module) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func, mod.aliases)
            if name is None:
                continue
            if name in _WALLCLOCK_CALLS:
                yield self.violation(mod, node, f"call to {name} in a checkpointed-state path")
            elif name.startswith("random."):
                yield self.violation(mod, node, f"process-global stdlib RNG ({name}) — state is neither "
                                                "seeded per-run nor checkpointed")
            elif name.startswith("numpy.random."):
                if name.split(".")[-1] not in _NP_RANDOM_OK:
                    yield self.violation(mod, node, f"global numpy RNG ({name}) — use a checkpointed "
                                                    "np.random.default_rng Generator")
            elif name in _TORCH_SAMPLERS and not any(kw.arg == "generator" for kw in node.keywords):
                yield self.violation(mod, node, f"{name} without generator= draws from torch's global RNG")


def _dict_view_iter(node: ast.AST) -> bool:
    """``x.keys() / x.values() / x.items()``."""
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("keys", "values", "items"))


def _contains_fold(nodes, mod: Module) -> bool:
    for root in nodes:
        for node in ast.walk(root):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func, mod.aliases) or ""
                if name.endswith("fold_in") or name.endswith("fold_in_name"):
                    return True
    return False


class UnsortedFoldOrder(Rule):
    """R104: a key fold driven by mapping-enumeration order."""

    id = "R104"
    title = "fold_in_name keyed by dict-enumeration order"
    hint = (
        "fold keys by NAME or sorted key, never by enumeration position: iterate sorted(d) (or "
        "fold_in_name(key, k)) so inserting an entry cannot reshuffle every later key "
        "(cf. repro_torch.utils.prng)."
    )
    applies = ("repro_torch/",)

    def check(self, mod: Module) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                if _dict_view_iter(node.iter) and _contains_fold(node.body, mod):
                    yield self.violation(mod, node.iter, "loop over dict view feeds a key fold — the fold "
                                                         "order tracks insertion order")
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                elts = [node.key, node.value] if isinstance(node, ast.DictComp) else [node.elt]
                for gen in node.generators:
                    if _dict_view_iter(gen.iter) and _contains_fold(elts, mod):
                        yield self.violation(mod, gen.iter, "comprehension over dict view feeds a key fold")


#: the only functions allowed to move serve-side state across devices: the
#: disaggregated engine's construction (per-worker weights and pools) and its
#: page-streaming seam
_PAGE_SEAM_FUNCS = ("DisaggregatedEngine.__init__", "DisaggregatedEngine._stream")


def _names_a_device(node: ast.AST) -> bool:
    """Whether an argument of ``.to(...)`` names a device: a string literal,
    or an expression whose names mention ``device`` (``device``,
    ``self.device``, ``torch.device(...)``, ``x.device``)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and "device" in n.id:
            return True
        if isinstance(n, ast.Attribute) and "device" in n.attr:
            return True
    return False


def _device_move(node: ast.Call) -> bool:
    func = node.func
    if not isinstance(func, ast.Attribute):
        return False
    if func.attr in ("cuda", "cpu"):
        return True
    if func.attr != "to":
        return False
    return (any(kw.arg == "device" for kw in node.keywords)
            or (bool(node.args) and _names_a_device(node.args[0])))


class DeviceMoveBypassesPageSeam(Rule):
    """R105: a device move in serve/ outside the page export/import seam."""

    id = "R105"
    title = "device move in serve/ bypasses the page-streaming seam"
    hint = (
        "cross-pool KV transfers must go through paged_export_slot -> DisaggregatedEngine._stream -> "
        "paged_import_slot so page-id remap and both pools' refcount audits see every crossing byte; "
        "worker weights and pools are placed in DisaggregatedEngine.__init__. Host inputs copied to "
        "a worker's device and host reads of results are suppressed on their line, with the reason."
    )
    applies = ("repro_torch/serve/",)

    def check(self, mod: Module) -> Iterator[Violation]:
        table = function_table(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not _device_move(node):
                continue
            enclosing = enclosing_function(table, node)
            if enclosing is not None:
                parts = enclosing[0].split(".")
                owners = {".".join(parts[: i + 1]) for i in range(len(parts))}
                if owners & set(_PAGE_SEAM_FUNCS):
                    continue
                where = f"in {enclosing[0]}"
            else:
                where = "at module level"
            yield self.violation(mod, node, f".{node.func.attr}(...) {where} moves serve-side state across "
                                            "devices outside the page export/import seam")


RULES = [
    BackendOrderedCollective(),
    SetIteration(),
    AmbientEntropy(),
    UnsortedFoldOrder(),
    DeviceMoveBypassesPageSeam(),
]
