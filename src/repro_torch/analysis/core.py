"""The port's lint framework: rules, suppressions, module loading,
reporting; a copy of the mechanics of the JAX package's
``analysis/core.py`` (not an import of it).

The linter is a plain-``ast`` pass: the analyzed code is never imported,
so it runs in a bare container with neither torch nor a card and cannot be
confused by import-time side effects. Each rule has a stable ID (``R1xx``
determinism, ``R2xx`` host syncs in step functions, ``R4xx`` kernel
layout; the JAX package's IDs, kept where a rule has a PyTorch
counterpart), a one-line title, and a fix-it hint printed with every
finding.

Suppression contract
--------------------
A violation is silenced by a comment **on the flagged line**::

    t0 = time.perf_counter()  # repro-lint: disable=R103 -- host seconds reported, never stored

``disable=R101,R102`` silences several rules; ``disable=all`` silences every
rule on that line. ``# repro-lint: disable-file=R105`` anywhere in the file
silences a rule file-wide. Under ``tools/lint_torch.py --strict`` every
suppression must carry a ``-- justification`` tail; a bare suppression is
itself reported.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*(disable|disable-file)=([A-Za-z0-9_,]+|all)"
    r"(?:\s*--\s*(\S.*))?"
)


@dataclass(frozen=True)
class Violation:
    """One finding: where, which rule, what, and how to fix it."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    hint: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}\n    hint: {self.hint}"


@dataclass(frozen=True)
class Suppression:
    """A ``# repro-lint: disable=...`` comment that actually silenced a rule."""

    rule: str
    path: str
    line: int
    justification: Optional[str]  # the ``-- reason`` tail, None when absent


@dataclass
class Module:
    """One parsed source file plus everything rules need to inspect it."""

    path: str  # display path (as given on the command line)
    rel: str  # normalized posix path used for rule scoping
    source: str
    tree: ast.Module
    aliases: Dict[str, str] = field(default_factory=dict)
    # line -> set of rule ids disabled on that line ("all" disables every rule)
    line_disables: Dict[int, Set[str]] = field(default_factory=dict)
    file_disables: Set[str] = field(default_factory=set)
    # (line, rule) -> justification text (None = bare suppression)
    justifications: Dict[Tuple[int, str], Optional[str]] = field(default_factory=dict)

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        if rule_id in self.file_disables or "all" in self.file_disables:
            return True
        on_line = self.line_disables.get(line, set())
        return rule_id in on_line or "all" in on_line

    def suppression_for(self, rule_id: str, line: int) -> Suppression:
        just = self.justifications.get((line, rule_id))
        if just is None:
            just = self.justifications.get((line, "all"))
        if just is None:
            for (ln, rid), j in self.justifications.items():
                if ln == 0 and rid in (rule_id, "all"):  # file-level
                    just = j
                    break
        return Suppression(rule=rule_id, path=self.path, line=line, justification=just)


class Rule:
    """Base class: subclasses set id/title/hint and implement ``check``."""

    id: str = "R000"
    title: str = ""
    hint: str = ""
    # rel-path substrings this rule is scoped to; empty tuple = every file
    applies: Tuple[str, ...] = ()

    def applies_to(self, mod: Module) -> bool:
        return not self.applies or any(s in mod.rel for s in self.applies)

    def check(self, mod: Module) -> Iterator[Violation]:  # pragma: no cover
        raise NotImplementedError

    def violation(self, mod: Module, node: ast.AST, message: str) -> Violation:
        return Violation(rule=self.id, path=mod.path, line=getattr(node, "lineno", 1),
                         col=getattr(node, "col_offset", 0), message=message, hint=self.hint)


# ---------------------------------------------------------------------------
# module loading
# ---------------------------------------------------------------------------


def _parse_suppressions(mod: Module) -> None:
    try:
        for tok in tokenize.generate_tokens(io.StringIO(mod.source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            kind, ids, justification = m.group(1), m.group(2), m.group(3)
            rule_ids = {r.strip() for r in ids.split(",") if r.strip()}
            if kind == "disable-file":
                mod.file_disables.update(rule_ids)
                for rid in rule_ids:
                    mod.justifications[(0, rid)] = justification
            else:
                line = tok.start[0]
                mod.line_disables.setdefault(line, set()).update(rule_ids)
                for rid in rule_ids:
                    mod.justifications[(line, rid)] = justification
    except tokenize.TokenError:  # pragma: no cover - malformed tail
        pass


def _build_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name -> fully qualified module/object path, from imports."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                aliases[local] = a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def load_source(source: str, path: str = "<string>", rel: Optional[str] = None) -> Module:
    tree = ast.parse(source, filename=path)
    mod = Module(path=path, rel=(rel or path).replace("\\", "/"), source=source, tree=tree)
    mod.aliases = _build_aliases(tree)
    _parse_suppressions(mod)
    return mod


def load_file(path: Path, rel: Optional[str] = None) -> Module:
    return load_source(path.read_text(encoding="utf-8"), path=str(path), rel=rel or path.as_posix())


def iter_py_files(paths: Sequence[Path]) -> Iterator[Path]:
    for p in paths:
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


# ---------------------------------------------------------------------------
# AST helpers shared by the rule modules
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Resolve an attribute chain to a dotted path through the import aliases
    (``dist.all_reduce`` via ``import torch.distributed as dist`` ->
    ``torch.distributed.all_reduce``); None for non-name expressions."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def function_table(tree: ast.Module) -> List[Tuple[str, ast.AST]]:
    """All (qualname, FunctionDef) pairs, qualified through classes/functions."""
    out: List[Tuple[str, ast.AST]] = []

    def walk(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                out.append((qual, child))
                walk(child, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                walk(child, f"{prefix}{child.name}.")
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


def enclosing_function(table: List[Tuple[str, ast.AST]], node: ast.AST) -> Optional[Tuple[str, ast.AST]]:
    """Innermost table entry whose span contains ``node`` (by line range)."""
    line = getattr(node, "lineno", None)
    if line is None:
        return None
    best: Optional[Tuple[str, ast.AST]] = None
    for qual, fn in table:
        if fn.lineno <= line <= (fn.end_lineno or fn.lineno):
            if best is None or fn.lineno >= best[1].lineno:
                best = (qual, fn)
    return best


def own_statements(fn: ast.AST) -> Iterator[ast.stmt]:
    """Statements of ``fn`` excluding nested function/class bodies."""
    stack = list(fn.body)
    while stack:
        stmt = stack.pop()
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                stack.append(child)
            elif isinstance(child, ast.ExceptHandler):
                stack.extend(child.body)


# ---------------------------------------------------------------------------
# running
# ---------------------------------------------------------------------------


@dataclass
class LintResult:
    violations: List[Violation] = field(default_factory=list)
    suppressions: List[Suppression] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)  # unparsable files
    files_checked: int = 0


def all_rules() -> List[Rule]:
    """The full registered rule set (imported lazily to avoid cycles)."""
    from repro_torch.analysis import rules_determinism, rules_kernels, rules_trace

    return [*rules_determinism.RULES, *rules_trace.RULES, *rules_kernels.RULES]


def lint_module(mod: Module, rules: Optional[Sequence[Rule]] = None) -> LintResult:
    result = LintResult(files_checked=1)
    for rule in rules if rules is not None else all_rules():
        if not rule.applies_to(mod):
            continue
        for v in rule.check(mod):
            if mod.is_suppressed(v.rule, v.line):
                result.suppressions.append(mod.suppression_for(v.rule, v.line))
            else:
                result.violations.append(v)
    result.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return result


def lint_source(source: str, rel: str = "repro_torch/fixture.py", rules: Optional[Sequence[Rule]] = None) -> LintResult:
    """Lint a source string as if it lived at ``rel`` (test fixture entry)."""
    return lint_module(load_source(source, path=rel, rel=rel), rules)


def lint_paths(paths: Sequence[Path], rules: Optional[Sequence[Rule]] = None) -> LintResult:
    """Lint every .py file under ``paths``."""
    rules = list(rules) if rules is not None else all_rules()
    result = LintResult()
    for path in iter_py_files(paths):
        try:
            mod = load_file(path)
        except SyntaxError as e:
            result.errors.append(f"{path}: {e}")
            continue
        part = lint_module(mod, rules)
        result.violations.extend(part.violations)
        result.suppressions.extend(part.suppressions)
        result.files_checked += 1
    result.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return result
