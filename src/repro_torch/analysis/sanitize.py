"""Opt-in runtime sanitizers (enable with ``REPRO_SANITIZE=1``), the port's
copy of the JAX package's ``analysis/sanitize.py``: the same checks and the
same messages, word for word.

Hooks that audit the *numbers* on a live workload, from inside the
subsystems themselves:

- :func:`check_finite_update`: NaN/Inf tripwire on the trainer's per-update
  metrics (a non-finite loss poisons every later update silently: the run
  keeps stepping and the divergence is only visible in the curves).
- :func:`audit_page_pool`: full PagePool invariant check plus an *exact*
  refcount reconstruction from first principles (live admission plans, the
  radix index and the scratch page); called by the paged engines after
  every admission, publish and release.
- :func:`audit_engine_compiles` / :func:`compile_counter`: a serving
  engine's step caches against its declared buckets: decode steps for
  widths of the admission ladder only, chunk-prefill steps for sizes of
  ``prefill_chunks`` only. In the JAX package each cached step is a jitted
  function and the audit also requires exactly one executable in it; the
  port's steps are plain functions, for which :func:`_cache_size` gives
  None, so that check does not apply here.
- :func:`audit_tracer`: obs-overhead audit at run() boundaries: a disabled
  tracer recorded zero events, and the synchronous span stack is balanced.

Everything here is stdlib-only and duck-typed against the host objects, so
importing this module costs nothing when the sanitizers are disabled; the
hooks themselves are O(pool size) and gated behind :func:`enabled` at each
call site. Never enable them for wall-clock measurements.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "SanitizerError",
    "enabled",
    "check_finite_update",
    "audit_page_pool",
    "audit_engine_compiles",
    "audit_tracer",
    "compile_counter",
]


def enabled() -> bool:
    """True when ``REPRO_SANITIZE`` is set to anything but '' / '0'."""
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


class SanitizerError(AssertionError):
    """A runtime contract violation caught by a sanitizer hook."""


# ---------------------------------------------------------------------------
# trainer: NaN/Inf gradient tripwire
# ---------------------------------------------------------------------------

_FINITE_KEYS = ("loss", "grad_norm")


def check_finite_update(
    metrics: Dict[str, Any], *, update: int, stage: int
) -> None:
    """Fail fast on a non-finite loss/gradient at update ``update``.

    ``metrics`` is the trainer's per-update metrics dict (values are host
    floats or 0-d arrays). Only scalar keys known to be finite-by-contract
    are checked; missing keys are skipped so the hook survives metric
    renames in custom steps.
    """
    for key in _FINITE_KEYS:
        if key not in metrics:
            continue
        try:
            value = float(metrics[key])
        except (TypeError, ValueError):
            continue
        if not math.isfinite(value):
            raise SanitizerError(
                f"non-finite {key}={value} at update {update} (stage {stage}); "
                "the batch/LR ladder for this stage is producing divergent "
                "updates — stop before the poison spreads to the checkpoint"
            )


# ---------------------------------------------------------------------------
# paged serving: PagePool refcount auditor
# ---------------------------------------------------------------------------


def _indexed_pages(index: Any) -> List[int]:
    """Page ids the radix index currently holds a reference on."""
    out: List[int] = []
    stack = list(index._root.children.values())
    while stack:
        node = stack.pop()
        out.append(node.page)
        stack.extend(node.children.values())
    return out


def audit_page_pool(
    pool: Any, index: Optional[Any], plans: Iterable[Any], *, where: str = ""
) -> None:
    """Check structural invariants and reconstruct every refcount exactly.

    Expected references per physical page: one per occurrence in a live
    slot's admission plan (``plan.pages = shared + new_pages``), one if the
    radix index has published it, plus the permanent scratch reference on
    page 0. Any drift — a leak, a double-release surviving ``release``'s own
    assert, an index/plan disagreement — is reported with the full delta.
    """
    try:
        pool.check()
    except AssertionError as e:
        raise SanitizerError(f"page pool structure broken {where}: {e}") from e

    expected = [0] * pool.num_pages
    expected[0] = 1  # scratch page: permanently referenced
    for plan in plans:
        for pid in plan.pages:
            expected[pid] += 1
    if index is not None:
        for pid in _indexed_pages(index):
            expected[pid] += 1

    drift = [
        (pid, pool.refs[pid], expected[pid])
        for pid in range(pool.num_pages)
        if pool.refs[pid] != expected[pid]
    ]
    if drift:
        detail = ", ".join(
            f"page {pid}: refs={got} expected={want}" for pid, got, want in drift
        )
        raise SanitizerError(
            f"page refcount drift {where}: {detail} "
            "(expected = live plans + radix index + scratch)"
        )


# ---------------------------------------------------------------------------
# serving: compile-counter vs declared buckets
# ---------------------------------------------------------------------------


def _cache_size(step: Any) -> Optional[int]:
    """Executable count of a step that exposes one (a jitted callable of the
    JAX package); None for the port's plain step functions."""
    probe = getattr(step, "_cache_size", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:  # pragma: no cover - a probe that cannot answer
        return None


def audit_engine_compiles(engine: Any, *, where: str = "") -> None:
    """Assert an engine's step caches match its declared buckets.

    - decode steps: one cache entry per admission-ladder width actually
      reached, never a width outside the ladder;
    - chunk-prefill steps: keys ⊆ ``prefill_chunks``;
    - for a step that reports its executable count (a jitted one), exactly
      one executable each: more means it started retracing per call.
    """
    ladder = set(getattr(engine.admission, "ladder", []))
    decodes = getattr(engine, "_decodes", {})
    stray = sorted(set(decodes) - ladder)
    if stray:
        raise SanitizerError(
            f"decode executables {where} for widths {stray} outside the "
            f"admission ladder {sorted(ladder)} — an undeclared compile bucket"
        )
    for width, step in decodes.items():
        n = _cache_size(step)
        if n is not None and n != 1:
            raise SanitizerError(
                f"decode step for width {width} holds {n} executables "
                f"{where} — expected exactly 1 (retracing per call?)"
            )
    chunks = set(getattr(engine, "prefill_chunks", ()) or ())
    chunk_steps = getattr(engine, "_chunk_steps", {})
    stray = sorted(set(chunk_steps) - chunks)
    if stray:
        raise SanitizerError(
            f"chunk-prefill executables {where} for sizes {stray} outside "
            f"declared prefill_chunks {sorted(chunks)}"
        )
    for size, step in chunk_steps.items():
        n = _cache_size(step)
        if n is not None and n != 1:
            raise SanitizerError(
                f"chunk-prefill step for size {size} holds {n} executables "
                f"{where} — expected exactly 1"
            )


# ---------------------------------------------------------------------------
# observability: tracer-overhead audit
# ---------------------------------------------------------------------------


def audit_tracer(tracer: Any, *, where: str = "") -> None:
    """Audit the obs contract at a run() boundary (duck-typed, so any
    tracer-shaped object works):

    - a DISABLED tracer must have recorded zero events — the no-op path
      really is a no-op, instrumentation cannot leak records (or cost)
      into an untraced run;
    - the synchronous span stack must be balanced (``depth == 0``): an
      unclosed ``span()`` means a context manager was entered across the
      run boundary and every later duration is nested garbage.
    """
    if not getattr(tracer, "enabled", True):
        total = int(getattr(tracer, "events_total", 0))
        if total != 0:
            raise SanitizerError(
                f"disabled tracer recorded {total} events {where} — an "
                "instrumentation site bypassed the enabled check"
            )
    depth = int(getattr(tracer, "depth", 0))
    if depth != 0:
        raise SanitizerError(
            f"tracer span stack unbalanced {where}: {depth} span(s) still "
            "open at the run boundary"
        )


class compile_counter:
    """Context manager: audit an engine's compile caches on exit.

    >>> with compile_counter(engine):
    ...     engine.run()

    On a clean exit the engine is audited via :func:`audit_engine_compiles`;
    ``new_compiles`` records how many decode/prefill executables the block
    added (for tests asserting a warm second run compiles nothing).
    """

    def __init__(self, engine: Any):
        self.engine = engine
        self.new_compiles = 0
        self._before = 0

    def _count(self) -> int:
        return int(getattr(self.engine, "decode_compiles", 0)) + int(
            getattr(self.engine, "prefill_compiles", 0)
        )

    def __enter__(self) -> "compile_counter":
        self._before = self._count()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.new_compiles = self._count() - self._before
        if exc_type is None:
            audit_engine_compiles(self.engine, where="(compile_counter exit)")
