"""Span/event tracer with Chrome ``trace_event`` export.

One :class:`Tracer` instance is threaded through an engine or trainer and
records host-side spans into a bounded ring buffer:

- **complete spans** (``"X"``) — a named duration, e.g. one decode tick or
  one parameter update, recorded either via the :meth:`span` context
  manager or retroactively via :meth:`complete` when the caller already
  timed the region itself (the engines do this so the float stored in
  ``stats["decode_tick_s"]`` and the float stored in the trace are the
  SAME number — percentiles derived from either source agree exactly);
- **instant events** (``"i"``) — a point in time, e.g. a sync event;
- **counter events** (``"C"``) — sampled series (pool occupancy, queue
  depth, admission stage) rendered as stacked tracks in Perfetto;
- **async request spans** (``"b"``/``"n"``/``"e"``, keyed by request id) —
  the per-request lifecycle enqueue → admit → prefill_done → first_token
  → done, which overlaps arbitrarily across requests and so cannot use
  the synchronous span stack.

Determinism contract: the tracer *observes* and never *participates*.
Every timing call goes through the injected ``clock`` seam (a reference
default, never called at import time), so lint rule R103 stays clean in
instrumented state-mutating code, and tests can inject a fake counter to
make whole traces bit-reproducible. A disabled tracer (``enabled=False``,
or the shared :data:`NULL_TRACER`) records nothing and allocates nothing
per call — instrumentation sites cost one attribute load and a truthiness
check. Tracing must not change tokens, losses, or compile counts; the
JAX package's engines assert this (``tests/test_obs.py``).

Export: :meth:`dump_chrome` writes ``{"traceEvents": [...]}`` (Chrome
``chrome://tracing`` / Perfetto ``ui.perfetto.dev`` load it directly;
timestamps converted to microseconds); :meth:`dump_jsonl` writes one raw
event per line for ad-hoc grepping. ``tools/trace_view.py`` summarizes
either format.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Tracer", "NULL_TRACER", "PHASES"]

ClockFn = Callable[[], float]

# canonical per-request lifecycle marks, in order (trace_view relies on
# this ordering to compute phase durations between consecutive marks)
PHASES = ("enqueue", "admit", "prefill_done", "first_token", "done")


class _Span:
    """Re-entrant context manager recording one complete span on exit.
    One instance per ``span()`` call when enabled; the disabled path
    returns the shared :data:`_NULL_SPAN` and allocates nothing."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer.clock()
        self._tracer._depth += 1
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._depth -= 1
        self._tracer.complete(
            self.name, self._t0, self._tracer.clock(), **(self.args or {})
        )


class _NullSpan:
    """The do-nothing span: one shared instance, zero per-call allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Bounded-ring span/event recorder. See module docstring.

    ``capacity`` bounds the ring (oldest events drop first — a long-lived
    engine ticks indefinitely and must not grow host memory without
    bound); ``events_total`` counts lifetime records so ``dropped``
    reports truncation honestly. ``clock`` is the injected monotonic
    clock seam — a callable *reference* (``time.perf_counter`` by
    default, never invoked at import), so state-mutating callers satisfy
    R103 by routing every read through ``tracer.clock()``.
    """

    def __init__(
        self,
        capacity: int = 65536,
        clock: ClockFn = time.perf_counter,
        enabled: bool = True,
    ):
        assert capacity >= 1
        self.enabled = bool(enabled)
        self.clock = clock
        self.capacity = capacity
        self.events: deque = deque(maxlen=capacity)
        self.events_total = 0
        self._depth = 0  # open synchronous spans (audit: 0 at run end)
        self._open_requests: Dict[Any, float] = {}  # rid -> begin ts

    # -- recording -----------------------------------------------------------
    def _emit(self, ev: Dict[str, Any]) -> None:
        self.events.append(ev)
        self.events_total += 1

    def span(self, name: str, **args: Any):
        """Context manager timing one synchronous region."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def complete(self, name: str, t0: float, t1: float, **args: Any) -> None:
        """Record a region the caller timed itself (phase "X"). ``t0``/``t1``
        must come from this tracer's ``clock``."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {"ph": "X", "name": name, "ts": t0, "dur": t1 - t0}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, **args: Any) -> None:
        if not self.enabled:
            return
        ev: Dict[str, Any] = {"ph": "i", "name": name, "ts": self.clock()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, **values: float) -> None:
        """One sample of a multi-series counter track."""
        if not self.enabled:
            return
        self._emit({"ph": "C", "name": name, "ts": self.clock(), "args": values})

    # -- per-request async lifecycle -----------------------------------------
    def begin_request(self, rid: Any, ts: Optional[float] = None, **args: Any) -> None:
        if not self.enabled:
            return
        t = self.clock() if ts is None else ts
        self._open_requests[rid] = t
        ev: Dict[str, Any] = {"ph": "b", "name": "request", "id": rid, "ts": t}
        if args:
            ev["args"] = args
        self._emit(ev)

    def mark_request(self, rid: Any, name: str, ts: Optional[float] = None, **args) -> None:
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "ph": "n",
            "name": name,
            "id": rid,
            "ts": self.clock() if ts is None else ts,
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    def end_request(self, rid: Any, ts: Optional[float] = None, **args: Any) -> None:
        if not self.enabled:
            return
        self._open_requests.pop(rid, None)
        ev: Dict[str, Any] = {
            "ph": "e",
            "name": "request",
            "id": rid,
            "ts": self.clock() if ts is None else ts,
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    # -- introspection -------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Events lost to ring overflow."""
        return self.events_total - len(self.events)

    @property
    def depth(self) -> int:
        """Currently-open synchronous spans (0 when balanced)."""
        return self._depth

    @property
    def open_requests(self) -> int:
        """Requests begun but not ended (0 after a drained run)."""
        return len(self._open_requests)

    def durations(self, name: str) -> List[float]:
        """All recorded durations of complete spans called ``name``, in
        record order — the exact floats handed to :meth:`complete`."""
        return [e["dur"] for e in self.events if e["ph"] == "X" and e["name"] == name]

    def clear(self) -> None:
        """Drop every buffered event and zero the lifetime counter — the
        measurement-window seam (pairs with ``engine.reset_stats()``)."""
        self.events.clear()
        self.events_total = 0
        self._open_requests.clear()

    def assert_balanced(self, where: str = "") -> None:
        if self._depth != 0:
            raise AssertionError(
                f"tracer span stack unbalanced {where}: depth={self._depth}"
            )

    # -- export --------------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON object: seconds → integer µs, one
        process/thread (host-side trace), displayTimeUnit ms."""
        out: List[Dict[str, Any]] = []
        for e in self.events:
            ev: Dict[str, Any] = {
                "name": e["name"],
                "ph": e["ph"],
                "ts": round(e["ts"] * 1e6, 3),
                "pid": 0,
                "tid": 0,
            }
            if e["ph"] == "X":
                ev["dur"] = round(e["dur"] * 1e6, 3)
            if e["ph"] in ("b", "n", "e"):
                ev["cat"] = "request"
                ev["id"] = e["id"]
            if e["ph"] == "i":
                ev["s"] = "t"  # thread-scoped instant
            if "args" in e:
                ev["args"] = e["args"]
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def dump_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")


#: Shared disabled tracer: every instrumentation default. Records nothing,
#: allocates nothing per call; its ``clock`` is still real so engines can
#: unconditionally route their timing reads through ``tracer.clock()``.
NULL_TRACER = Tracer(capacity=1, enabled=False)
