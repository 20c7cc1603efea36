"""Counter/gauge/histogram registry with labeled series.

The registry is the *aggregated* half of the obs subsystem (the tracer is
the per-event half): engines and trainers route their accounting through
one :class:`MetricsRegistry` so every benchmark reads the same numbers the
same way — ``TrainLog.comm_bytes`` and the distributed
``CommAccountant`` are re-exported here rather than re-counted.

Histograms use fixed bucket bounds (geometric, see :func:`time_buckets`)
so percentiles come from bucket counts without storing samples: memory is
O(buckets) however long the run. :meth:`Histogram.percentile` applies the
same nearest-rank rule as :func:`nearest_rank` over the bucketed counts
and returns the upper bound of the bucket holding the rank-th sample —
deterministic, and exact at bucket resolution. When sample-exact
percentiles are needed (the serve benchmark's SLO numbers), derive them
from tracer span durations with :func:`nearest_rank`; the consistency
between the two paths is pinned by ``tests/test_obs.py``.

Like the tracer, the registry is deterministic-by-construction: no clock,
no randomness, insertion-independent ``snapshot()`` (keys sorted), and a
disabled registry (:data:`NULL_METRICS`) hands out shared no-op
instruments so instrumentation sites never branch.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_METRICS",
    "nearest_rank",
    "time_buckets",
]


def nearest_rank(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest element with at least
    ``q/100`` of the sample at or below it — ``sorted(xs)[ceil(q/100·n)-1]``.
    Pure-python port of the serve benchmark's ``_pct`` (its
    ``PERCENTILE_METHOD = "nearest-rank"``), bit-identical on the same
    floats. NaN on an empty sample."""
    n = len(xs)
    if n == 0:
        return float("nan")
    rank = math.ceil(q / 100.0 * n)
    return sorted(xs)[max(rank, 1) - 1]


def time_buckets() -> Tuple[float, ...]:
    """Default latency bucket upper bounds: powers of two from ~1 µs to
    64 s. Geometric spacing gives constant relative error (~2x) across six
    decades — decode ticks, prefill chunks, and full updates all land in
    resolvable buckets of one shared layout."""
    return tuple(2.0 ** e for e in range(-20, 7))  # 9.5e-7 .. 64.0


class Counter:
    """Monotonic accumulator (events, bytes, tokens)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        assert amount >= 0, "counters only go up; use a Gauge"
        self.value += amount

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins sample (queue depth, GNS, current stage)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = float("nan")

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` holds samples ≤ ``bounds[i]``
    (first bucket also catches everything below it); samples above the last
    bound land in an overflow bucket. Tracks count/sum/min/max exactly."""

    __slots__ = ("bounds", "counts", "overflow", "count", "sum", "min", "max")

    def __init__(self, bounds: Optional[Sequence[float]] = None) -> None:
        self.bounds: Tuple[float, ...] = tuple(bounds) if bounds else time_buckets()
        assert list(self.bounds) == sorted(self.bounds), "bounds must ascend"
        self.counts: List[int] = [0] * len(self.bounds)
        self.overflow = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x: float) -> None:
        self.count += 1
        self.sum += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        # bisect by hand keeps the slots-only class stdlib-trivial; bucket
        # counts are tiny (≤ ~30 bounds)
        for i, b in enumerate(self.bounds):
            if x <= b:
                self.counts[i] += 1
                return
        self.overflow += 1

    def percentile(self, q: float) -> float:
        """Nearest-rank over bucket counts: the upper bound of the bucket
        containing the rank-th sample (``self.max`` for the overflow
        bucket — exact, since max is tracked exactly). NaN when empty."""
        if self.count == 0:
            return float("nan")
        rank = max(math.ceil(q / 100.0 * self.count), 1)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.bounds[i]
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def snapshot(self) -> Dict[str, Any]:
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class _NullInstrument:
    """Shared no-op standing in for every instrument of a disabled
    registry — instrumentation sites call ``inc``/``set``/``observe``
    unconditionally."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, x: float) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "null"}


_NULL_INSTRUMENT = _NullInstrument()

LabelPairs = Tuple[Tuple[str, str], ...]


def _key(name: str, labels: Optional[Dict[str, Any]]) -> Tuple[str, LabelPairs]:
    if not labels:
        return name, ()
    return name, tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create registry of labeled instruments.

    One series per ``(name, sorted label pairs)``; re-requesting returns
    the same instrument, so call sites don't cache. ``snapshot()`` and
    ``dump()`` emit sorted keys — two runs recording the same values
    serialize byte-identically regardless of instrumentation order."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = bool(enabled)
        self._series: Dict[Tuple[str, LabelPairs], Any] = {}

    def _get(self, cls, name: str, labels: Optional[Dict[str, Any]], **kw):
        if not self.enabled:
            return _NULL_INSTRUMENT
        key = _key(name, labels)
        inst = self._series.get(key)
        if inst is None:
            inst = self._series[key] = cls(**kw)
        assert isinstance(inst, cls), f"{key} already registered as {type(inst).__name__}"
        return inst

    def counter(self, name: str, labels: Optional[Dict[str, Any]] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[Dict[str, Any]] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(
        self,
        name: str,
        labels: Optional[Dict[str, Any]] = None,
        bounds: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def __len__(self) -> int:
        return len(self._series)

    def snapshot(self) -> Dict[str, Any]:
        """``{"name{k=v,...}": instrument snapshot}``, keys sorted."""
        out: Dict[str, Any] = {}
        for (name, labels), inst in self._series.items():
            key = name
            if labels:
                key += "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
            out[key] = inst.snapshot()
        return dict(sorted(out.items()))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")


#: Shared disabled registry: every instrumentation default.
NULL_METRICS = MetricsRegistry(enabled=False)
