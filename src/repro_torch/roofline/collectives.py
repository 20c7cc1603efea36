"""Collective-byte accounting from a recorded step, the port's counterpart
of the JAX package's ``roofline/hlo.py`` (which parses compiled HLO; the
port has none). The dry run's recording transport
(``launch/dryrun.py``'s ``RecordingExchange``) feeds every collective the
step makes to a :class:`CollectiveLog`, with ``hlo.py``'s wire-byte
conventions, per device:

- all-reduce: 2 × shape (reduce-scatter + all-gather phases of a ring)
- all-gather: output shape (each device receives the gathered result)
- reduce-scatter / all-to-all / collective-permute / broadcast: shape

The port's sharded step makes all-gathers only: each shard gather (the
whole leaf is its output) and the exchange of partial sums (``senders``
partials of each leaf). None of them is inside the microbatch loop, so
``in_while_bytes`` is 0: the step gathers once, computes its microbatches
and exchanges once.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict


class CollectiveLog:
    """Every collective of a step, by type: its wire bytes and count."""

    def __init__(self):
        self.by_type_bytes: Dict[str, int] = defaultdict(int)
        self.by_type_count: Dict[str, int] = defaultdict(int)

    def record(self, op: str, result_bytes: int) -> None:
        """One collective whose result is ``result_bytes`` on this device."""
        self.by_type_bytes[op] += 2 * result_bytes if op == "all-reduce" else result_bytes
        self.by_type_count[op] += 1

    def summary(self) -> Dict:
        """``hlo.collective_stats``' keys (nothing inside a loop: ``in_while_bytes`` 0)."""
        return {
            "total_bytes": int(sum(self.by_type_bytes.values())),
            "in_while_bytes": 0,
            "by_type_bytes": dict(self.by_type_bytes),
            "by_type_count": dict(self.by_type_count),
        }
