"""Collective-byte accounting from a recorded step, the port's counterpart
of the JAX package's ``roofline/hlo.py`` (which parses compiled HLO; the
port has none). The dry run's recording transport
(``launch/dryrun.py``'s ``RecordingExchange``) feeds every collective the
step makes to a :class:`CollectiveLog`, with ``hlo.py``'s wire-byte
conventions, per device:

- all-reduce: 2 × shape (reduce-scatter + all-gather phases of a ring)
- all-gather: output shape (each device receives the gathered result)
- reduce-scatter / all-to-all / collective-permute / broadcast: shape

The port's sharded step makes all-gathers (each layer's gather, the whole
leaves its output, in the forward and again in the recomputation; the
microbatch scalars and the norm's per-leaf dots) and all-to-alls (the
gradient's slices, ``senders`` slices of the rank's shard index of each
leaf; each leaf assembled on its owner for the norm). The port has no
loop to count once: a step's microbatches are recorded call by call, so
``in_while_bytes`` is 0.
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
