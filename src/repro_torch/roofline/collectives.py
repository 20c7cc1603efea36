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
leaves its output, in the forward and again in the recomputation; an MoE
layer's split experts gathered over the rank's expert group, its E/M
experts its output; the microbatch scalars, the norm's per-leaf dots and
each sender's share of the experts' ‖g‖² over the ``model`` group) and
all-to-alls (an MoE layer's capacity buffers to the ranks holding their
experts and the outputs back, over the ``model`` group, what the rank
receives; the gradient's slices, ``senders`` slices of the rank's shard
index of each leaf, over the whole mesh or, for split experts, the expert
group; each leaf assembled on its owner for the norm). Under tensor
parallelism (``sharded.py``'s ``_TensorGroup``) the ``model`` group's
boundaries add all-gathers along the sequence (and of the loss's row
maxima and the vocabulary's logits in serving), all-reduces and
reduce-scatters along the sequence (``cfg.tp_reduce_scatter``), each in
the forward, the recomputation and the backward. The port's all-reduce is
a reduce-scatter (M blocks of shape / M, summed in position order) and an
all-gather of the summed blocks: a ring's 2 × shape, its elements padded
to a multiple of M. The port has no
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
