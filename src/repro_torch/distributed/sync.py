"""Synchronization policy and communication accounting for elastic data
parallelism: the port's own copy of the JAX package's ``distributed/sync.py``
(integer logic, equal to it for every input).

Two sync modes, selected per run:

- ``exact``: one gradient collective per optimizer update (an all-gather of
  the replicas' partial sums and the canonical tree combine, so results are
  bit-identical across widths). SEBS already makes this cheap: stage s packs
  rho^s microbatches into each update, so the per-sample collective rate
  falls geometrically.
- ``local``: local SGD (periodic parameter averaging): replicas take
  ``interval(stage)`` independent optimizer steps between parameter
  averages. The interval is keyed to the SEBS stage
  (``H_s = round(H_1 * growth^s)``), a second geometric saving on top of the
  batch ladder.

The :class:`CommAccountant` records what the byte models say moved: per-stage
update counts, sync collectives and per-device bytes (a ring all-gather of B
bytes over W replicas receives (W-1)*B per device; a ring all-reduce moves
2*(W-1)/W*B per device). It models the synchronizations, not the transport
the port uses for them (gloo, host-staged, leaf by leaf). Counters are
cumulative and checkpointed (state()/restore()), so they survive resume.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

SYNC_MODES = ("exact", "local")


def allgather_bytes_per_device(payload_bytes: int, width: int) -> int:
    """Ring all-gather: every device receives the other W−1 shards."""
    return (width - 1) * payload_bytes if width > 1 else 0


def allreduce_bytes_per_device(payload_bytes: int, width: int) -> int:
    """Ring all-reduce: reduce-scatter + all-gather, 2·(W−1)/W·B each way."""
    return int(2 * (width - 1) * payload_bytes / width) if width > 1 else 0


def sync_cost(mode: str, width: int, *, grad_bytes: int, state_bytes: int) -> tuple[int, int]:
    """Per-device (collectives, bytes) of ONE synchronization at ``width``.

    exact → all-gather of the f32 gradient partial sums; local → all-reduce
    of the float train state. Single source of truth for both the live
    :class:`~repro_torch.distributed.trainer.ElasticTrainer` ledger and the
    schedule-only accounting in experiments/table_comm.py — the published
    table cannot drift from what the trainer records."""
    if width <= 1:
        return 0, 0
    if mode == "exact":
        return 1, allgather_bytes_per_device(grad_bytes, width)
    return 1, allreduce_bytes_per_device(state_bytes, width)


@dataclass
class SyncScheduler:
    """When to synchronize, as a pure function of (update, stage)."""

    mode: str = "exact"
    local_interval: int = 4
    local_growth: float = 1.0

    def __post_init__(self):
        if self.mode not in SYNC_MODES:
            raise ValueError(f"sync mode {self.mode!r} not in {SYNC_MODES}")
        if self.local_interval < 1:
            raise ValueError("local_interval must be >= 1")

    def interval(self, stage: int) -> int:
        """Optimizer updates between parameter averages in ``local`` mode."""
        if self.mode == "exact":
            return 1
        return max(1, int(round(self.local_interval * self.local_growth**stage)))

    def due(self, update: int, last_sync: int, stage: int) -> bool:
        return update - last_sync >= self.interval(stage)


class CommAccountant:
    """Per-stage ledger of synchronization traffic (per-device byte model)."""

    FIELDS = ("updates", "sync_events", "collectives", "bytes", "reshard_events", "reshard_bytes")

    def __init__(self):
        self.per_stage: Dict[int, Dict[str, int]] = {}

    def _row(self, stage: int) -> Dict[str, int]:
        return self.per_stage.setdefault(stage, {f: 0 for f in self.FIELDS})

    def record_update(self, stage: int, *, collectives: int = 0, bytes_moved: int = 0) -> None:
        row = self._row(stage)
        row["updates"] += 1
        row["collectives"] += collectives
        row["bytes"] += bytes_moved
        if collectives:
            row["sync_events"] += 1

    def record_reshard(self, stage: int, *, bytes_moved: int = 0) -> None:
        """An elastic width transition (broadcast / stage-boundary average)."""
        row = self._row(stage)
        row["reshard_events"] += 1
        row["reshard_bytes"] += bytes_moved

    # -- cumulative totals ---------------------------------------------------

    def total(self, field: str) -> int:
        return sum(row[field] for row in self.per_stage.values())

    @property
    def total_bytes(self) -> int:
        return self.total("bytes") + self.total("reshard_bytes")

    @property
    def total_sync_events(self) -> int:
        return self.total("sync_events")

    def summary(self) -> Dict[str, Dict[str, int]]:
        return {str(s): dict(row) for s, row in sorted(self.per_stage.items())}

    # -- checkpoint round-trip (json meta: stage keys go through str) --------

    def state(self) -> dict:
        return {"per_stage": self.summary()}

    def restore(self, state: dict) -> None:
        self.per_stage = {
            int(s): {f: int(row.get(f, 0)) for f in self.FIELDS}
            for s, row in state.get("per_stage", {}).items()
        }
