"""Data pipeline with SEBS-driven dynamic batch sizes.

The pipeline is indexed by *samples consumed*, not steps: the SEBS stage
controller converts the consumed-sample count into the current stage's
batch size, and the pipeline materializes exactly that many new samples as
the next batch, as tensors on its device. Batch contents depend only on
(seed, sample_offset), so the whole pipeline state is the single integer
``samples_consumed``.

With a mesh (``DataPipeline(ds, mesh)``, as in the JAX package) the batch
goes to this worker's device of the mesh (rank 0's outside a worker
process); every worker draws the whole batch, keyed by sample offset, and
takes its own microbatches, so the rows do not depend on the mesh.
"""
from __future__ import annotations

import torch

from repro_torch.data.synthetic import TokenDataset
from repro_torch.launch.mesh import Mesh


class DataPipeline:
    def __init__(self, ds: TokenDataset, device="cuda", *, mesh: Mesh = None):
        if isinstance(device, Mesh):  # DataPipeline(ds, mesh), as the JAX package's
            device, mesh = None, device
        self.ds = ds
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.device_of(_rank())
        self.samples_consumed = 0

    def next_batch(self, batch_size: int) -> dict:
        batch = self.ds.batch(self.samples_consumed, batch_size)
        self.samples_consumed += batch_size
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def state(self) -> dict:
        return {"samples_consumed": self.samples_consumed}

    def restore(self, state: dict) -> None:
        self.samples_consumed = int(state["samples_consumed"])


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
