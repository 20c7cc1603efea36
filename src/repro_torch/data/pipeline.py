"""Data pipeline with SEBS-driven dynamic batch sizes.

The pipeline is indexed by *samples consumed*, not steps: the SEBS stage
controller converts the consumed-sample count into the current stage's
batch size, and the pipeline materializes exactly that many new samples as
the next batch, as tensors on its device. Batch contents depend only on
(seed, sample_offset), so the whole pipeline state is the single integer
``samples_consumed``. The port runs in one process: there is no mesh.
"""
from __future__ import annotations

import torch

from repro_torch.data.synthetic import TokenDataset


class DataPipeline:
    def __init__(self, ds: TokenDataset, device="cuda"):
        self.ds = ds
        self.device = torch.device(device)
        self.samples_consumed = 0

    def next_batch(self, batch_size: int) -> dict:
        batch = self.ds.batch(self.samples_consumed, batch_size)
        self.samples_consumed += batch_size
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def state(self) -> dict:
        return {"samples_consumed": self.samples_consumed}

    def restore(self, state: dict) -> None:
        self.samples_consumed = int(state["samples_consumed"])
