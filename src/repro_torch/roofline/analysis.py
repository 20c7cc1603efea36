"""Three-term roofline from dry-run counts, the JAX package's
``roofline/analysis.py`` with the H100's published peaks.

Terms (seconds, per executed step, whole job divided over cards):
    compute    = FLOPs / (cards × peak_FLOP/s)
    memory     = bytes / (cards × HBM_bw)
    collective = collective_wire_bytes / (cards × link_bw)

Hardware constants: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates): 989 TFLOP/s bf16, 3.35 TB/s HBM, NVLink 450 GB/s
each way (the per-device wire bytes are charged against it). A mesh larger
than one host's 8 cards crosses the network between hosts, at a lower rate
than NVLink, which this roofline does not model.

The counts are per device (rank 0's step, ``launch/dryrun.py``), as XLA's
cost analysis of the partitioned module is in the JAX package.

MODEL_FLOPS uses the standard 6·N·D (train) / 2·N·D (inference forward)
with N = active parameter count (MoE: top-k active experts).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

# NVIDIA H100 SXM (published peaks at the full power limit)
HW = {
    "card": "NVIDIA H100 SXM, 700 W",
    "peak_flops": 989e12,   # bf16 FLOP/s per card (dense)
    "hbm_bw": 3.35e12,      # bytes/s per card
    "link_bw": 450e9,       # bytes/s per card each way over NVLink
}


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    useful_ratio: float  # MODEL_FLOPS / counted FLOPs (all devices)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def roofline_fraction(self) -> float:
        """compute / max(term): 1.0 = perfectly compute-bound."""
        m = max(self.compute_s, self.memory_s, self.collective_s)
        return self.compute_s / m if m else 0.0


def model_flops_for(kind: str, active_params: int, tokens: int) -> float:
    """6ND for training (fwd+bwd), 2ND for inference forward passes."""
    per_token = 6 if kind == "train" else 2
    return float(per_token * active_params * tokens)


def roofline_from_summary(
    summary: Dict,
    *,
    flops: Optional[float] = None,
    hbm_bytes: Optional[float] = None,
    collective_bytes: Optional[float] = None,
) -> RooflineTerms:
    """summary: a dry-run JSON dict. Optional overrides supply the
    depth-extrapolated numbers (see ``roofline/extrapolate.py``)."""
    chips = summary["devices"]
    flops = flops if flops is not None else summary["cost"]["flops"]
    hbm = hbm_bytes if hbm_bytes is not None else summary["cost"]["bytes_accessed"]
    # the recorded collective bytes are per-device wire bytes
    coll = (
        collective_bytes
        if collective_bytes is not None
        else summary["collectives"]["total_bytes"]
    )
    kind = summary.get("kind", "train")
    tokens = summary["global_batch"] * (summary["seq_len"] if kind != "decode" else 1)
    n_active = summary["param_counts"]["active"]
    mf = model_flops_for(kind, n_active, tokens)

    # the counts are rank 0's, per device; MODEL_FLOPS is global, so it is
    # compared against flops × devices
    return RooflineTerms(
        compute_s=flops / HW["peak_flops"],
        memory_s=hbm / HW["hbm_bw"],
        collective_s=coll / HW["link_bw"],
        model_flops=mf,
        hlo_flops=flops * chips,
        useful_ratio=(mf / (flops * chips)) if flops else 0.0,
    )
