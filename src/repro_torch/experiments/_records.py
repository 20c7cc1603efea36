"""The experiments' metric record, the port's own copy of the JAX
package's benchmark ``Record``: one observation with its unit, the
direction that gates it, a readable summary and supporting numbers."""
from __future__ import annotations

import argparse
import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable

import torch

DIRECTIONS = ("higher", "lower", "exact", "info")
CSV_HEADER = "name,value,unit,derived"
DEFAULT_OUT = "chiprun_out/experiments"


@dataclass
class Record:
    name: str
    value: float
    unit: str
    direction: str = "info"
    derived: str = ""
    context: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.direction not in DIRECTIONS:
            raise ValueError(f"{self.name}: bad direction {self.direction!r}")
        self.value = float(self.value)
        if not math.isfinite(self.value):
            raise ValueError(f"{self.name}: non-finite value {self.value!r}")

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "value": self.value, "unit": self.unit, "direction": self.direction,
                "derived": self.derived, "context": self.context}

    def csv_row(self) -> str:
        # derived strings may contain commas; they live in the last column
        return f"{self.name},{self.value:g},{self.unit},{self.derived}"


def print_csv(records: Iterable[Record], header: bool = True) -> None:
    if header:
        print(CSV_HEADER)
    for r in records:
        print(r.csv_row())


def write_json(out_dir: str, name: str, payload) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    return path


def cli(description: str, device: bool = True) -> argparse.Namespace:
    """``--device`` (cuda by default; raises when CUDA is missing; left out
    for an experiment that runs on no device) and ``--out``."""
    ap = argparse.ArgumentParser(description=description)
    if device:
        ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=DEFAULT_OUT, help="directory of the JSON results")
    args = ap.parse_args()
    if device and args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA device, and none is available; "
                           "pass --device cpu to run on the CPU")
    return args
