"""Count traced runs that come back from torch.profiler with no device
record, or with fewer than they launched, with and without the idle padding
that ``cardbench.device_trace`` puts around a run (``TRACE_PAD_S``).

Each round traces, at each padding, three short runs: the flash backward at
D 80 ten times (B 4, S 513, 32/32 heads, bf16: zamba2's training shape),
the flash forward twenty times, and ten in-place multiplies of 2**20 floats.
Prints the card's name and power limit and, for each run and padding, the
traces taken, how many were empty and how many device records each held.

    python3 tools/trace_check.py [--rounds 60]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "chiprun_out"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=60)
    args = parser.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tools")]
    import torch

    import cardbench as cb
    from repro_torch.kernels.flash_attention import ops

    if not torch.cuda.is_available():
        sys.exit("trace_check: needs a CUDA device")
    print(cb.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, d_out = (torch.randn((4, 513, 32, 80), generator=gen, device="cuda").to(torch.bfloat16)
                      for _ in range(4))
    out, lse = ops.forward(q, k, v)
    x = torch.randn(1 << 20, device="cuda")
    runs = {
        "flash_bwd_x10": lambda: [ops.backward(q, k, v, out, lse, d_out) for _ in range(10)],
        "flash_fwd_x20": lambda: [ops.forward(q, k, v) for _ in range(20)],
        "mul_x10": lambda: [x.mul_(1.0000001) for _ in range(10)],
    }
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    counts: dict = {}
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        for pad in (0.0, cb.TRACE_PAD_S):
            for name, run in runs.items():
                trace = cb._trace_once(run, OUT_DIR, pad)
                row = counts.setdefault(f"{name} pad {pad}", {"traces": 0, "empty": 0, "records": {}})
                n = 0 if trace is None else trace["activities"]
                row["traces"] += 1
                row["empty"] += trace is None
                row["records"][n] = row["records"].get(n, 0) + 1
    print(json.dumps({"seconds": time.perf_counter() - t0, "counts": counts}), flush=True)


if __name__ == "__main__":
    main()
