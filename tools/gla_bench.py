#!/usr/bin/env python3
"""Checks and times the GLA kernels of one tree on one GPU.

    python3 tools/gla_bench.py [--tree DIR] [--label NAME] [--iters N] [--stamps]

Builds DIR's ``gla`` library (default: this checkout), prints ptxas'
registers and spills and the tensor-core instructions (HMMA, HGMMA) in the
SASS of each of its kernels, holds the bf16 forward (rwkv6-1.6b's training
shape B 4, S 513, H 32, and its serving shape B 1, S 256 from a state) and
backward (training shape) against the plain recurrence within
chip_smoke.py's GLA_TOL, and times each through its ``ops`` wrapper:
L2-cold ms a call (inputs rotating over copies larger than L2, CUDA
events) and device ms a call (its kernels' busy time under
torch.profiler), with the time of each kernel of the call. The last line
is one JSON object. To compare two trees on one card, run it for each in
one command, in turns (old, new, new, old). With ``--stamps`` it builds
the measurement variant (-DGLA_CLOCK_STAMPS), runs the forward and the
backward once at the training shape and prints, for one block of each
per-chunk pass, the cycles each warp spent in each section of the kernel
(clock64 stamps), instead of timing. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import cardbench as cb

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "chiprun_out"
# chip_smoke.py's GLA_TOL: (relative, share of the largest value)
TOL = {"float32": (1e-4, 1e-4), "y": (2.0**-7, 1e-3), "grad": (2.0**-6, 1e-3)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--stamps", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    if args.stamps:
        os.environ["REPRO_TORCH_NVCC_EXTRA"] = "-DGLA_CLOCK_STAMPS"

    import torch

    from repro_torch.kernels.gla import ops, ref

    if not torch.cuda.is_available():
        sys.exit("gla_bench: needs a CUDA device")
    smi = cb.nvidia_smi()
    cb.build_report("gla")

    gen = torch.Generator(device="cuda").manual_seed(6)

    def inputs(b, s, h, initial_state):
        def rand(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale
        q, k, v, dy = (rand(b, s, h, 64).to(torch.bfloat16) for _ in range(4))
        lw = -torch.exp(torch.linspace(-6, -1, 64, device="cuda") + rand(b, s, h, 64, scale=0.5))
        return q, k, v, lw, rand(h, 64, scale=0.5), rand(b, h, 64, 64, scale=0.3) if initial_state else None, dy

    def excess(out, expect, tol):
        rtol, stol = TOL[tol]
        err = (out.float() - expect.float()).abs()
        return (err / (rtol * expect.float().abs() + stol * expect.float().abs().max())).max().item()

    if args.stamps:
        clock_stamps(ops, inputs, smi)
        return
    out = {"label": args.label, "tree": str(args.tree), "nvidia_smi": smi}
    fails = []

    def record(name, readings):
        for key, x in readings.items():
            if not x <= 1:
                fails.append(f"{name} {key} {x:.3f}")
        out.setdefault("excess", {})[name] = readings

    # training shape, forward and backward
    q, k, v, lw, u, _, dy = inputs(4, 513, 32, False)
    y, final, states = ops.forward(q, k, v, lw, u, include_current=False, save_states=True)
    ey, ef = ref.gla_fwd_ref(q, k, v, lw, bonus_u=u, include_current=False)
    record("fwd_train", {"y": excess(y, ey, "y"), "final": excess(final, ef, "float32")})
    grads = ops.backward(q, k, v, lw, u, None, states, final, dy, None, include_current=False)
    again = ops.backward(q, k, v, lw, u, None, states, final, dy, None, include_current=False)
    out["bwd_same_bits"] = all(torch.equal(a, b) for a, b in zip(grads, again) if a is not None)
    expect = ref.gla_bwd_ref(q, k, v, lw, u, None, dy, None, include_current=False)
    record("bwd_train", {n: excess(g, e, "grad" if g.dtype == torch.bfloat16 else "float32")
                         for n, g, e in zip(("dq", "dk", "dv", "dlog_w", "du"), grads, expect)})
    sets = [(q.clone(), k.clone(), v.clone(), lw.clone(), u) for _ in range(cb.copies_for(cb.nbytes(q, k, v, lw)))]
    bwd_sets = [(*x, None, states.clone(), final.clone(), dy.clone(), None) for x in sets]
    fwd = lambda *a: ops.forward(*a, include_current=False, save_states=True)
    bwd = lambda *a: ops.backward(*a, include_current=False)
    out["fwd_train"] = {"ms": cb.timed(fwd, sets, args.iters), "device": cb.device_ms(fwd, sets, 20, OUT_DIR)}
    out["bwd_train"] = {"ms": cb.timed(bwd, bwd_sets, args.iters),
                         "device": cb.device_ms(bwd, bwd_sets, 20, OUT_DIR)}
    del sets, bwd_sets, grads, again, expect
    # serving shape: one 256-token prefill chunk from a carried state
    q, k, v, lw, u, s0, _ = inputs(1, 256, 32, True)
    y, final, _ = ops.forward(q, k, v, lw, u, s0, include_current=False)
    ey, ef = ref.gla_fwd_ref(q, k, v, lw, bonus_u=u, include_current=False, initial_state=s0)
    record("fwd_serve", {"y": excess(y, ey, "y"), "final": excess(final, ef, "float32")})
    sets = [(q.clone(), k.clone(), v.clone(), lw.clone(), u, s0.clone())
            for _ in range(cb.copies_for(cb.nbytes(q, k, v, lw, s0)))]
    fwd = lambda *a: ops.forward(*a, include_current=False)
    out["fwd_serve"] = {"ms": cb.timed(fwd, sets, 2 * args.iters), "device": cb.device_ms(fwd, sets, 20, OUT_DIR)}
    for key in ("fwd_train", "bwd_train", "fwd_serve"):
        ms, (dev, per) = out[key]["ms"], out[key]["device"]
        out[key] = {"ms": ms, "device_ms": dev, "kernels_device_ms": per}
        print(f"{args.label} {key}: {ms:.4f} ms a call L2-cold, device {dev:.4f} ms | " + ", ".join(
            f"{n[:60]} {t:.4f}" for n, t in per.items()), flush=True)
    print(f"{args.label} tolerance readings (<= 1 passes): {out['excess']} | backward same bits: "
          f"{out['bwd_same_bits']}", flush=True)
    print(json.dumps(out))
    if fails or not out["bwd_same_bits"]:
        sys.exit(f"gla_bench: FAIL {fails} same bits {out['bwd_same_bits']}")


# Section names of the stamps of each per-chunk pass, in the kernels' order.
STAMP_SECTIONS = {
    "fwd_out": ["loads, W, coef", "A off-diagonal", "A diagonal (exps)", "A v", "(q exp(E)) S_n",
                "store y"],
    "bwd_chunk": ["loads, W, coef, dyv", "dq (off-diagonal, S_n)", "dk (off-diagonal, dS)",
                  "dv from the forward's A", "dv dS, store; dA diagonal", "diagonal decays: dq, dk",
                  "store dq dk", "dE, dW to shared", "dlog_w, du"],
    "local": ["loads, W", "products", "store"],
}


def clock_stamps(ops, inputs, smi) -> None:
    """One forward and backward at the training shape in the stamped build;
    print each warp's cycles per section for the stamped block of each
    pass."""
    import torch

    q, k, v, lw, u, _, dy = inputs(4, 513, 32, False)
    for _ in range(2):  # the second run's stamps: code and data warm
        y, final, states = ops.forward(q, k, v, lw, u, include_current=False, save_states=True)
        ops.backward(q, k, v, lw, u, None, states, final, dy, None, include_current=False)
    torch.cuda.synchronize()
    warps, slots = 4, 16  # kWarps, kStamps in gla.cu
    raw = cb.read_stamps("gla", "gla_clock_stamps", 3 * warps * slots)
    out = {"nvidia_smi": smi, "note": "the local pass's stamps are the backward's (it runs last)"}
    for pi, name in enumerate(("fwd_out", "bwd_chunk", "local")):
        rows = {}
        for w in range(warps):
            st = [raw[(pi * warps + w) * slots + j] for j in range(len(STAMP_SECTIONS[name]) + 1)]
            rows[w] = [b - a for a, b in zip(st, st[1:])]
        out[name] = {sec: [rows[w][j] for w in range(warps)] for j, sec in enumerate(STAMP_SECTIONS[name])}
        total = [sum(rows[w]) for w in range(warps)]
        print(f"stamps {name}: cycles per warp (warps 0..{warps - 1}), total {total}")
        for sec, cyc in out[name].items():
            print(f"  {sec:36s} {cyc}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
