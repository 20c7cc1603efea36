#!/usr/bin/env python3
"""Checks and times the fused sampler of one tree on one GPU.

    python3 tools/sample_bench.py [--tree DIR] [--label NAME] [--iters N] [--stamps]

Builds DIR's ``fused_sample`` library (default: this checkout), prints
ptxas' registers and spills, then holds the sampler's tokens, through its
``ops`` wrapper, against the plain version (``ref.fused_sample_ref``)
exactly, and against the step-for-step plain version
(``fused_sample_split_ref``) where the tree has one, and times each call:
L2-cold ms a call (inputs rotating over copies larger than L2, CUDA
events) and device ms a call (its kernels' busy time under torch.profiler).
Shapes: chip_smoke.py phase 3's 8 rows of qwen2.5-3b's vocabulary (151,936:
two greedy, t = 0.8 with top_k 0, 1, 50, 50 with a five-fold 50th value,
and V + 7), the same with top_k 1,000 and 40,000 in place of the 50s, one
row (a request's first token, t = 0.8, top_k 50) and rwkv6-1.6b's
vocabulary (65,536) at 8 rows. Each reading carries the grid (splits a
row, blocks) where the tree states it, and the bound: the bytes and
operations these rows need (cardbench.sampler_work: every logit once, the
noise of the logits each row scores) at 3.35 TB/s and 67 TFLOP/s (f32).
As a yardstick, torch.topk(logits, 50) alone at 8 rows of 151,936. The
last line is one JSON object. To compare two trees on one card, run it
for each in one command, in turns (old, new, new, old). ``--stamps`` builds
the measurement variant (-DSAMPLE_CLOCK_STAMPS) and prints, for each shape
and row kind (greedy, keep-all, top-k), the mean cycles a block spends in
each section of the slice pass and of the merge (clock64 of thread 0),
instead of timing. Needs a CUDA device.
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
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12  # H100 SXM, NVIDIA's data sheet
SHAPES = [  # name: (batch, vocab, top_k in place of the 50s)
    ("b8_v151936", 8, 151936, None),
    ("b8_v151936_k1000", 8, 151936, 1000),
    ("b8_v151936_k40000", 8, 151936, 40000),
    ("b1_v151936", 1, 151936, None),
    ("b8_v65536", 8, 65536, None),
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--stamps", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    if args.stamps:
        os.environ["REPRO_TORCH_NVCC_EXTRA"] = (os.environ.get("REPRO_TORCH_NVCC_EXTRA", "")
                                                + " -DSAMPLE_CLOCK_STAMPS")

    import torch

    from repro_torch.kernels.paged_decode import kernel, ops, ref

    if not torch.cuda.is_available():
        sys.exit("sample_bench: needs a CUDA device")
    smi = cb.nvidia_smi()
    cb.build_report("fused_sample")
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {"label": args.label, "tree": str(args.tree), "nvidia_smi": smi}
    if args.stamps:
        clock_stamps(ops, gen, out)
        return
    fails = []
    for name, b, v, k in SHAPES:
        inputs = cb.sampler_rows(gen, b, v, k)
        got = ops.fused_sample(*inputs)
        expect = ref.fused_sample_ref(*inputs)
        reading = {"mismatched": int((got != expect).sum()),
                   "same_twice": bool(torch.equal(got, ops.fused_sample(*inputs)))}
        layout = getattr(kernel, "sample_layout", None)
        if layout is not None:
            splits = layout(b, v)[1]
            reading["grid"] = {"splits": splits, "blocks": b * splits}
            split = ref.fused_sample_split_ref(*inputs, splits)
            reading["split_ref_mismatched"] = int((split.to(expect.device) != expect).sum())
        if reading["mismatched"] or reading.get("split_ref_mismatched") or not reading["same_twice"]:
            fails.append(f"{name}: {reading}")
        logits, noise, temperature, top_k = inputs
        sets = [(logits.clone(), noise.clone(), temperature, top_k)
                for _ in range(cb.copies_for(cb.nbytes(logits, noise)))]
        work_bytes, work_ops = cb.sampler_work(logits, temperature, top_k)
        dev, per = cb.device_ms(ops.fused_sample, sets, 50, OUT_DIR)
        reading.update(ms=cb.timed(ops.fused_sample, sets, args.iters), device_ms=dev, kernels_device_ms=per,
                       bound_ms=max(work_bytes / HBM_BYTES_PER_S, work_ops / F32_FLOPS) * 1e3,
                       bound_bytes=work_bytes)
        out[name] = reading
        print(f"{args.label} {name}: {reading['ms']:.4f} ms a call L2-cold, device {dev:.4f} ms, bound "
              f"{reading['bound_ms']:.5f} ms | grid {reading.get('grid')} | mismatched {reading['mismatched']} "
              f"(split plain version {reading.get('split_ref_mismatched')}), same twice {reading['same_twice']} | "
              + ", ".join(f"{n[:60]} {t:.4f}" for n, t in per.items()), flush=True)
        del sets

    logits = cb.sampler_rows(gen, 8, 151936)[0]
    sets = [(logits.clone(),) for _ in range(cb.copies_for(cb.nbytes(logits)))]

    def topk(x):
        return torch.topk(x, 50)

    dev, _ = cb.device_ms(topk, sets, 50, OUT_DIR)
    out["torch_topk50_b8_v151936"] = {"ms": cb.timed(topk, sets, args.iters), "device_ms": dev}
    print(f"{args.label} yardstick torch.topk(logits, 50) at 8 x 151936: "
          f"{out['torch_topk50_b8_v151936']['ms']:.4f} ms a call L2-cold, device {dev:.4f} ms", flush=True)
    print(json.dumps(out))
    if fails:
        sys.exit(f"sample_bench: FAIL {fails}")


STAMP_SECTIONS = ["load, select or thread argmax", "emit or block argmax", "fence, ticket",
                  "merge: partials or keys in", "merge: select", "merge: scores", "merge: whole row"]
KINDS = ["greedy", "keep-all", "top-k"]


def clock_stamps(ops, gen, out) -> None:
    """Each shape 20 times in the stamped build: the mean cycles a block of
    each row kind spends in each section (sums read before and after)."""
    import torch

    width = len(STAMP_SECTIONS) + 2  # sections, then blocks of the slice pass and of the merge
    for name, b, v, k in SHAPES:
        inputs = cb.sampler_rows(gen, b, v, k)
        ops.fused_sample(*inputs)
        torch.cuda.synchronize()
        before = cb.read_stamps("fused_sample", "fused_sample_clock_stamps", 3 * width)
        for _ in range(20):
            ops.fused_sample(*inputs)
        torch.cuda.synchronize()
        after = cb.read_stamps("fused_sample", "fused_sample_clock_stamps", 3 * width)
        diff = [a - c for a, c in zip(after, before)]
        out[name] = {}
        for kind, label in enumerate(KINDS):
            row = diff[kind * width:(kind + 1) * width]
            blocks, merges = row[-2:]
            if not blocks:
                continue
            cycles = [round(c / blocks) for c in row[:3]] + [round(c / max(merges, 1)) for c in row[3:-2]]
            out[name][label] = dict(zip(STAMP_SECTIONS, cycles), blocks=blocks // 20, merges=merges // 20)
            print(f"stamps {name} {label}: {blocks // 20} blocks, {merges // 20} merges a call | "
                  + ", ".join(f"{sec} {c}" for sec, c in zip(STAMP_SECTIONS, cycles)), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
