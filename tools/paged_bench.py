#!/usr/bin/env python3
"""Checks and times the paged-attention kernels of one tree on one GPU.

    python3 tools/paged_bench.py [--tree DIR] [--label NAME] [--iters N] [--stamps]

Builds DIR's ``paged_attention`` library (default: this checkout), prints
ptxas' registers and spills and the tensor-core instructions (HMMA, HGMMA)
in the SASS of each of its kernels, then holds the bf16 decode and chunk
prefill (qwen2.5-3b's serving widths: 16 query and 2 KV heads of 128,
pages of 16, a 2,048-token table) against their plain versions within
chip_smoke.py's attention tolerance (one bf16 ulp), with the planted fault
(the last visible key dropped) outside it, checks that two calls give the
same bits, and times each through its ``ops`` wrapper: L2-cold ms a call
(inputs rotating over copies larger than L2, CUDA events) and device ms a
call (its kernels' busy time under torch.profiler), with each kernel's
share. Shapes, as chip_smoke.py's phase 3 has them: decode at ragged
lengths (8 slots, 1 to 1,100 tokens) and at the serving shape (8 slots of
544 tokens sharing a 256-token prefix); prefill of one 256-token chunk at
positions 0 and 256. Besides, the serving shape's decode in a table of
8,192 positions (a longer cache), where the decode walks more chunks a
split. The last line is one JSON object. To compare two trees on one
card, run it for each in one command, in turns (old, new, new, old).
``--stamps`` builds the measurement variant
(-DPAGED_CLOCK_STAMPS), runs the ragged decode and the prefill at
pos_start 256 and prints, for one block of each (the first split of slot
0, the tile that sees the most keys), each warp's cycles in each section
of the kernel (clock64), instead of timing. Needs a CUDA device.
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
RAGGED = [544, 512, 1, 1100, 600, 700, 300, 595]  # chip_smoke.py's phase 3
HQ, HKV, D, PS, PAGES = 16, 2, 128, 16, 1025


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--stamps", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    if args.stamps:
        os.environ["REPRO_TORCH_NVCC_EXTRA"] = "-DPAGED_CLOCK_STAMPS"

    import torch

    from repro_torch.kernels.paged_decode import ops, ref

    if not torch.cuda.is_available():
        sys.exit("paged_bench: needs a CUDA device")
    smi = cb.nvidia_smi()
    tensor_ops = cb.build_report("paged_attention")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def pool(lengths, **share):
        return cb.paged_pool(gen, pages=PAGES, ps=PS, hkv=HKV, d=D, lengths=lengths, **share)

    if args.stamps:
        clock_stamps(ops, pool, gen, smi)
        return
    out = {"label": args.label, "tree": str(args.tree), "nvidia_smi": smi}
    fails = []

    def record(name, fn, args_, expect, fault, iters):
        got = fn(*args_)
        again = fn(*args_)
        reading = {"excess": cb.excess(got, expect),
                   "fault_excess": cb.excess(fault, expect) if fault is not None else None,
                   "same_bits": bool(torch.equal(got, again)), "finite": bool(torch.isfinite(got.float()).all())}
        if not (reading["excess"] <= 1 and reading["finite"]):
            fails.append(f"{name}: {reading['excess']:.3f} x the allowance")
        if reading["fault_excess"] is not None and reading["fault_excess"] <= 1:
            fails.append(f"{name}: the planted fault is inside the tolerance")
        if not reading["same_bits"]:
            fails.append(f"{name}: two calls differ")
        q, k, v, table, pos = args_
        sets = [(q.clone(), k.clone(), v.clone(), table, pos) for _ in range(cb.copies_for(cb.nbytes(q, k, v)))]
        dev, per = cb.device_ms(fn, sets, 20, OUT_DIR)
        out[name] = {**reading, "ms": cb.timed(fn, sets, iters), "device_ms": dev, "kernels_device_ms": per}
        print(f"{args.label} {name}: {out[name]['ms']:.4f} ms a call L2-cold, device {dev:.4f} ms | excess "
              f"{reading['excess']:.3f} (fault {reading['fault_excess']}) same bits {reading['same_bits']} | "
              + ", ".join(f"{n[:70]} {t:.4f}" for n, t in per.items()), flush=True)

    def window_softcap(name, fn, args_, plain):
        kw = dict(sliding_window=100, softcap=30.0)
        out[name]["window_softcap_excess"] = x = cb.excess(fn(*args_, **kw), plain(*args_, **kw))
        if x > 1:
            fails.append(f"{name} (window, softcap): {x:.3f} x the allowance")

    # decode: the ragged lengths, the serving shape, and that in a wider table
    for name, lengths, share in (("decode_ragged", RAGGED, dict(share_first_page=True)),
                                 ("decode_serving", [544] * 8, dict(prefix_pages=256 // PS)),
                                 ("decode_serving_8192", [544] * 8, dict(prefix_pages=256 // PS, width=8192))):
        k, v, table = pool(lengths, **share)
        pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32, device="cuda")
        q = torch.randn((len(lengths), HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
        args_ = (q, k, v, table, pos)
        record(name, ops.paged_flash_decode, args_, ref.paged_attention_ref(*args_),
               ref.paged_attention_ref(q, k, v, table, (pos - 1).clamp_min(0)), args.iters)
        if name == "decode_ragged":
            window_softcap(name, ops.paged_flash_decode, args_, ref.paged_attention_ref)
        del k, v
    # chunk prefill: one 256-token chunk at pos_start 0 and 256
    k, v, table = pool([512])
    q = torch.randn((1, 256, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    for start in (0, 256):
        args_ = (q, k, v, table, torch.tensor([start], dtype=torch.int32, device="cuda"))
        fault = ref.paged_prefill_ref(*args_[:4], args_[4] - 1) if start else None
        record(f"prefill_pos{start}", ops.paged_chunk_prefill, args_, ref.paged_prefill_ref(*args_), fault,
               max(20, args.iters // 4))
    window_softcap("prefill_pos256", ops.paged_chunk_prefill, args_, ref.paged_prefill_ref)
    out["sass_tensor_ops"] = tensor_ops
    print(json.dumps(out))
    if fails:
        sys.exit(f"paged_bench: FAIL {fails}")


STAMP_SECTIONS = ["setup: position, range, query tile, first copies", "waits: copies landing, barrier",
                  "products and softmax", "barrier after them", "merge of the warps", "store"]


def clock_stamps(ops, pool, gen, smi) -> None:
    """The ragged decode and the prefill at pos_start 256 in the stamped
    build; print each warp's cycles per section for the stamped block."""
    import torch

    warps, sections = 8, len(STAMP_SECTIONS)  # kStampWarps, kStampSections in paged_attention.cu
    k, v, table = pool(RAGGED, share_first_page=True)
    pos = torch.tensor([n - 1 for n in RAGGED], dtype=torch.int32, device="cuda")
    q = torch.randn((len(RAGGED), HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    kc, vc, table_c = pool([512])
    qc = torch.randn((1, 256, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    start = torch.tensor([256], dtype=torch.int32, device="cuda")
    out = {"nvidia_smi": smi}
    for kernel, (name, fn, args_, n_warps) in enumerate((
            ("decode (ragged, split 0 of slot 0)", ops.paged_flash_decode, (q, k, v, table, pos), 2),
            ("prefill (pos_start 256, the last tile)", ops.paged_chunk_prefill, (qc, kc, vc, table_c, start), 8))):
        for _ in range(2):  # the second run's stamps: code and data warm
            fn(*args_)
        torch.cuda.synchronize()
        raw = cb.read_stamps("paged_attention", "paged_clock_stamps", 2 * warps * sections)
        rows = [raw[(kernel * warps + w) * sections:(kernel * warps + w + 1) * sections] for w in range(n_warps)]
        out[name] = {sec: [rows[w][j] for w in range(n_warps)] for j, sec in enumerate(STAMP_SECTIONS)}
        print(f"stamps {name}: cycles per warp (warps 0..{n_warps - 1}), total {[sum(r) for r in rows]}")
        for sec, cyc in out[name].items():
            print(f"  {sec:50s} {cyc}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
