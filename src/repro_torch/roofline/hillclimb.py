"""Hillclimb harness, the JAX package's ``roofline/hillclimb.py``: roofline
terms for config VARIANTS of an (arch × shape) pair, counted as the
baseline sweep counts them, so each hypothesis → change → measure cycle is
one CLI call.

  python -m repro_torch.roofline.hillclimb --arch qwen2.5-3b --shape train_4k \\
      --variant save_out --accum 4

Variants compose with "+": "base", "save_out" (the save_block_outputs
remat policy), "dots_nb" (dots_no_batch), "bf16_params", and SEBS
accumulation via --accum N (+ --accum-mode deferred). "tp_rs"
(reduce-scatter tensor-parallel boundaries) is refused: the port's
sharding rules place storage only and its compute is data-parallel, so it
has no tensor-parallel boundary to reduce-scatter.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs import INPUT_SHAPES
from repro_torch.configs.shapes import config_for
from repro_torch.launch import dryrun as dr
from repro_torch.roofline.analysis import roofline_from_summary
from repro_torch.roofline.run import depth_counts
from repro_torch.utils.log import get_logger

log = get_logger("hillclimb")

TP_RS_REFUSAL = ("variant 'tp_rs' has no counterpart in the port: attention and the dense MLPs are computed "
                 "data-parallel over every rank (only an MoE layer's experts split over the mesh's 'model' groups, "
                 "distributed/sharded.py), so there is no tensor-parallel boundary to reduce-scatter")


def apply_variant(cfg, variant: str):
    for part in variant.split("+"):
        if part in ("base", ""):
            continue
        elif part == "tp_rs":
            raise ValueError(TP_RS_REFUSAL)
        elif part == "save_out":
            cfg = cfg.replace(remat_policy="save_block_outputs")
        elif part == "dots_nb":
            cfg = cfg.replace(remat_policy="dots_no_batch")
        elif part == "bf16_params":
            cfg = cfg.replace(param_dtype="bfloat16")
        else:
            raise ValueError(f"unknown variant component {part!r}")
    return cfg


def measure(arch: str, shape_name: str, variant: str = "base", *, accum: int = 1,
            accum_mode: str = "psum_each", with_memory: bool = False) -> dict:
    shape = INPUT_SHAPES[shape_name]
    cfg = apply_variant(config_for(arch, shape_name), variant)
    mesh = dr.production_mesh(multi_pod=False)

    kw = {}
    if shape.kind == "train":
        kw = {"accum_steps": accum, "accum_mode": accum_mode}
    counted = depth_counts(cfg, shape, mesh, **kw)
    costs, summaries = counted["costs"], counted["summaries"]
    meta = {
        "devices": mesh.size,
        "kind": shape.kind,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "param_counts": cfg.param_counts(),
        "collectives": summaries[1]["collectives"],
        "cost": summaries[1]["cost"],
    }
    terms = roofline_from_summary(
        meta,
        flops=costs["flops"],
        hbm_bytes=costs["bytes_accessed"],
        collective_bytes=costs["collective_bytes"],
    )
    out = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "accum": accum, "accum_mode": accum_mode,
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "useful_ratio": terms.useful_ratio,
        "per_layer_coll_bytes": costs["per_layer"]["collective_bytes"],
        "coll_by_type_r2": summaries[2]["collectives"]["by_type_bytes"],
        "extrapolation_matches": costs["matches"],
    }
    if accum > 1:
        # the port exchanges once an update, outside the microbatch loop
        # (in_while_bytes 0): the per-update bytes are the step's own
        out["coll_bytes_per_update"] = costs["collective_bytes"]
        out["coll_bytes_per_sample"] = out["coll_bytes_per_update"] / shape.global_batch
        c2 = summaries[2]["collectives"]
        out["in_while_fraction_r2"] = c2["in_while_bytes"] / max(c2["total_bytes"], 1)
    if with_memory:
        s = dr.count_combo(cfg, shape, mesh, **kw)
        out["peak_gb_per_device"] = s["memory"]["peak_bytes_per_device"] / 2**30
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--accum-mode", default="psum_each")
    ap.add_argument("--with-memory", action="store_true")
    ap.add_argument("--out", default="results/torch/hillclimb")
    args = ap.parse_args()

    t0 = time.time()
    res = measure(args.arch, args.shape, args.variant, accum=args.accum,
                  accum_mode=args.accum_mode, with_memory=args.with_memory)
    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.arch}_{args.shape}_{args.variant.replace('+', '-')}_a{args.accum}{args.accum_mode[0]}"
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(res, f, indent=1)
    log.info(
        "%s: compute=%.3fs memory=%.3fs coll=%.3fs dominant=%s useful=%.2f (%.0fs)%s",
        tag, res["compute_s"], res["memory_s"], res["collective_s"],
        res["dominant"], res["useful_ratio"], time.time() - t0,
        f" peak={res['peak_gb_per_device']:.1f}GB" if args.with_memory else "",
    )


if __name__ == "__main__":
    main()
