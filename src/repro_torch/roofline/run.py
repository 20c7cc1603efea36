"""Roofline sweep, the JAX package's ``roofline/run.py``: for every
applicable (arch × shape) on the single-pod production mesh, count the
r=1 / r=2 / r=R companions (``extrapolate.scaled_config``) on meta
tensors, check that the extrapolation of the first two equals the third,
combine with the production dry-run summary, and emit the three-term
roofline JSON (the H100's published peaks, ``analysis.HW``).

  python -m repro_torch.roofline.run
  python -m repro_torch.roofline.run --arch qwen2.5-3b --shape train_4k
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import INPUT_SHAPES, list_archs
from repro_torch.configs.shapes import config_for, shape_applicable
from repro_torch.launch import dryrun as dr
from repro_torch.roofline.analysis import HW, roofline_from_summary
from repro_torch.roofline.extrapolate import extrapolate_costs, scaled_config, ssm_recurrence_flops
from repro_torch.utils.log import get_logger

log = get_logger("roofline")


def depth_counts(cfg, shape, mesh, **kw) -> dict:
    """The counts at r = 1, 2 and the full repeat R, and the extrapolation
    of the first two to R (no SSM correction: the GLA kernels report their
    own operations). ``matches`` says whether it equals the count at R."""
    full_repeat = cfg.segments[0].repeat
    summaries = {r: dr.count_combo(scaled_config(cfg, r), shape, mesh, **kw) for r in sorted({1, 2, full_repeat})}
    costs = extrapolate_costs(summaries[1], summaries[2], full_repeat)
    full = summaries[full_repeat]
    counted = (full["cost"]["flops"], full["cost"]["bytes_accessed"], full["collectives"]["total_bytes"])
    costs["counted_at_full_depth"] = dict(zip(("flops", "bytes_accessed", "collective_bytes"), counted))
    costs["matches"] = counted == (costs["flops"], costs["bytes_accessed"], costs["collective_bytes"])
    costs["ssm_recurrence_flops_jax"] = ssm_recurrence_flops(cfg, shape)
    return {"costs": costs, "summaries": summaries}


def roofline_combo(arch: str, shape_name: str, dryrun_dir: str) -> dict:
    shape = INPUT_SHAPES[shape_name]
    cfg = config_for(arch, shape_name)
    mesh = dr.production_mesh(multi_pod=False)
    costs = depth_counts(cfg, shape, mesh)["costs"]

    # production dry-run summary for memory + metadata (counted here if absent)
    prod_path = os.path.join(dryrun_dir, f"{arch}_{shape_name}_pod1.json")
    if os.path.exists(prod_path):
        with open(prod_path) as f:
            prod = json.load(f)
    else:
        prod = dr.run_combo(arch, shape_name, False)

    terms = roofline_from_summary(
        prod,
        flops=costs["flops"],
        hbm_bytes=costs["bytes_accessed"],
        collective_bytes=costs["collective_bytes"],
    )
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "config": cfg.name,
        "devices": prod["devices"],
        "extrapolated": costs,
        "memory_per_device": prod["memory"],
        "terms": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "step_time_bound_s": terms.step_time_s,
            "roofline_fraction": terms.roofline_fraction,
        },
        "model_flops": terms.model_flops,
        "hlo_flops": terms.hlo_flops,
        "useful_ratio": terms.useful_ratio,
        "hw": HW,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--dryrun-dir", default="results/torch/dryrun")
    ap.add_argument("--out", default="results/torch/roofline")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            if not shape_applicable(arch, shape):
                continue
            t0 = time.time()
            try:
                res = roofline_combo(arch, shape, args.dryrun_dir)
                with open(os.path.join(args.out, f"{arch}_{shape}.json"), "w") as f:
                    json.dump(res, f, indent=1)
                t = res["terms"]
                log.info(
                    "%-30s dominant=%-10s compute=%.4fs memory=%.4fs coll=%.4fs useful=%.2f extrapolation %s (%.0fs)",
                    f"{arch}×{shape}", t["dominant"], t["compute_s"], t["memory_s"], t["collective_s"],
                    res["useful_ratio"], "matches" if res["extrapolated"]["matches"] else "DIFFERS",
                    time.time() - t0,
                )
                if not res["extrapolated"]["matches"]:
                    failures.append((arch, shape, "the extrapolation differs from the full-depth count"))
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape, repr(e)))
                log.error("FAIL %s×%s: %s", arch, shape, e)
                traceback.print_exc(limit=6)
    if failures:
        raise SystemExit(f"{len(failures)} roofline failures: {failures}")


if __name__ == "__main__":
    main()
