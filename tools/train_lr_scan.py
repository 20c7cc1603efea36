#!/usr/bin/env python3
"""Learning-rate scan for the port's SEBS training on one GPU.

    python3 tools/train_lr_scan.py [--layers 8] [--optimizer psgd] [--etas 0.3 1 3 10]

Builds the kernels, then runs chip_smoke.py's training run (qwen2.5-3b at
full width, cut to ``--layers`` layers; SEBS b1 4, C1 16, rho 2, three
stages, seq 512, microbatch 4: 12 updates) once per learning rate from the
same seed-0 weights, and prints each run's losses. chip_smoke.py's ETAS
were chosen with it. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--optimizer", default="psgd", choices=["psgd", "momentum", "adagrad_da"])
    ap.add_argument("--etas", type=float, nargs="+", default=[0.3, 1.0, 3.0, 10.0])
    args = ap.parse_args()

    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SegmentSpec
    from repro_torch.kernels import _cuda
    from repro_torch.optim import make_optimizer

    if not torch.cuda.is_available():
        sys.exit("train_lr_scan: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build()
    cfg = get_config("qwen2.5-3b", "full")
    cfg = cfg.replace(segments=(SegmentSpec(body=cfg.segments[0].body, repeat=args.layers),))
    hp = {"psgd": {"gamma": 1e4}, "momentum": {"beta": 0.9}, "adagrad_da": {}}[args.optimizer]
    print(chip_smoke.nvidia_smi())
    for eta in args.etas:
        log, wall, *_ = chip_smoke.run_sebs(cfg, make_optimizer(args.optimizer, **hp), eta=eta,
                                            device="cuda", seq=512, b1=4, c1=16, stages=3)
        print(f"{args.optimizer} layers {args.layers} eta {eta}: {wall:.1f} s | losses "
              + " ".join(f"{x:.4f}" for x in log.losses), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
