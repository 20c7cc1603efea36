"""The paper's Fig. 1: time a sample against the batch size, as the JAX
package's ``benchmarks/fig1_util.py``.

The paper's Fig. 1 shows the device's time an epoch falling as the batch
grows, until the device saturates: a larger batch amortizes each update
(the weights' reads, the optimizer's pass, the host's dispatch). Here the
port's single-process momentum train step (``train/step.py``) on
qwen2.5-3b takes batches of 1, 2, 4, 8, 16 and 32 rows of 64 tokens, and
each batch's µs a sample is the mean of ``iters`` timed steps after one
untimed one (the clock read after a synchronize on the card). On the card
the step runs the flash kernels and the fused momentum update. Tokens come
from a ``torch.Generator`` seeded with the batch size; weights from seed 0.

    python -m repro_torch.experiments.fig1_util [--device cpu] [--variant full] [--out DIR]
"""
from __future__ import annotations

import argparse
import time
from typing import List

import torch

from repro_torch.configs import get_config
from repro_torch.experiments._records import DEFAULT_OUT, Record, print_csv, write_json
from repro_torch.models import LanguageModel
from repro_torch.optim import make_optimizer
from repro_torch.train.state import TrainState
from repro_torch.train.step import build_train_step

BATCHES = [1, 2, 4, 8, 16, 32]
SEQ = 64
LR = 1e-3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def per_sample_us(variant: str = "smoke", device="cuda", iters: int = 5, batches=BATCHES) -> dict:
    """Batch size -> µs a sample of the momentum train step on qwen2.5-3b's
    ``variant``."""
    cfg = get_config("qwen2.5-3b", variant)
    model = LanguageModel(cfg)
    opt = make_optimizer("momentum")
    params = model.init(0, device=device)
    state = TrainState(params, opt.init(params), 0)
    step = build_train_step(model, opt)
    out = {}
    for b in batches:
        tokens = torch.randint(0, cfg.vocab_size, (b, SEQ), generator=torch.Generator().manual_seed(b),
                               dtype=torch.int32)
        batch = {"tokens": tokens.to(device)}
        state, _ = step(state, batch, LR, 0)  # the first call at a shape: allocations, kernel loads
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            state, metrics = step(state, batch, LR, 0)
        _sync(device)
        out[b] = (time.perf_counter() - t0) / iters / b * 1e6
        if not torch.isfinite(metrics["loss"]).item():
            raise RuntimeError(f"fig. 1: the loss at batch {b} is not finite")
    return out


def run(out_dir: str = DEFAULT_OUT, device="cuda", variant: str = "smoke", iters: int = 5) -> List[Record]:
    us = per_sample_us(variant, device, iters)
    write_json(out_dir, f"fig1_util_{variant}.json", us)
    bmax = max(us)
    speedup = us[1] / us[bmax]
    derived = (f"us/sample by batch={ {k: round(v, 1) for k, v in us.items()} }; "
               f"b=1→b={bmax} speedup {speedup:.2f}x")
    ctx = {"per_sample_us": {str(k): v for k, v in us.items()}, "seq": SEQ}
    return [
        Record("fig1_time_per_sample_bmax", us[bmax], "us/sample", direction="lower", derived=derived, context=ctx),
        Record("fig1_batch_speedup", speedup, "ratio", direction="higher", derived=derived, context=ctx),
    ]


def main(argv=None) -> List[Record]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=DEFAULT_OUT, help="directory of the JSON results")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA device, and none is available; "
                           "pass --device cpu to run on the CPU")
    records = run(args.out, args.device, args.variant, args.iters)
    print_csv(records)
    return records


if __name__ == "__main__":
    main()
