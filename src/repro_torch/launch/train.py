"""Training launcher CLI, the port's counterpart of the JAX package's
``launch/train.py``, with the same flags and defaults.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --variant smoke --schedule sebs --rho 4 --stages 3 --b1 8 \\
        --c1 256 --seq 64 --steps-log 5 [--device cpu]

Runs on the CUDA device by default (and raises when there is none);
``--device cpu`` runs the kernels' plain versions on the CPU. ``--seed``
seeds the random weights and the data stream.

Not yet ported, each an error naming its slice: ``--mesh``, ``--dp-elastic``
and its options (multi-worker training), ``--ckpt-*``, ``--resume`` and
``--stop-after`` (checkpoint and resume), and the adaptive optimizers.
"""
from __future__ import annotations

import argparse
import json
import logging
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.core import SEBS, AdaptiveSEBS, ClassicalStagewise, SEBSTrainer
from repro_torch.data import DataPipeline, TokenDataset
from repro_torch.models import LanguageModel
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.optim import LATER as LATER_OPTIMIZERS, make_optimizer
from repro_torch.train.state import init_train_state

log = logging.getLogger("train")
OPTIMIZERS = ("sgd", "psgd", "momentum", "msgd", "adagrad", "adagrad_da")
_MULTI_WORKER = "multi-worker training comes with the multi-worker slice"
_CHECKPOINT = "checkpoint and resume come with the checkpoint slice"


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--schedule", default="sebs", choices=["sebs", "classical", "adaptive"])
    ap.add_argument("--optimizer", default="psgd")
    ap.add_argument("--gamma", type=float, default=1e4)
    ap.add_argument("--eta", type=float, default=0.3)
    ap.add_argument("--b1", type=int, default=8)
    ap.add_argument("--c1", type=int, default=256)
    ap.add_argument("--rho", type=float, default=4.0)
    ap.add_argument("--stages", type=int, default=3)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mode", default="accumulate", choices=["accumulate", "reshape"])
    ap.add_argument("--accum-mode", default="psum_each", choices=["psum_each", "deferred", "unrolled"],
                    help="one computation in one process (the modes differ only across a mesh)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0, help="random weights and the data stream")
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"])
    ap.add_argument("--dp-elastic", action="store_true")
    ap.add_argument("--sync-mode", default="exact", choices=["exact", "local"])
    ap.add_argument("--device-budget", type=int, default=None)
    ap.add_argument("--local-interval", type=int, default=4)
    ap.add_argument("--local-growth", type=float, default=1.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-keep", type=int, default=3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--stop-after", type=int, default=None)
    ap.add_argument("--log-json", default=None,
                    help="dump the train log (losses, stages, GNS trajectory) as JSON")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON of the run (per-update spans)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="dump the metrics registry snapshot as JSON")
    ap.add_argument("--steps-log", type=int, default=5)
    args = ap.parse_args(argv)

    if args.mesh != "none":
        ap.error(f"--mesh {args.mesh}: {_MULTI_WORKER}")
    if args.dp_elastic or (args.sync_mode, args.device_budget, args.local_interval,
                           args.local_growth) != ("exact", None, 4, 1.0):
        ap.error(f"--dp-elastic and its options: {_MULTI_WORKER}")
    if args.ckpt_dir or args.ckpt_every or args.ckpt_keep != 3 or args.resume:
        ap.error(f"--ckpt-*/--resume: {_CHECKPOINT}")
    if args.stop_after is not None:
        ap.error(f"--stop-after (a simulated preemption for resume): {_CHECKPOINT}")
    if args.optimizer in LATER_OPTIMIZERS:
        ap.error(f"--optimizer {args.optimizer} comes with the adaptive-optimizer slice")
    if args.optimizer not in OPTIMIZERS:
        ap.error(f"unknown --optimizer {args.optimizer!r}; available: {sorted(OPTIMIZERS)}")
    for flag, value, low in (("--b1", args.b1, 1), ("--c1", args.c1, 1), ("--stages", args.stages, 1),
                             ("--seq", args.seq, 1), ("--steps-log", args.steps_log, 1)):
        if value < low:
            ap.error(f"{flag} must be >= {low} (got {value})")
    if args.rho <= 1.0 and args.schedule in ("sebs", "classical") and args.stages > 1:
        ap.error(f"--rho must be > 1.0 for a multi-stage {args.schedule} ladder")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA device, and none is "
                           "available; pass --device cpu to run the plain versions on the CPU")

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    cfg = get_config(args.arch, args.variant)
    model = LanguageModel(cfg)
    opt_kwargs = {"gamma": args.gamma} if args.optimizer == "psgd" else {}
    optimizer = make_optimizer(args.optimizer, **opt_kwargs)
    if args.schedule == "sebs":
        schedule = SEBS(b1=args.b1, C1=args.c1, rho=args.rho, num_stages=args.stages, eta=args.eta)
    elif args.schedule == "classical":
        schedule = ClassicalStagewise(b=args.b1, C1=args.c1, rho=args.rho,
                                      num_stages=args.stages, eta1=args.eta)
    else:
        schedule = AdaptiveSEBS(b1=args.b1, eta=args.eta, rho_max=args.rho,
                                total=args.c1 * args.stages)

    tracer = Tracer() if args.trace else None
    metrics = MetricsRegistry() if args.metrics else None
    ds = TokenDataset(vocab_size=cfg.vocab_size, seq_len=args.seq, seed=args.seed)
    trainer = SEBSTrainer(
        model, optimizer, schedule, DataPipeline(ds, device=args.device),
        microbatch=args.b1, mode=args.mode, accum_mode=args.accum_mode,
        tracer=tracer, metrics=metrics,
    )
    state = init_train_state(model, optimizer, seed=args.seed, device=args.device)
    state, tlog = trainer.run(state, log_every=args.steps_log)
    for i in range(len(tlog.steps)):
        log.info("update %4d samples %6d stage %d batch %4d loss %.4f", tlog.steps[i],
                 tlog.samples[i], tlog.stages[i], tlog.batch_sizes[i], tlog.losses[i])
    if args.log_json:
        with open(args.log_json, "w") as f:
            json.dump(tlog.as_dict(), f)
        log.info("train log written to %s", args.log_json)
    if tracer is not None:
        tracer.dump_chrome(args.trace)
        log.info("chrome trace (%d events) written to %s", len(tracer.events), args.trace)
    if metrics is not None:
        metrics.dump(args.metrics)
        log.info("metrics snapshot written to %s", args.metrics)
    return tlog


if __name__ == "__main__":
    main()
