"""Training launcher CLI, the port's counterpart of the JAX package's
``launch/train.py``, with the same flags and defaults.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --variant smoke --schedule sebs --rho 4 --stages 3 --b1 8 \\
        --c1 256 --seq 64 --steps-log 5 [--device cpu]

``--arch`` takes the ported families: the dense decoders (gemma2-9b's
soft-capped attention included), rwkv6-1.6b, the hybrid zamba2-2.7b
(Mamba2 with the weight-tied shared attention block) and the MoE family
(dbrx-132b, arctic-480b; the router's aux loss enters the loss at weight
0.01, as in the JAX package). whisper-tiny trains through ``SEBSTrainer``
on batches that carry ``audio_embeds``; this launcher's token stream, like
the JAX launcher's, has none, so ``--arch whisper-tiny`` is an error naming
the missing input.
Runs on the CUDA device by default (and raises when there is none);
``--device cpu`` runs the kernels' plain versions on the CPU. ``--seed``
seeds the random weights and the data stream.

Fault tolerance, as in the JAX launcher: ``--ckpt-dir`` + ``--ckpt-every N``
snapshot the full run state every N updates (in the JAX package's format,
so either launcher resumes the other's directory); ``--resume`` restarts
from the latest checkpoint and is kill-equivalent; ``--stop-after``
simulates a preemption.

Elastic data parallelism, as in the JAX launcher: ``--dp-elastic`` hands the
run to :class:`repro_torch.distributed.ElasticTrainer`, whose width (worker
processes) follows the SEBS stage ladder up to ``--device-budget``, with
``--sync-mode exact`` (bit-identical across widths) or ``--sync-mode local``
(local SGD, averaging cadence ``--local-interval`` / ``--local-growth``); it
implies accumulate mode with the canonical tree (``--mode`` and
``--accum-mode`` do not apply). On the card the workers are the visible CUDA
devices, the budget capped at their count (default: all of them); with
``--device cpu``, ``--device-budget N`` runs N CPU workers (default 1) of one
intra-op thread each, at every budget alike.

The production mesh, as in the JAX launcher: ``--mesh single|multi`` lays
the visible cards out by ``launch.mesh.make_production_mesh`` (4 cards give
(2, 2)), one worker process a card, and hands the run to ``SEBSTrainer``
with the model's ``param_axes``: each worker stores its shards of the state
by the rules (``sharding/partitioning.py``) and the microbatches are spread
data-parallel over every worker (NCCL between them). With ``--device cpu``
the mesh is one CPU worker. It implies accumulate mode, and ``--mesh`` with
``--dp-elastic`` is an error, as in the JAX launcher. ``--tensor-parallel``
(with ``--mesh``) splits the attention, MLPs, experts, vocabulary and
recurrent heads (rwkv6's, Mamba2's) over the mesh's ``model`` groups, as
GSPMD does in the JAX package; a
family it does not cover yet is an error naming its ``ROADMAP.md`` item. A
mesh whose ``model`` axis has one rank (one card) has nothing to split.
"""
from __future__ import annotations

import argparse
import json
import logging
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.sharding.partitioning import check_tensor_parallel
from repro_torch.core import SEBS, AdaptiveSEBS, ClassicalStagewise, SEBSTrainer
from repro_torch.data import DataPipeline, TokenDataset
from repro_torch.distributed import ElasticTrainer
from repro_torch.models import LanguageModel
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.optim import OPTIMIZERS, make_optimizer
from repro_torch.train.state import init_train_state

log = logging.getLogger("train")


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help="the dense decoders (qwen2.5-3b, deepseek-7b/67b, gemma2-9b, internvl2-1b), "
                         "rwkv6-1.6b, zamba2-2.7b, the MoE family (dbrx-132b, arctic-480b); whisper-tiny "
                         "needs audio_embeds in each batch, which this launcher's token stream lacks")
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
    ap.add_argument("--tensor-parallel", action="store_true",
                    help="with --mesh: split attention, the dense MLPs, the experts, the vocabulary and rwkv6's "
                         "and Mamba2's heads over the mesh's model groups (every family but whisper)")
    ap.add_argument("--dp-elastic", action="store_true",
                    help="elastic data parallelism: the number of worker processes follows the SEBS "
                         "stage ladder (repro_torch.distributed). Builds its own per-stage worker groups "
                         "(incompatible with --mesh) and implies accumulate mode with the canonical tree "
                         "(--mode/--accum-mode do not apply)")
    ap.add_argument("--sync-mode", default="exact", choices=["exact", "local"],
                    help="exact: one gradient collective per update, bit-identical across widths; "
                         "local: local SGD with stage-keyed averaging")
    ap.add_argument("--device-budget", type=int, default=None,
                    help="max data-parallel width (default: every visible CUDA device; 1 with --device cpu)")
    ap.add_argument("--local-interval", type=int, default=4,
                    help="local-SGD: updates between parameter averages at stage 0")
    ap.add_argument("--local-growth", type=float, default=1.0,
                    help="local-SGD: geometric growth of the averaging interval per stage")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (full run state, not just params)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a checkpoint every N optimizer updates (0: only at exit)")
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="retain only the newest N checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="exit after N updates WITHOUT a final save (simulated preemption)")
    ap.add_argument("--log-json", default=None,
                    help="dump the train log (losses, stages, GNS trajectory) as JSON")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON of the run (per-update spans)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="dump the metrics registry snapshot as JSON")
    ap.add_argument("--steps-log", type=int, default=5)
    args = ap.parse_args(argv)

    if args.dp_elastic and args.mesh != "none":
        ap.error("--dp-elastic builds its own per-stage worker groups; drop --mesh")
    if args.tensor_parallel and args.mesh == "none":
        ap.error("--tensor-parallel splits compute over a mesh's model groups: it needs --mesh")
    if args.optimizer not in OPTIMIZERS:
        ap.error(f"unknown --optimizer {args.optimizer!r}; available: {sorted(OPTIMIZERS)}")
    for flag, value, low in (("--b1", args.b1, 1), ("--c1", args.c1, 1), ("--stages", args.stages, 1),
                             ("--seq", args.seq, 1), ("--ckpt-every", args.ckpt_every, 0),
                             ("--ckpt-keep", args.ckpt_keep, 1), ("--local-interval", args.local_interval, 1),
                             ("--steps-log", args.steps_log, 1)):
        if value < low:
            ap.error(f"{flag} must be >= {low} (got {value})")
    if args.rho <= 1.0 and args.schedule in ("sebs", "classical") and args.stages > 1:
        ap.error(f"--rho must be > 1.0 for a multi-stage {args.schedule} ladder")
    if args.ckpt_every and not args.ckpt_dir:
        ap.error("--ckpt-every has no effect without --ckpt-dir")
    if args.stop_after is not None and args.stop_after < 1:
        ap.error(f"--stop-after must be >= 1 (got {args.stop_after})")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")
    if args.device_budget is not None and args.device_budget < 1:
        ap.error(f"--device-budget must be >= 1 (got {args.device_budget})")
    if args.local_growth < 1.0:
        ap.error(f"--local-growth must be >= 1.0 (got {args.local_growth})")
    if not args.dp_elastic:
        # flags that would otherwise be silently ignored
        defaults = {"sync_mode": "exact", "device_budget": None, "local_interval": 4, "local_growth": 1.0}
        for dest, default in defaults.items():
            if getattr(args, dest) != default:
                ap.error(f"--{dest.replace('_', '-')} requires --dp-elastic")
    if args.mesh != "none" and args.mode != "accumulate":
        ap.error(f"--mesh spreads microbatches over its workers: it needs --mode accumulate, not {args.mode}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA device, and none is "
                           "available; pass --device cpu to run the plain versions on the CPU")

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    cfg = get_config(args.arch, args.variant)
    if args.tensor_parallel:
        try:
            check_tensor_parallel(cfg)
        except ValueError as e:
            ap.error(f"--tensor-parallel: {e}")
    if cfg.is_encoder_decoder:
        # the JAX launcher fails on the missing audio_embeds at its first update
        ap.error(f"--arch {args.arch}: the encoder-decoder model trains on batches with audio_embeds "
                 f"(B, {cfg.encoder_seq}, {cfg.d_model}), and this launcher's token stream has none; "
                 "drive SEBSTrainer with a pipeline whose batches carry them")
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
    if args.dp_elastic:
        if args.device == "cpu":
            devices = [torch.device("cpu")] * (args.device_budget or 1)
            # one intra-op thread a worker: the workers take the caller's count, so the machine's
            # count would oversubscribe its cores budget-fold, and a count that followed the
            # budget would change the bits from one budget to another
            torch.set_num_threads(1)
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        trainer = ElasticTrainer(
            model, optimizer, schedule, DataPipeline(ds, device=args.device),
            microbatch=args.b1, sync_mode=args.sync_mode, device_budget=args.device_budget, devices=devices,
            local_interval=args.local_interval, local_growth=args.local_growth, seed=args.seed,
            tracer=tracer, metrics=metrics,
        )
    else:
        mesh = None
        if args.mesh != "none":
            from repro_torch.launch.mesh import make_production_mesh

            devices = [torch.device("cpu")] if args.device == "cpu" else None
            try:
                mesh = make_production_mesh(multi_pod=args.mesh == "multi", devices=devices)
            except ValueError as e:
                ap.error(f"--mesh {args.mesh}: {e}")
            log.info("mesh %s over %d worker(s)", mesh.shape, mesh.size)
        trainer = SEBSTrainer(
            model, optimizer, schedule,
            DataPipeline(ds, mesh) if mesh is not None else DataPipeline(ds, device=args.device),
            mesh=mesh, param_axes=model.param_axes() if mesh is not None else None,
            microbatch=args.b1, mode=args.mode, accum_mode=args.accum_mode, seed=args.seed,
            tracer=tracer, metrics=metrics, tensor_parallel=args.tensor_parallel,
        )
    state = init_train_state(model, optimizer, seed=args.seed, device=args.device)
    checkpointer = CheckpointManager(args.ckpt_dir, keep_last=args.ckpt_keep) if args.ckpt_dir else None
    try:
        state, tlog = trainer.run(state, log_every=args.steps_log, checkpointer=checkpointer,
                                  save_every=args.ckpt_every, resume=args.resume,
                                  stop_after_updates=args.stop_after)
    finally:
        if checkpointer is not None:
            checkpointer.close()
    for i in range(len(tlog.steps)):
        log.info("update %4d samples %6d stage %d batch %4d loss %.4f", tlog.steps[i],
                 tlog.samples[i], tlog.stages[i], tlog.batch_sizes[i], tlog.losses[i])
    if args.dp_elastic:
        acct = trainer.accountant
        log.info("comm: %d sync events, %.2f MiB/device across stages %s (widths %s)",
                 acct.total_sync_events, acct.total_bytes / 2**20, sorted(acct.per_stage),
                 sorted({k[1] for k in trainer._steps}))
    if checkpointer is not None:
        log.info("checkpoints under %s (latest: update %s)", args.ckpt_dir, checkpointer.latest_step())
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
