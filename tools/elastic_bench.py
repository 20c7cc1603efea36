#!/usr/bin/env python3
"""The elastic trainer's all-gather of partial sums, alone, on one card.

    python3 tools/elastic_bench.py [--layers 4] [--widths 2 4] [--reps 3]

W worker processes share cuda:0, each holding a partial sum shaped like the
f32 gradient of qwen2.5-3b at full width cut to ``--layers`` layers (the
tied embedding is 1.24 GB of it), and all-gather it as the exact-sync step
must: every worker ends with the W partials, combined by the canonical tree
in replica order. Two transports, each timed per gather (copy out,
collective, copy back, host seconds), the workers' results held bitwise
equal across them:

- ``gloo``: each leaf copied to the host, gloo's ``all_gather`` over the
  loopback, the W copies back to the card;
- ``slots``: the trainer's ``HostExchange``, the run's shared host slots
  with gloo barriers (``src/repro_torch/distributed/staging.py``).

Prints one line per (width, transport) with the card's name and power limit,
and writes ``chiprun_out/elastic_bench.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))


def _worker(rank: int, world: int, workdir: str, shapes: list, reps: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.staging import HostExchange, StagingTimes, from_host
    from repro_torch.distributed.step import span_tree_sum
    from repro_torch.launch.mesh import DataMesh

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "store"), rank=rank,
                            world_size=world, timeout=timedelta(seconds=600))
    gen = torch.Generator(device=dev).manual_seed(rank)
    parts = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    slot = max(p.numel() * 4 for p in parts)
    exchange = HostExchange(workdir, rank, world, slot)
    mesh = DataMesh(tuple([dev] * world), None, exchange)
    result, record = {}, {"rank": rank}

    def via_gloo():
        t, outs = StagingTimes(), []
        for p in parts:
            t0 = time.perf_counter()
            host = p.cpu()
            t.copy_out_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            every = [torch.empty_like(host) for _ in range(world)]
            dist.all_gather(every, host)
            t.collective_s += time.perf_counter() - t0
            outs.append(span_tree_sum(lambda d: from_host(every[d], p, t), world))
        return outs, t

    def via_slots():
        t, outs = StagingTimes(), [None] * len(parts)
        for i, host in exchange.all_gather(list(parts), mesh, t):
            outs[i] = span_tree_sum(lambda d: from_host(host[d], parts[i], t), world)
        return outs, t

    for name, fn in (("gloo", via_gloo), ("slots", via_slots)):
        times = []
        for _ in range(reps):
            dist.barrier()
            outs, t = fn()
            torch.cuda.synchronize()
            times.append(t)
        result[name] = outs
        record[name] = [{"copy_out_s": t.copy_out_s, "collective_s": t.collective_s, "copy_back_s": t.copy_back_s}
                        for t in times]
    names = list(result)
    record["same_bits"] = all(torch.equal(a, b) for n in names[1:] for a, b in zip(result[names[0]], result[n]))
    with open(out, "w") as f:
        json.dump(record, f)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--widths", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    from cardbench import nvidia_smi
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel

    if not torch.cuda.is_available():
        sys.exit("this bench needs a CUDA device")
    cfg = get_config("qwen2.5-3b", "full")
    cfg = cfg.replace(segments=(dataclasses.replace(cfg.segments[0], repeat=args.layers),))
    from repro_torch.utils.tree import tree_leaves

    shapes = [tuple(t.shape) for t in tree_leaves(LanguageModel(cfg).init(0, device="cuda"))]
    torch.cuda.empty_cache()
    gb = sum(torch.Size(s).numel() for s in shapes) * 4 / 1e9
    smi = nvidia_smi()
    report = {"layers": args.layers, "partial_gb": gb, "leaves": len(shapes), "nvidia_smi": smi, "widths": {}}
    ctx = mp.get_context("spawn")
    for world in args.widths:
        with tempfile.TemporaryDirectory(prefix="elastic_bench_") as workdir:
            outs = [os.path.join(workdir, f"out_{r}.json") for r in range(world)]
            procs = [ctx.Process(target=_worker, args=(r, world, workdir, shapes, args.reps, outs[r]))
                     for r in range(world)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(1200)
            if any(p.exitcode != 0 for p in procs):
                for p in procs:
                    p.kill()
                sys.exit(f"a bench worker failed at width {world}: {[p.exitcode for p in procs]}")
            records = [json.loads(Path(o).read_text()) for o in outs]
        report["widths"][world] = records
        r0 = records[0]
        for name in ("gloo", "slots"):
            med = {k: sorted(t[k] for t in r0[name])[len(r0[name]) // 2] * 1e3
                   for k in ("copy_out_s", "collective_s", "copy_back_s")}
            print(f"W {world} {name}: {gb:.2f} GB a partial, {len(shapes)} leaves | host ms a gather (rank 0, "
                  f"median of {args.reps}): copy out {med['copy_out_s']:.1f}, collective {med['collective_s']:.1f}, "
                  f"copy back {med['copy_back_s']:.1f}, total {sum(med.values()):.1f} | same bits "
                  f"{all(r['same_bits'] for r in records)} | {smi}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "elastic_bench.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
