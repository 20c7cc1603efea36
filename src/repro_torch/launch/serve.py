"""Serving launcher CLI: batched generation through the port's engines.

    # static batch over a dense cache, on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.serve --engine static --batch 4 --device cpu

    # continuous batching over a dense cache with a stagewise admission ramp
    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \
        --requests 12 --slots 8 --b1 2 --rho 2.0 --device cpu

    # paged, on the GPU (the default device), full-width qwen2.5-3b, random weights
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged --variant full \
        --requests 8 --slots 8 --prompt-len 512 --shared-prefix 256 \
        --new-tokens 32 --cache-len 2048 --chunk 256

    # on the CPU (the kernels' plain versions), smoke width
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged --device cpu

    # disaggregated prefill/decode: the prefill worker on the first
    # --prefill-devices devices' lead, the decode worker on the next
    # --decode-devices' (two cards at least, or --device cpu)
    PYTHONPATH=src python -m repro_torch.launch.serve --engine disagg \
        --requests 12 --slots 4 --prefill-devices 1 --decode-devices 1

``--arch`` takes the ported families: the dense decoders (gemma2-9b's
soft-capped attention included), rwkv6-1.6b and zamba2-2.7b (whose
recurrent state rides per slot beside the page pool; prefix sharing is off
for them, as in the JAX engine) and the MoE family (dbrx-132b,
arctic-480b; a prefill chunk is one routing group, a decoded token a group
of its own). whisper-tiny runs in the engines, which take each request's
audio embeddings (``submit(..., memory=...)``); this launcher, like the JAX
package's, makes no audio, so ``--arch whisper-tiny`` is an error naming
the missing input. The default engine is
``paged``. ``--engine disagg`` needs ``--prefill-devices +
--decode-devices`` devices, as the JAX launcher does: on one card it stops,
naming how many it needs (the engine API, ``DisaggregatedEngine``, runs
both workers on one card); with ``--device cpu`` the devices are that many
CPU devices, all the CPU.

``--mesh single|multi`` (with ``--engine static``, greedy) serves the
``--batch`` prompts on the production mesh of the visible cards (one CPU
worker with ``--device cpu``) through the sharded serving forward
(``distributed/mesh_serve.serve_on_mesh``: each layer gathered where it
runs); ``--tensor-parallel`` also splits the attention, MLPs, experts,
vocabulary and recurrent heads of every family but whisper (rwkv6's and
Mamba2's heads, zamba2's shared block) over the mesh's ``model`` groups,
each rank keeping the cache of its heads. It needs ``--mesh``, and
names the ``ROADMAP.md`` item for a family it does not cover yet.

    PYTHONPATH=src python -m repro_torch.launch.serve --engine static --mesh single --tensor-parallel --device cpu
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.sharding.partitioning import check_tensor_parallel
from repro_torch.launch.mesh import make_disagg_submeshes, visible_devices
from repro_torch.models import LanguageModel
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import (
    ContinuousBatchingEngine,
    DisaggregatedEngine,
    PagedContinuousBatchingEngine,
    ServeEngine,
)

log = logging.getLogger("repro_torch.serve")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help="the dense decoders (qwen2.5-3b, deepseek-7b/67b, gemma2-9b, internvl2-1b), "
                         "rwkv6-1.6b, zamba2-2.7b, the MoE family (dbrx-132b, arctic-480b); whisper-tiny "
                         "needs per-request audio, which this launcher does not make (use the engine API)")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--engine", choices=["static", "continuous", "paged", "disagg"], default="paged")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="weights, prompts and sampling noise")
    ap.add_argument("--batch", type=int, default=4, help="static: batch size")
    ap.add_argument("--requests", type=int, default=8, help="continuous, paged, disagg: request count")
    ap.add_argument("--slots", type=int, default=4, help="max slot-ring width")
    ap.add_argument("--b1", type=int, default=None,
                    help="initial slot budget (default: --slots, no ramp)")
    ap.add_argument("--rho", type=float, default=2.0, help="stage growth factor")
    ap.add_argument("--patience", type=int, default=2,
                    help="sustained-load ticks before a stage bump")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16, help="tokens per KV page")
    ap.add_argument("--pages", type=int, default=None,
                    help="pool size in pages (default: dense-equivalent)")
    ap.add_argument("--chunk", type=int, action="append", default=None,
                    help="prefill chunk size (repeatable for multiple buckets)")
    ap.add_argument("--prefix-cache", dest="prefix_cache", action="store_true", default=True,
                    help="share prompt-prefix pages (default)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache", action="store_false")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give all requests a common prompt prefix of this length")
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"],
                    help="static: serve on the production mesh through the sharded forward (greedy)")
    ap.add_argument("--tensor-parallel", action="store_true",
                    help="with --mesh: split attention, the dense MLPs, the experts, the vocabulary and rwkv6's "
                         "and Mamba2's heads over the mesh's model groups (every family but whisper)")
    ap.add_argument("--prefill-devices", type=int, default=1, help="disagg: pods in the prefill submesh")
    ap.add_argument("--decode-devices", type=int, default=1, help="disagg: pods in the decode submesh")
    ap.add_argument("--prefill-slots", type=int, default=2, help="disagg: prefill worker ring width")
    ap.add_argument("--prefill-pages", type=int, default=None,
                    help="disagg: prefill pool size in pages (default: prompt-dense-equivalent for the "
                         "prefill ring)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON of the run")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="dump the metrics registry snapshot as JSON")
    args = ap.parse_args(argv)

    for flag, value, low in (
        ("--batch", args.batch, 1),
        ("--requests", args.requests, 1),
        ("--slots", args.slots, 1),
        ("--patience", args.patience, 1),
        ("--prompt-len", args.prompt_len, 1),
        ("--new-tokens", args.new_tokens, 1),
        ("--cache-len", args.cache_len, 1),
        ("--page-size", args.page_size, 1),
        ("--shared-prefix", args.shared_prefix, 0),
        ("--top-k", args.top_k, 0),
    ):
        if value < low:
            ap.error(f"{flag} must be >= {low} (got {value})")
    if args.temperature < 0:
        ap.error(f"--temperature must be >= 0 (got {args.temperature})")
    if args.prompt_len + args.new_tokens > args.cache_len:
        ap.error(f"--prompt-len {args.prompt_len} + --new-tokens {args.new_tokens} "
                 f"exceeds --cache-len {args.cache_len}")
    if args.b1 is not None and not 1 <= args.b1 <= args.slots:
        ap.error(f"--b1 must be in [1, --slots={args.slots}] (got {args.b1})")
    if args.b1 is not None and args.b1 < args.slots and args.rho <= 1.0:
        ap.error(f"--rho must be > 1.0 to ramp {args.b1} -> {args.slots} slots")
    if args.shared_prefix > args.prompt_len:
        ap.error(f"--shared-prefix {args.shared_prefix} exceeds --prompt-len {args.prompt_len}")
    if args.chunk and any(c < 1 for c in args.chunk):
        ap.error(f"--chunk sizes must be >= 1 (got {args.chunk})")
    if args.pages is not None and args.pages < 2:
        ap.error(f"--pages must be >= 2 (pool reserves scratch page 0; got {args.pages})")
    if args.engine == "static" and args.b1 is not None:
        ap.error("--b1 requires --engine continuous or paged")
    if args.engine == "static" and (args.trace or args.metrics):
        ap.error("--trace/--metrics require a scheduled engine (--engine continuous, paged, or disagg)")
    if args.engine not in ("paged", "disagg"):
        if args.pages is not None:
            ap.error("--pages requires --engine paged or disagg")
        if args.chunk is not None:
            ap.error("--chunk requires --engine paged or disagg")
        if args.shared_prefix:
            ap.error("--shared-prefix requires --engine paged or disagg (prefix sharing)")
    if args.engine != "disagg":
        for flag, value, default in (("--prefill-devices", args.prefill_devices, 1),
                                     ("--decode-devices", args.decode_devices, 1),
                                     ("--prefill-slots", args.prefill_slots, 2),
                                     ("--prefill-pages", args.prefill_pages, None)):
            if value != default:
                ap.error(f"{flag} requires --engine disagg")
    else:
        if args.prefill_devices < 1 or args.decode_devices < 1:
            ap.error("--prefill-devices and --decode-devices must each be >= 1")
        if args.prefill_slots < 1:
            ap.error("--prefill-slots must be >= 1")
        if args.prefill_pages is not None and args.prefill_pages < 2:
            ap.error(f"--prefill-pages must be >= 2 (pool reserves scratch page 0; got {args.prefill_pages})")
    if args.tensor_parallel and args.mesh == "none":
        ap.error("--tensor-parallel splits compute over a mesh's model groups: it needs --mesh")
    if args.mesh != "none" and (args.engine != "static" or args.temperature > 0):
        ap.error("--mesh serves a static batch greedily: it needs --engine static and --temperature 0")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA device, and none is "
                           "available; pass --device cpu to run the plain versions on the CPU")

    grids = None
    if args.engine == "disagg":
        # the JAX launcher's devices: the visible cards (or, with --device
        # cpu, as many CPU devices as the grids take); never fewer
        need = args.prefill_devices + args.decode_devices
        devices = visible_devices() if args.device == "cuda" else [torch.device("cpu")] * need
        try:
            grids = make_disagg_submeshes(prefill_pods=args.prefill_devices, decode_pods=args.decode_devices,
                                          devices=devices)
        except ValueError as e:
            ap.error(f"--engine disagg: {e} (the launcher puts the prefill and decode workers on "
                     "disjoint devices; DisaggregatedEngine runs both on one card through its API)")

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    cfg = get_config(args.arch, args.variant)
    if args.tensor_parallel:
        try:
            check_tensor_parallel(cfg)
        except ValueError as e:
            ap.error(f"--tensor-parallel: {e}")
    if cfg.is_encoder_decoder:
        # the JAX launcher reaches its engines' "requires audio memory" error here
        ap.error(f"--arch {args.arch}: the encoder-decoder model requires per-request audio memory "
                 f"(audio_embeds (1, {cfg.encoder_seq}, {cfg.d_model}) a request), which this launcher "
                 "does not make; submit requests with memory= through the engine API")
    model = LanguageModel(cfg)
    params = model.init(args.seed, device=args.device)
    rng = np.random.default_rng(args.seed + 1)
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)

    if args.mesh != "none":
        return _serve_on_mesh(args, ap, model, params, rng)

    if args.engine == "static":
        prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
        engine = ServeEngine(model, params, cache_len=args.cache_len, device=args.device)
        sync()
        t0 = time.perf_counter()
        out = engine.generate(prompts, max_new_tokens=args.new_tokens)
        sync()
        wall = time.perf_counter() - t0
        for i, row in enumerate(out):
            log.info("req %d: %s -> %s", i, row[: args.prompt_len].tolist()[-8:],
                     row[args.prompt_len:].tolist())
        log.info("%d prompts in %.3f s | %d new tokens = %.1f tok/s", args.batch, wall,
                 args.batch * args.new_tokens, args.batch * args.new_tokens / wall)
        return dict(enumerate(out))

    tracer = Tracer() if args.trace else None
    metrics = MetricsRegistry() if args.metrics else None
    if args.engine == "disagg":
        prefill_grid, decode_grid = grids
        engine = DisaggregatedEngine(
            model, params, cache_len=args.cache_len, max_slots=args.slots,
            b1=args.b1, rho=args.rho, patience=args.patience, seed=args.seed,
            page_size=args.page_size, num_pages=args.pages, prefix_cache=args.prefix_cache,
            prefill_chunks=tuple(args.chunk) if args.chunk else (32,),
            prefill_slots=args.prefill_slots, prefill_pages=args.prefill_pages,
            prefill_device=prefill_grid.flat[0], decode_device=decode_grid.flat[0],
            tracer=tracer, metrics=metrics, device=args.device,
        )
        axes = ("pod", "data", "model")
        log.info("disagg submeshes: prefill %s on %s | decode %s on %s",
                 dict(zip(axes, prefill_grid.shape)), engine.prefill_device,
                 dict(zip(axes, decode_grid.shape)), engine.decode_device)
    elif args.engine == "paged":
        engine = PagedContinuousBatchingEngine(
            model, params, cache_len=args.cache_len, max_slots=args.slots,
            b1=args.b1, rho=args.rho, patience=args.patience, seed=args.seed,
            page_size=args.page_size, num_pages=args.pages, prefix_cache=args.prefix_cache,
            prefill_chunks=tuple(args.chunk) if args.chunk else (32,),
            tracer=tracer, metrics=metrics, device=args.device,
        )
    else:
        engine = ContinuousBatchingEngine(
            model, params, cache_len=args.cache_len, max_slots=args.slots,
            b1=args.b1, rho=args.rho, patience=args.patience, seed=args.seed,
            tracer=tracer, metrics=metrics, device=args.device,
        )
    prompts = rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len), dtype=np.int32)
    prompts[:, : args.shared_prefix] = prompts[0, : args.shared_prefix]
    ids = [
        engine.submit(p, max_new_tokens=args.new_tokens, temperature=args.temperature, top_k=args.top_k)
        for p in prompts
    ]
    sync()
    t0 = time.perf_counter()
    results = engine.run()
    sync()
    wall = time.perf_counter() - t0
    for rid in ids:
        row = results[rid]
        log.info("req %d: %s -> %s", rid, row[: args.prompt_len].tolist()[-8:],
                 row[args.prompt_len:].tolist())
    log.info("%d requests in %.3f s | %d decode tokens = %.1f tok/s", len(ids), wall,
             engine.stats["decoded_tokens"], engine.stats["decoded_tokens"] / wall)
    if args.engine == "continuous":
        log.info("admission ladder %s | peak width %d | %d decode ticks | %d tokens | "
                 "decode widths %s", engine.admission.ladder, engine.stats["peak_width"],
                 engine.stats["ticks"], engine.stats["decoded_tokens"], sorted(engine.decode_widths))
    else:
        mem = engine.memory_stats()
        log.info(
            "admission ladder %s | peak width %d | %d decode ticks | %d tokens | pages peak %d/%d | "
            "prefix hit-rate %.0f%% | prefill computed %d (%d reused) | kv peak %d KiB",
            engine.admission.ladder, engine.stats["peak_width"], engine.stats["ticks"],
            engine.stats["decoded_tokens"], mem["pages_peak"], mem["pages_capacity"],
            100 * mem["prefix_hit_rate"], engine.stats["prefill_tokens_computed"],
            engine.stats["prefix_tokens_reused"], mem["kv_bytes_peak"] // 1024,
        )
    if args.engine == "disagg":
        log.info("streamed %d transfer(s), %d page(s), %d KiB over the seam | adopted %d page(s) "
                 "decode-side | prefill pool peak %d/%d", engine.stats["transfers"],
                 engine.stats["pages_streamed"], engine.stats["seam_bytes"] // 1024,
                 engine.stats["pages_adopted"], mem["prefill_pages_peak"], mem["prefill_pages_capacity"])
    if tracer is not None:
        tracer.dump_chrome(args.trace)
    if metrics is not None:
        metrics.dump(args.metrics)
    return results


def _serve_on_mesh(args, ap, model, params, rng) -> dict:
    """``--mesh``: the static batch served greedily by the mesh's workers."""
    from repro_torch.distributed.mesh_serve import serve_on_mesh
    from repro_torch.launch.mesh import make_production_mesh

    devices = [torch.device("cpu")] if args.device == "cpu" else None
    try:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi", devices=devices)
    except ValueError as e:
        ap.error(f"--mesh {args.mesh}: {e}")
    prompts = rng.integers(0, model.cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    t0 = time.perf_counter()
    steps, = serve_on_mesh(mesh, [(model, params, prompts)], args.new_tokens, tensor_parallel=args.tensor_parallel)
    wall = time.perf_counter() - t0
    new = torch.cat([logits[:, -1].argmax(-1, keepdim=True) for logits in steps], dim=1).numpy()
    out = np.concatenate([prompts, new.astype(np.int32)], axis=1)
    for i, row in enumerate(out):
        log.info("req %d: %s -> %s", i, row[: args.prompt_len].tolist()[-8:], row[args.prompt_len:].tolist())
    log.info("mesh %s over %d worker(s)%s: %d prompts in %.3f s (spawn included)", mesh.shape, mesh.size,
             " (tensor-parallel)" if args.tensor_parallel else "", args.batch, wall)
    return dict(enumerate(out))


if __name__ == "__main__":
    main()
