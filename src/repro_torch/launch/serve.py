"""Serving launcher CLI: the paged continuous-batching engine.

    # on the GPU (the default device), full-width qwen2.5-3b, random weights
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged --variant full \
        --requests 8 --slots 8 --prompt-len 512 --shared-prefix 256 \
        --new-tokens 32 --cache-len 2048 --chunk 256

    # on the CPU (the kernels' plain versions), smoke width
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged --device cpu

The static, continuous and disaggregated engines of the JAX launcher come
with later slices of the port; asking for them is an error.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import LanguageModel
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import PagedContinuousBatchingEngine

log = logging.getLogger("repro_torch.serve")

_LATER_ENGINES = {
    "static": "the dense-serving slice",
    "continuous": "the dense-serving slice",
    "disagg": "the disaggregated-serving slice",
}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--engine", choices=["static", "continuous", "paged", "disagg"], default="paged")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="weights, prompts and sampling noise")
    ap.add_argument("--requests", type=int, default=8)
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
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON of the run")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="dump the metrics registry snapshot as JSON")
    args = ap.parse_args(argv)

    if args.engine in _LATER_ENGINES:
        ap.error(f"--engine {args.engine} comes with {_LATER_ENGINES[args.engine]} of the port; "
                 "this one serves --engine paged")
    for flag, value, low in (
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
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA device, and none is "
                           "available; pass --device cpu to run the plain versions on the CPU")

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    cfg = get_config(args.arch, args.variant)
    model = LanguageModel(cfg)
    params = model.init(args.seed, device=args.device)
    tracer = Tracer() if args.trace else None
    metrics = MetricsRegistry() if args.metrics else None
    engine = PagedContinuousBatchingEngine(
        model, params, cache_len=args.cache_len, max_slots=args.slots,
        b1=args.b1, rho=args.rho, patience=args.patience, seed=args.seed,
        page_size=args.page_size, num_pages=args.pages, prefix_cache=args.prefix_cache,
        prefill_chunks=tuple(args.chunk) if args.chunk else (32,),
        tracer=tracer, metrics=metrics, device=args.device,
    )
    prompts = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab_size, (args.requests, args.prompt_len), dtype=np.int32
    )
    prompts[:, : args.shared_prefix] = prompts[0, : args.shared_prefix]
    ids = [
        engine.submit(p, max_new_tokens=args.new_tokens, temperature=args.temperature, top_k=args.top_k)
        for p in prompts
    ]
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    results = engine.run()
    sync()
    wall = time.perf_counter() - t0
    for rid in ids:
        row = results[rid]
        log.info("req %d: %s -> %s", rid, row[: args.prompt_len].tolist()[-8:],
                 row[args.prompt_len:].tolist())
    mem = engine.memory_stats()
    log.info("%d requests in %.3f s | %d decode tokens = %.1f tok/s", len(ids), wall,
             engine.stats["decoded_tokens"], engine.stats["decoded_tokens"] / wall)
    log.info(
        "admission ladder %s | peak width %d | %d decode ticks | %d tokens | pages peak %d/%d | "
        "prefix hit-rate %.0f%% | prefill computed %d (%d reused) | kv peak %d KiB",
        engine.admission.ladder, engine.stats["peak_width"], engine.stats["ticks"],
        engine.stats["decoded_tokens"], mem["pages_peak"], mem["pages_capacity"],
        100 * mem["prefix_hit_rate"], engine.stats["prefill_tokens_computed"],
        engine.stats["prefix_tokens_reused"], mem["kv_bytes_peak"] // 1024,
    )
    if tracer is not None:
        tracer.dump_chrome(args.trace)
    if metrics is not None:
        metrics.dump(args.metrics)
    return results


if __name__ == "__main__":
    main()
