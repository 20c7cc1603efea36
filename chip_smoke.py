#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Checks that CUDA is present (else exits 1) and prints the card's name
   and power limit; turns TF32 off for matmul and cuDNN.
2. Builds the paged-decode kernels from ``src/repro_torch/kernels/paged_decode/csrc``
   with nvcc (one process per source, in parallel).
3. Holds each kernel's wrapper (what the engine calls) against its plain
   PyTorch version on the card, at the main path's full-width shapes, and
   times both (L2-cold: the inputs rotate over copies that exceed the 50 MB
   L2 cache). Attention must agree within one bf16 ulp, and a planted
   fault (the plain version with the last visible key dropped) must not.
4. Drives the main path: the paged continuous-batching engine serving
   qwen2.5-3b at full width with random weights from a seeded generator,
   with every launch counter zeroed just before and read just after.
5. Checks the output: every request completes with in-vocabulary tokens,
   the page pool is consistent, prefix pages were reused, every kernel was
   launched, the full model's logits are finite, and on a small input the
   card's greedy tokens equal those of the CPU path (the plain versions).
6. Serves the same batch again under torch.profiler, tracing the device
   only, and prints the device's busy time, idle share and top kernels.

Any failed phase exits non-zero. The last lines of standard output are the
kernels' JSON record, the card's name and power limit as nvidia-smi gives
them, and ``{"ok": true, "device": {...}}``. A copy of the record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
L2_BYTES = 50 * 2**20
# Attention outputs are bf16: the kernel and the plain version each round an
# f32 result to bf16, so they may differ by one bf16 ulp, at most 2**-7 of
# the value; ATTN_ATOL covers values near 0.
ATTN_RTOL = 2.0**-7
ATTN_ATOL = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, arg_sets, iters: int) -> float:
    """Mean ms per call of ``fn(*args)``, rotating over ``arg_sets`` (whose
    inputs together exceed L2, so each call finds its inputs cold)."""
    import torch

    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    return max(2, -(-2 * L2_BYTES // nbytes))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def excess(out, expect) -> float:
    """Largest |out - expect| in units of its allowance, ATTN_ATOL +
    ATTN_RTOL * |expect|: at most 1 passes."""
    err = (out.float() - expect.float()).abs()
    return (err / (ATTN_ATOL + ATTN_RTOL * expect.float().abs())).max().item()


def check_close(name: str, out, expect, fault=None) -> dict:
    """Fail unless ``out`` is finite and within the allowance of ``expect``.
    ``fault`` is the plain version with a planted bug (the last key each
    query may see dropped): it must fall outside the allowance, or the
    tolerance could not see such a bug."""
    import torch

    reading = {"max_abs_err": (out.float() - expect.float()).abs().max().item(),
               "excess": excess(out, expect)}
    if not torch.isfinite(out.float()).all() or reading["excess"] > 1:
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{reading['max_abs_err']:.3e}, {reading['excess']:.2f} x the allowance)")
    if fault is not None:
        reading["fault_excess"] = excess(fault, expect)
        if reading["fault_excess"] <= 1:
            fail(f"{name}: the tolerance cannot tell a dropped key from the right answer")
    return reading


def paged_pool(gen, *, pages, ps, hkv, d, lengths, share_first_page):
    """bf16 K/V pools with scratch page 0 poisoned, and per-slot tables."""
    import torch

    k = torch.randn((pages, ps, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((pages, ps, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    k[0] = 1e4
    v[0] = 1e4
    mp = 2048 // ps
    table = torch.zeros((len(lengths), mp), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(lengths):
        n_pages = -(-n // ps)
        table[b, :n_pages] = torch.arange(nxt, nxt + n_pages, dtype=torch.int32)
        nxt += n_pages
    if share_first_page:
        table[1, 0] = table[0, 0]  # a published prefix page aliased copy-on-write
    return k, v, table.cuda()


def kv_bytes_read(table, q_hi, ps, hkv, d, itemsize) -> int:
    """Bytes of distinct K/V positions a call must read: slot b sees
    positions 0..q_hi[b] through its table (shared pages counted once)."""
    seen, table = set(), table.cpu()
    for b, hi in enumerate(q_hi.tolist()):
        for pos in range(hi + 1):
            seen.add((int(table[b, pos // ps]), pos % ps))
    return 2 * len(seen) * hkv * d * itemsize


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def merge(readings: list) -> dict:
    return {key: max(r[key] for r in readings if key in r)
            for key in ("max_abs_err", "excess", "fault_excess")}


def kernel_checks(kernel_records: dict) -> None:
    """Phase 3: every kernel's wrapper (what the engine calls) against its
    plain version at full width."""
    import torch

    from repro_torch.kernels.paged_decode import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, hq, hkv, d, ps, pages = 8, 16, 2, 128, 16, 1025

    # -- paged decode: ragged lengths around 544, one COW-shared page, a
    #    slot ending on a page boundary, a one-token slot, page 0 poisoned
    lengths = [544, 512, 1, 1100, 600, 700, 300, 595]
    k, v, table = paged_pool(gen, pages=pages, ps=ps, hkv=hkv, d=d, lengths=lengths,
                             share_first_page=True)
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32, device="cuda")
    dropped = (pos - 1).clamp_min(0)  # planted fault: the last key dropped
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
    readings = [check_close("paged_flash_decode", ops.paged_flash_decode(q, k, v, table, pos),
                            ref.paged_attention_ref(q, k, v, table, pos),
                            ref.paged_attention_ref(q, k, v, table, dropped))]
    readings.append(check_close(
        "paged_flash_decode (window, softcap)",
        ops.paged_flash_decode(q, k, v, table, pos, sliding_window=100, softcap=30.0),
        ref.paged_attention_ref(q, k, v, table, pos, sliding_window=100, softcap=30.0),
    ))
    sets = [(q.clone(), k.clone(), v.clone(), table, pos) for _ in range(copies_for(nbytes(q, k, v)))]
    io = nbytes(q) * 2 + nbytes(table, pos)
    kv = kv_bytes_read(table, pos, ps, hkv, d, 2)
    kernel_records["paged_flash_decode"] = dict(
        **merge(readings),
        ms=timed(ops.paged_flash_decode, sets, 200),
        plain_ms=timed(ref.paged_attention_ref, sets, 20),
        bound=bound(io + kv, 4 * hq * d * sum(lengths), BF16_FLOPS),
    )

    # -- paged chunk prefill: one 256-token chunk at pos_start 0 and 256
    c = 256
    k, v, table = paged_pool(gen, pages=pages, ps=ps, hkv=hkv, d=d, lengths=[512],
                             share_first_page=False)
    q = torch.randn((1, c, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
    readings = []
    for start in (0, 256):
        ps_t = torch.tensor([start], dtype=torch.int32, device="cuda")
        fault = ref.paged_prefill_ref(q, k, v, table, ps_t - 1) if start else None
        readings.append(check_close(f"paged_chunk_prefill (pos_start {start})",
                                    ops.paged_chunk_prefill(q, k, v, table, ps_t),
                                    ref.paged_prefill_ref(q, k, v, table, ps_t), fault))
    ps_t = torch.tensor([256], dtype=torch.int32, device="cuda")
    readings.append(check_close(
        "paged_chunk_prefill (window, softcap)",
        ops.paged_chunk_prefill(q, k, v, table, ps_t, sliding_window=100, softcap=30.0),
        ref.paged_prefill_ref(q, k, v, table, ps_t, sliding_window=100, softcap=30.0),
    ))
    sets = [(q.clone(), k.clone(), v.clone(), table, ps_t) for _ in range(copies_for(nbytes(q, k, v)))]
    visible = sum(256 + i + 1 for i in range(c))  # keys each query sees
    io = nbytes(q) * 2 + nbytes(table, ps_t)
    kv = kv_bytes_read(table, ps_t + c - 1, ps, hkv, d, 2)
    kernel_records["paged_chunk_prefill"] = dict(
        **merge(readings),
        ms=timed(ops.paged_chunk_prefill, sets, 50),
        plain_ms=timed(ref.paged_prefill_ref, sets, 10),
        bound=bound(io + kv, 4 * hq * d * visible, BF16_FLOPS),
    )

    # -- fused sampler: greedy, t=0.8 with top_k in {0, 1, 50}, a duplicated
    #    50th value, and a top_k above the vocabulary
    vocab = 151936
    logits = torch.randn((b, vocab), generator=gen, device="cuda") * 3
    top = torch.randperm(vocab, generator=gen, device="cuda")[:60]
    logits[5, top[:49]] = 20 + torch.arange(49, device="cuda", dtype=torch.float32)
    logits[5, top[49:54]] = 19.5  # the 50th largest, five times
    temperature = torch.tensor([0, 0, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8], device="cuda")
    top_k = torch.tensor([0, 50, 0, 1, 50, 50, 0, vocab + 7], dtype=torch.int32, device="cuda")
    noise = -torch.log(-torch.log(torch.rand((b, vocab), generator=gen, device="cuda").clamp_min(1e-38)))
    got = ops.fused_sample(logits, noise, temperature, top_k)
    expect = ref.fused_sample_ref(logits, noise, temperature, top_k)
    mismatched = int((got != expect).sum())
    if mismatched:
        fail(f"fused_sample: {mismatched} tokens differ from the plain version: "
             f"{got.tolist()} vs {expect.tolist()}")
    sets = [(logits.clone(), noise.clone(), temperature, top_k) for _ in range(copies_for(nbytes(logits, noise)))]
    sampled = int((temperature > 0).sum())  # greedy rows read no noise
    io = nbytes(logits, temperature, top_k) + 4 * vocab * sampled + 4 * b
    kernel_records["fused_sample"] = dict(
        max_abs_err=mismatched,  # tokens that differ
        ms=timed(ops.fused_sample, sets, 100),
        plain_ms=timed(ref.fused_sample_ref, sets, 20),
        bound=bound(io, vocab * (b - sampled) + 4 * vocab * sampled, F32_FLOPS),
    )


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def small_input_agreement() -> None:
    """Greedy tokens of the engine on the card (kernels) equal the CPU
    path's (plain versions) on qwen2.5-3b smoke in float32."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.serve import PagedContinuousBatchingEngine

    cfg = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    model = LanguageModel(cfg)
    cpu_params = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 8)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 4 + i)]) for i in range(4)]
    streams = {}
    for device in ("cpu", "cuda"):
        params = to_device(cpu_params, device)
        engine = PagedContinuousBatchingEngine(
            model, params, cache_len=64, max_slots=2, page_size=4, prefill_chunks=(4,), seed=0,
            device=device,
        )
        ids = [engine.submit(p, max_new_tokens=6) for p in prompts]
        out = engine.run()
        streams[device] = [out[i].tolist() for i in ids]
    if streams["cpu"] != streams["cuda"]:
        fail(f"small-input greedy tokens differ: cpu {streams['cpu']} vs cuda {streams['cuda']}")


def device_profile(run) -> dict:
    """Phase 6: ``run()`` under torch.profiler, tracing the device only
    (kernels, copies, memsets). The device's busy time (the union of its
    activity intervals) and the run's wall time come from this one run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "profile.tmp.json"  # too large to keep
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    device = [ev for ev in events if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        fail("the traced run recorded no device activity")
    busy, end = 0.0, float("-inf")
    for s, e in sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in device):
        if e > end:
            busy += e - max(s, end)
            end = e
    by_kernel: dict = {}
    for ev in device:
        ms, n = by_kernel.get(ev["name"], (0.0, 0))
        by_kernel[ev["name"]] = (ms + ev["dur"] / 1e3, n + 1)
    return {
        "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
        "activities": len(device),
        "by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]),
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs one CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_decode import kernel as K, ops
    from repro_torch.models import LanguageModel
    from repro_torch.serve import PagedContinuousBatchingEngine

    # 1. device
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    seconds = K.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + " ".join(f"{n}={s:.1f}s" for n, s in seconds.items()), flush=True)
    for lib, log in K.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{lib}]: {line.strip()}")

    # 3. kernels against their plain versions
    records: dict = {}
    kernel_checks(records)
    print("kernel checks: ok | tolerance readings, in units of the allowance (sound <= 1 < planted "
          "fault): " + ", ".join(f"{n} {r['excess']:.3f} vs {r['fault_excess']:.1f}"
                                 for n, r in records.items() if "excess" in r), flush=True)

    # 4. the main path at full width
    cfg = get_config("qwen2.5-3b", "full")
    model = LanguageModel(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: {cfg.name} full, {cfg.param_counts()['total']} params "
          f"({cfg.param_dtype}, compute {cfg.compute_dtype}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    engine = PagedContinuousBatchingEngine(
        model, params, max_slots=8, page_size=16, cache_len=2048, prefill_chunks=(256,), seed=0,
    )
    rng = torch.Generator().manual_seed(2)
    prefix = torch.randint(0, cfg.vocab_size, (256,), generator=rng)

    def prompt():
        return torch.cat([prefix, torch.randint(0, cfg.vocab_size, (256,), generator=rng)]).numpy()

    def submit_batch():
        return [
            engine.submit(prompt(), max_new_tokens=32,
                          temperature=0.0 if i % 2 == 0 else 0.8, top_k=0 if i % 2 == 0 else 50)
            for i in range(8)
        ]

    # warm-up: one request publishes the shared prefix to the radix index
    engine.submit(prompt(), max_new_tokens=4)
    engine.run()
    engine.reset_stats()
    ids = submit_batch()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    # 5. output checks
    for rid in ids:
        gen_tokens = results[rid][512:]
        if len(gen_tokens) != 32 or gen_tokens.min() < 0 or gen_tokens.max() >= cfg.vocab_size:
            fail(f"request {rid}: bad generated tokens {gen_tokens.tolist()}")
    engine.pool.check()
    stats, mem = copy.deepcopy(engine.stats), engine.memory_stats()  # phase 6 serves on
    if stats["prefix_tokens_reused"] <= 0:
        fail("no prefix tokens were reused")
    for kname, n in launches.items():
        if n <= 0:
            fail(f"{kname} was not launched on the main path")
    with torch.inference_mode():
        probe, _ = model.decode_step(
            params, torch.zeros((1, 1), dtype=torch.int32, device="cuda"), engine.cache,
            torch.zeros((1,), dtype=torch.int32, device="cuda"),
            torch.zeros((1, engine.max_pages), dtype=torch.int32, device="cuda"),
        )
    if probe.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(probe).all():
        fail("full-width decode logits are not finite")

    # 6. where the time goes: the same batch again, traced on the device
    submit_batch()
    profile = device_profile(engine.run)
    engine.pool.check()
    print(f"profile: device busy {profile['busy_ms']:.1f} ms of {profile['wall_ms']:.1f} ms wall, idle "
          f"{100 * profile['idle_share']:.1f}% | {profile['activities']} device activities | traced "
          f"run {profile['wall_ms'] / (wall * 1e3):.2f} x the untraced one", flush=True)
    for kname, (ms, n) in list(profile["by_kernel"].items())[:8]:
        print(f"profile: {ms:9.2f} ms {n:6d} x  {kname[:100]}")

    small_input_agreement()
    ops.reset_launches()
    decode_tick_ms = sorted(stats["decode_tick_s"])[len(stats["decode_tick_s"]) // 2] * 1e3
    print(
        f"engine: {len(ids)} requests x 32 tokens in {wall:.3f} s | decode {stats['decoded_tokens']} "
        f"tokens = {stats['decoded_tokens'] / wall:.1f} tok/s | median decode tick {decode_tick_ms:.2f} ms "
        f"| {stats['ticks']} ticks, {stats['prefill_chunks']} chunks | prefix reused "
        f"{stats['prefix_tokens_reused']} | pages peak {mem['pages_peak']}/{mem['pages_capacity']} "
        f"| peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
        flush=True,
    )
    print(f"launches: {launches} | per decode tick {launches['paged_flash_decode'] / stats['ticks']:.0f}, "
          f"per chunk {launches['paged_chunk_prefill'] / stats['prefill_chunks']:.0f}", flush=True)

    sources = {
        "paged_flash_decode": ("csrc/paged_attention.cu", 84),
        "paged_chunk_prefill": ("csrc/paged_attention.cu", 171),
        "fused_sample": ("csrc/fused_sample.cu", 238),
    }
    kernels = []
    for kname, rec in records.items():
        bound_ms, bound_by = rec["bound"]
        src, line = sources[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/paged_decode/{src}",
            "replaces": f"src/repro/kernels/paged_decode/kernel.py:{line}",
            "launches": launches[kname], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    record = {"kernels": kernels}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        **record, "nvidia_smi": smi, "tolerance": {
            n: {key: r[key] for key in ("excess", "fault_excess")} for n, r in records.items() if "excess" in r
        }, "profile": profile, "engine": {
            "wall_s": wall, "decoded_tokens": stats["decoded_tokens"], "ticks": stats["ticks"],
            "prefill_chunks": stats["prefill_chunks"], "median_decode_tick_ms": decode_tick_ms,
            "pages_peak": mem["pages_peak"], "prefix_tokens_reused": stats["prefix_tokens_reused"],
        },
    }, indent=1))
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
