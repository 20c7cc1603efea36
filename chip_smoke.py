#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Checks that CUDA is present (else exits 1) and prints the card's name
   and power limit; turns TF32 off for matmul and cuDNN.
2. Builds every kernel family (``src/repro_torch/kernels/*/csrc``) with
   nvcc, one process per source, in parallel; prints ptxas' registers,
   spills and wgmma warnings, and the HGMMA (wgmma) count in the SASS of
   each flash kernel, which must be above 0 for the bf16 (tensor-core) ones.
3. Holds each kernel's wrapper against its plain PyTorch version on the
   card, at the main paths' full-width shapes, and times both (L2-cold: the
   inputs rotate over copies that exceed the 50 MB L2 cache, or are larger
   than it). Attention forwards must agree within one bf16 ulp and a
   planted fault (the plain version with the last visible key dropped) must
   not; the flash backward within two bf16 ulps plus 1e-3 of each
   gradient's largest value, while a planted fault (the Di term left out)
   must not; the flash kernels' f32 route (CUDA cores) at a small shape
   within 2e-5 (forward) and 1e-5 (backward); the fused updates bit for bit
   over every leaf of the tree their run updates.
   scaled_dot_product_attention is timed beside the flash kernels as a
   yardstick only, under one named backend (flash where it takes GQA) and
   under the default dispatch. The GLA forward at rwkv6's training
   shape (S 513, not a whole number of chunks), at S 512 and at its serving
   shape (a 256-token chunk from a carried state), and the GLA backward at
   the training shape, within GLA_TOL, while planted faults (bonus left
   out, initial state undecayed, chunk-total decay term left out of
   dlog_w) must not be; the backward gives the same bits twice.
4. Drives the serving path: the paged continuous-batching engine serving
   qwen2.5-3b at full width with random weights from a seeded generator,
   with every launch counter zeroed just before and read just after.
5. Checks the serving output: every request completes with in-vocabulary
   tokens, the page pool is consistent, prefix pages were reused, every
   kernel was launched, the full model's logits are finite, and on a small
   input the card's greedy tokens equal those of the CPU path.
6. Serves the same batch again under torch.profiler, tracing the device
   only, and prints the device's busy time, idle share and top kernels.
7. Drives the training path: SEBSTrainer with pSGD (gamma 1e4, eta 1) on
   qwen2.5-3b at full width (SEBS b1 4, C1 16, rho 2, 3 stages, seq 512,
   microbatch 4: 12 updates at batch 4, 8 and 16), counters zeroed just
   before and read just after; then momentum (beta 0.9, eta 0.3) and
   AdaGrad-DA (eta 1), each the same schedule at full width and 8 layers. Each run must follow the
   schedule's stage ladder exactly, give finite losses, end below its first
   loss and launch its kernels.
8. On qwen2.5-3b smoke in float32, the first update's gradients on the card
   equal the CPU path's (the plain versions) within 1e-4 of each leaf's
   norm, and the losses of a short SEBS run within 1e-4 relative, while a
   control CPU run from weights moved by 1e-7 stays within half of that.
9. Traces one full-width pSGD update on the device (as phase 6).
10. Serves rwkv6-1.6b at full width through the same engine (8 requests
    of 512 + 32 tokens, 256-token chunks), counters zeroed just before and
    read just after: the GLA forward runs once a layer and chunk, the
    sampler every tick, no prefix is shared; traces the same batch again;
    greedy tokens on the card equal the CPU path's on rwkv6 smoke.
11. Trains rwkv6-1.6b at full width with SEBS and pSGD on phase 7's
    schedule: the GLA forward runs twice a layer and microbatch (remat), the
    backward once; traces a stage-2 update; on rwkv6 smoke the card agrees
    with the CPU path as in phase 8 (its SEBS run at eta 0.01, where the
    control run holds: see CARD_CPU_ETAS).

Any failed phase exits non-zero. The last lines of standard output are the
kernels' JSON record, the card's name and power limit as nvidia-smi gives
them, and ``{"ok": true, "device": {...}}``. A copy of the record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import copy
import gc
import json
import math
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


def device_ms(fn, arg_sets, iters: int) -> float:
    """Device busy ms per call of ``fn(*args)`` (its kernels alone, without
    the host's gaps between calls), from one traced run of ``iters`` calls
    rotating over ``arg_sets``."""
    for args in arg_sets[:2]:
        fn(*args)

    def run():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    return device_profile(run)["busy_ms"] / iters


def copies_for(nbytes: int) -> int:
    return max(2, -(-2 * L2_BYTES // nbytes))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def excess(out, expect) -> float:
    """Largest |out - expect| in units of its allowance, ATTN_ATOL +
    ATTN_RTOL * |expect|: at most 1 passes."""
    err = (out.float() - expect.float()).abs()
    return (err / (ATTN_ATOL + ATTN_RTOL * expect.float().abs())).max().item()


def check_close(name: str, out, expect, fault=None, allowance=None) -> dict:
    """Fail unless ``out`` is finite and within the allowance of ``expect``
    (``allowance(out, expect)``, the largest error in units of the
    allowance; the attention forwards' by default). ``fault`` is the plain
    version with a planted bug (for attention, the last key each query may
    see dropped): it must fall outside the allowance, or the tolerance could
    not see such a bug."""
    import torch

    allowance = allowance or excess
    reading = {"max_abs_err": (out.float() - expect.float()).abs().max().item(),
               "excess": allowance(out, expect)}
    if not torch.isfinite(out.float()).all() or reading["excess"] > 1:
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{reading['max_abs_err']:.3e}, {reading['excess']:.2f} x the allowance)")
    if fault is not None:
        reading["fault_excess"] = allowance(fault, expect)
        if reading["fault_excess"] <= 1:
            fail(f"{name}: the tolerance cannot tell the planted fault from the right answer")
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
    """The worst reading of each kind: the largest error and excess, the
    planted fault closest to passing."""
    out = {key: max(r[key] for r in readings) for key in ("max_abs_err", "excess")}
    faults = [r["fault_excess"] for r in readings if "fault_excess" in r]
    if faults:
        out["fault_excess"] = min(faults)
    return out


def hgmma_counts() -> dict:
    """The HGMMA (wgmma) instructions in the SASS of each flash kernel, from
    cuobjdump of the built library: name<head_dim> -> count."""
    import re

    from repro_torch.kernels import _cuda

    tool = Path(_cuda.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_cuda.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(r"\d+(flash_\w+?_kernel)ILi(\d+)E", line)
            current = f"{found.group(1)}<{found.group(2)}>" if found else None
            if current:
                counts[current] = 0
        elif current and "HGMMA" in line:
            counts[current] += 1
    if not counts:
        fail("cuobjdump found no flash kernel in the built library")
    return dict(sorted(counts.items()))


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


def small_input_agreement(arch: str) -> None:
    """Greedy tokens of the engine on the card (kernels) equal the CPU
    path's (plain versions) on ``arch`` smoke in float32."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.serve import PagedContinuousBatchingEngine

    cfg = get_config(arch, "smoke").replace(compute_dtype="float32")
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
        fail(f"{arch} small-input greedy tokens differ: cpu {streams['cpu']} vs cuda {streams['cuda']}")


def device_profile(run) -> dict:
    """``run()`` under torch.profiler, tracing the device only
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


# The flash backward's outputs are bf16 too, but dS = P (dP - Di) cancels,
# so an element near zero carries the f32 error of its tensor's scale:
# two bf16 ulps of the value plus 1e-3 of the tensor's largest value.
BWD_RTOL = 2.0**-6
BWD_SCALE_TOL = 1e-3
LIBRARY_NONE = "no single PyTorch call computes this update"
# Learning rates of the training runs: the largest of 0.3, 1, 3 and 10 with
# which 12 SEBS updates of the 8-layer model stayed finite and fell
# (tools/train_lr_scan.py; 3 diverged in the second stage), and 0.3 for
# momentum, whose beta = 0.9 multiplies its steps up to tenfold. For
# rwkv6-1.6b (all 24 layers) the same scan gave 11.5833 -> 11.3441 / 11.2839
# / 17.4028 / NaN at 0.3 / 1 / 3 / 10 (on an H100 80GB HBM3 at 700 W).
ETAS = {"psgd": 1.0, "momentum": 0.3, "adagrad_da": 1.0, "rwkv6_psgd": 1.0}


def excess_bwd(out, expect, rtol: float = BWD_RTOL, scale_tol: float = BWD_SCALE_TOL) -> float:
    """Largest |out - expect| in units of the allowance rtol |expect| +
    scale_tol max |expect| (the flash backward's by default)."""
    err = (out.float() - expect.float()).abs()
    allow = rtol * expect.float().abs() + scale_tol * expect.float().abs().max()
    return (err / allow).max().item()


# GLA. The kernels and the plain recurrence both compute in f32 from the same
# inputs, in other orders (chunked products against a step-by-step scan) and
# with the fast exp: f32 outputs (final state, dlog_w, du, ds0) agree within
# 1e-4 relative plus 1e-4 of the output's largest value; bf16 outputs are
# rounded once more (y: one bf16 ulp, dq, dk, dv: two) plus 1e-3 of the
# largest value, for elements that cancel near zero.
GLA_TOL = {"float32": (1e-4, 1e-4), "y": (2.0**-7, 1e-3), "grad": (2.0**-6, 1e-3)}
LIBRARY_NONE_GLA = "no single PyTorch call computes gated linear attention"


def check_scaled(name: str, out, expect, tol: str, fault=None) -> dict:
    """check_close with the GLA allowance GLA_TOL[tol]."""
    return check_close(name, out, expect, fault, lambda o, e: excess_bwd(o, e, *GLA_TOL[tol]))


def gla_inputs(gen, b: int, s: int, h: int, initial_state: bool):
    """bf16 q, k, v and dy; f32 log_w from RWKV6's decay range (log_w =
    -exp(base + noise), the per-channel base spanning -6 to -1 as RWKV6's
    decay speeds do); a random bonus u (the model starts it at zero, which
    would hide a fault in it) and initial state."""
    import torch

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    q, k, v, dy = (rand(b, s, h, 64).to(torch.bfloat16) for _ in range(4))
    lw = -torch.exp(torch.linspace(-6, -1, 64, device="cuda") + rand(b, s, h, 64, scale=0.5))
    s0 = rand(b, h, 64, 64, scale=0.3) if initial_state else None
    return q, k, v, lw, rand(h, 64, scale=0.5), s0, dy


def gla_products(s: int, backward: bool) -> int:
    """Multiply-adds x 2 of the chunked form's matrix products for one
    (batch, head) over S positions (the last chunk as long as it is):
    forward A (L L K), A v (L L V), q S and k^T v (L K V each); the backward
    recomputes A and adds dA, A^T dy, dq and dk's pairwise (L L K each, L L V
    for the two with V) and four L K V products."""
    total = 0
    for t0 in range(0, s, 64):
        n = min(64, s - t0)
        total += 2 * (3 * n * n * 64 + 2 * n * n * 64 + 4 * n * 64 * 64) if backward else \
            2 * (2 * n * n * 64 + 2 * n * 64 * 64)
    return total


def dlog_w_without_chunk_totals(q, k, v, lw, u, dy, d_lw):
    """The planted backward fault: the plain dlog_w with each chunk's total
    decay term left out, i.e. minus rowsum(dS_{n+1} * S_{n+1}) on every row of
    chunk n, with S_{n+1} the state after the chunk and dS_{n+1} its gradient
    (from the plain recurrence run chunk by chunk)."""
    import torch

    from repro_torch.kernels.gla import ref

    b, s, h, _ = q.shape
    state = torch.zeros((b, h, 64, 64), device=q.device, requires_grad=True)
    ys, ends = [], []
    with torch.enable_grad():
        for t0 in range(0, s, 64):
            rows = slice(t0, t0 + 64)
            y, state = ref.gla_fwd_ref(q[:, rows], k[:, rows], v[:, rows], lw[:, rows], bonus_u=u,
                                       include_current=False, initial_state=state)
            ys.append(y)
            ends.append(state)
        d_ends = torch.autograd.grad(torch.cat(ys, dim=1), ends, dy, allow_unused=True)
    out = d_lw.clone()
    for t0, d_end, end in zip(range(0, s, 64), d_ends, ends):
        if d_end is not None:
            out[:, t0:t0 + 64] -= (d_end * end).sum(-1)[:, None]
    return out


def gla_checks(records: dict) -> dict:
    """The GLA kernels through their ops wrappers against the plain
    recurrence: the forward at the training shape (rwkv6-1.6b, microbatch 4
    of 513-token rows: B 4, S 513, H 32, not a multiple of the 64-step
    chunk), at S 512, and at the serving shape (a 256-token prefill chunk of
    one request: B 1, S 256, with an initial state); the backward at the
    training shape. Planted faults: the bonus left out (training shape),
    the initial state's decay dropped (serving shape), each chunk's total
    decay term left out of dlog_w (backward). Returns the serving shape's
    timings."""
    import torch

    from repro_torch.kernels.gla import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    fwd, bwd = [], []
    # training shape
    q, k, v, lw, u, _, dy = gla_inputs(gen, 4, 513, 32, initial_state=False)
    y, final, states = ops.forward(q, k, v, lw, u, include_current=False, save_states=True)
    expect_y, expect_final = ref.gla_fwd_ref(q, k, v, lw, bonus_u=u, include_current=False)
    no_bonus = ref.gla_fwd_ref(q, k, v, lw, include_current=False)[0]
    fwd.append(check_scaled("gla_fwd y (B 4, S 513)", y, expect_y, "y", no_bonus))
    fwd.append(check_scaled("gla_fwd final state (B 4, S 513)", final, expect_final, "float32"))
    grads = ops.backward(q, k, v, lw, u, None, states, final, dy, None, include_current=False)
    expect = ref.gla_bwd_ref(q, k, v, lw, u, None, dy, None, include_current=False)
    again = ops.backward(q, k, v, lw, u, None, states, final, dy, None, include_current=False)
    if not all(torch.equal(x, y_) for x, y_ in zip(grads, again) if x is not None):
        fail("gla_bwd: two runs on the same inputs differ")
    fault = dlog_w_without_chunk_totals(q, k, v, lw, u, dy, expect[3])
    for name, g, e in zip(("dq", "dk", "dv", "dlog_w", "du"), grads, expect):
        tol = "grad" if g.dtype == torch.bfloat16 else "float32"
        bwd.append(check_scaled(f"gla_bwd {name}", g, e, tol, fault if name == "dlog_w" else None))
    sets = [(q.clone(), k.clone(), v.clone(), lw.clone(), u) for _ in range(copies_for(nbytes(q, k, v, lw)))]
    bwd_sets = [(*x, None, states.clone(), final.clone(), dy.clone(), None) for x in sets]
    b, s, h = q.shape[:3]
    io = nbytes(q, k, v, lw, u) + nbytes(v) + 4 * b * h * 64 * 64  # y and the final state written
    records["gla_fwd"] = dict(
        **merge(fwd),
        ms=timed(lambda *a: ops.forward(*a, include_current=False, save_states=True), sets, 50),
        plain_ms=timed(lambda q_, k_, v_, lw_, u_: ref.gla_fwd_ref(q_, k_, v_, lw_, bonus_u=u_,
                                                                   include_current=False), sets, 3),
        bound=bound(io, b * h * gla_products(s, backward=False), BF16_FLOPS),
        library_ms=None,
    )
    records["gla_bwd"] = dict(
        **merge(bwd),
        ms=timed(lambda *a: ops.backward(*a, include_current=False), bwd_sets, 20),
        plain_ms=timed(lambda *a: ref.gla_bwd_ref(*a[:6], a[8], a[9], include_current=False),
                       bwd_sets, 2),
        # reads q, k, v, dy, log_w and u; writes dq, dk, dv, dlog_w and du
        bound=bound(nbytes(q, k, v, dy, lw, u) + nbytes(q, k, v, lw, u),
                    b * h * gla_products(s, backward=True), BF16_FLOPS),
        library_ms=None,
    )
    del q, k, v, lw, dy, y, final, states, grads, again, expect, fault, sets, bwd_sets
    # S 512, a whole number of chunks
    q, k, v, lw, u, _, _ = gla_inputs(gen, 4, 512, 32, initial_state=False)
    fwd.append(check_scaled("gla_fwd y (B 4, S 512)", ops.forward(q, k, v, lw, u, include_current=False)[0],
                            ref.gla_fwd_ref(q, k, v, lw, bonus_u=u, include_current=False)[0], "y"))
    # serving shape: one 256-token prefill chunk from a slot's carried state
    q, k, v, lw, u, s0, _ = gla_inputs(gen, 1, 256, 32, initial_state=True)
    y, final, _ = ops.forward(q, k, v, lw, u, s0, include_current=False)
    expect_y, expect_final = ref.gla_fwd_ref(q, k, v, lw, bonus_u=u, include_current=False,
                                             initial_state=s0)
    undecayed = (ref.gla_fwd_ref(q, k, v, lw, bonus_u=u, include_current=False)[0].float()
                 + torch.einsum("bshk,bhkv->bshv", q.float(), s0))
    fwd.append(check_scaled("gla_fwd y (B 1, S 256, initial state)", y, expect_y, "y", undecayed))
    fwd.append(check_scaled("gla_fwd final state (B 1, S 256)", final, expect_final, "float32"))
    records["gla_fwd"].update(merge(fwd))
    sets = [(q.clone(), k.clone(), v.clone(), lw.clone(), u, s0.clone())
            for _ in range(copies_for(nbytes(q, k, v, lw, s0)))]
    io = nbytes(q, k, v, lw, u, s0) + nbytes(v) + nbytes(s0)
    return dict(
        ms=timed(lambda *a: ops.forward(*a, include_current=False), sets, 100),
        plain_ms=timed(lambda q_, k_, v_, lw_, u_, s0_: ref.gla_fwd_ref(
            q_, k_, v_, lw_, bonus_u=u_, include_current=False, initial_state=s0_), sets, 3),
        bound=bound(io, q.shape[0] * q.shape[2] * gla_products(q.shape[1], backward=False), BF16_FLOPS),
    )


def leaf_shapes(cfg) -> list:
    """Shapes of the parameter leaves of a dense attention model, in the
    order of ``tree_leaves(LanguageModel(cfg).init())``."""
    d, hq, hkv, hd, dff = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff
    layer = [(d,), (d, hq, hd), (d, hkv, hd), (d, hkv, hd), (hq, hd, d)]
    if cfg.qkv_bias:
        layer += [(hq, hd), (hkv, hd), (hkv, hd)]
    layer += [(d,), (d, dff), (d, dff), (dff, d)]
    shapes = [(cfg.padded_vocab, d)] + layer * cfg.num_layers + [(d,)]
    norms = (2 * cfg.num_layers + 1) * d  # param_counts leaves the norm scales out
    if sum(math.prod(s) for s in shapes) != cfg.param_counts()["total"] + norms:
        fail(f"leaf shapes do not add up to {cfg.name}'s parameter count")
    return shapes


def flash_checks(records: dict) -> None:
    """The flash kernels through their ops wrappers at the training path's
    shapes: qwen2.5-3b, microbatch 4 of 512 + 1 tokens (B 4, S 513, 16 query
    and 2 KV heads, head_dim 128), bf16, causal."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s, hq, hkv, d = 4, 513, 16, 2, 128

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, d_out = rand(b, s, hq, d), rand(b, s, hkv, d), rand(b, s, hkv, d), rand(b, s, hq, d)
    out, lse = ops.forward(q, k, v)
    expect, _ = ref.attention_fwd_ref(q, k, v)
    # planted fault: query i sees keys up to i - 1 (its last visible key dropped)
    dropped = ref.attention_ref(q, k[:, :-1], v[:, :-1])
    fwd = [check_close("flash_attention_fwd", out, expect, dropped)]
    fwd.append(check_close("flash_attention_fwd (window 100)",
                           ops.forward(q, k, v, sliding_window=100)[0],
                           ref.attention_ref(q, k, v, sliding_window=100)))
    grads = ops.backward(q, k, v, out, lse, d_out)
    expect_grads = ref.attention_bwd_ref(q, k, v, out, lse, d_out)
    fault_grads = ref.attention_bwd_ref(q, k, v, torch.zeros_like(out), lse, d_out)  # Di left out
    again = ops.backward(q, k, v, out, lse, d_out)
    if not all(torch.equal(x, y) for x, y in zip(grads, again)):
        fail("flash_attention_bwd: two runs on the same inputs differ")
    bwd = {"max_abs_err": 0.0, "excess": 0.0, "fault_excess": float("inf")}
    for name, g, e, f in zip(("dq", "dk", "dv"), grads, expect_grads, fault_grads):
        x = excess_bwd(g, e)
        if not torch.isfinite(g).all() or x > 1:
            fail(f"flash_attention_bwd {name}: kernel disagrees with its plain version "
                 f"({x:.2f} x the allowance)")
        bwd["max_abs_err"] = max(bwd["max_abs_err"], (g.float() - e.float()).abs().max().item())
        bwd["excess"] = max(bwd["excess"], x)
        if name != "dv":  # dV does not read Di
            bwd["fault_excess"] = min(bwd["fault_excess"], excess_bwd(f, e))
    if bwd["fault_excess"] <= 1:
        fail("flash_attention_bwd: the tolerance cannot tell a missing Di term from the right answer")

    n_sets = copies_for(nbytes(q, k, v, d_out, out))
    sets = [(q.clone(), k.clone(), v.clone()) for _ in range(n_sets)]
    bwd_sets = [(*x, out.clone(), lse.clone(), d_out.clone()) for x in sets]
    pairs = sum(min(i + 1, s) for i in range(s))  # visible (query, key) pairs, causal
    io = nbytes(q, k, v) + nbytes(out) + 4 * b * hq * s
    records["flash_attention_fwd"] = dict(
        **merge(fwd),
        ms=timed(ops.forward, sets, 50),
        plain_ms=timed(ref.attention_fwd_ref, sets, 5),
        bound=bound(io, 4 * d * pairs * b * hq, BF16_FLOPS),
    )
    records["flash_attention_bwd"] = dict(
        **bwd,
        ms=timed(ops.backward, bwd_sets, 20),
        plain_ms=timed(ref.attention_bwd_ref, bwd_sets, 3),
        # reads q, k, v, out, dO and lse; writes dq, dk, dv; the four
        # products of the gradient (dV, dP, dQ, dK), the recomputation of
        # P being the kernel's choice
        bound=bound(2 * nbytes(q, k, v) + nbytes(out, d_out) + 4 * b * hq * s,
                    8 * d * pairs * b * hq, BF16_FLOPS),
    )
    # the library yardstick: SDPA on the (B, H, S, D) layout, forward and
    # backward, under one named backend (library_ms; flash where it takes
    # GQA, else memory-efficient) and under PyTorch's default dispatch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in x) for x in sets]

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(q_, k_, v_, is_causal=True, enable_gqa=True)

    def sdpa_bwd(o, leaves, grad):
        return torch.autograd.grad(o, leaves, grad, retain_graph=True)

    def yardstick():
        graphs = []
        for x in lib_sets:
            leaves = [t.detach().requires_grad_(True) for t in x]
            graphs.append((sdpa(*leaves), leaves, d_out.transpose(1, 2).contiguous()))
        return ((timed(sdpa, lib_sets, 50), device_ms(sdpa, lib_sets, 20)),
                (timed(sdpa_bwd, graphs, 20), device_ms(sdpa_bwd, graphs, 10)))

    backend = SDPBackend.FLASH_ATTENTION
    try:
        with sdpa_kernel(backend):
            sdpa(*lib_sets[0])
    except RuntimeError:
        backend = SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel(backend):
        named = yardstick()
    default = yardstick()
    for rec, (ms_named, dev_named), (ms_default, dev_default) in zip(
            (records["flash_attention_fwd"], records["flash_attention_bwd"]), named, default):
        rec.update(library_ms=ms_named, library_backend=backend.name, library_ms_default=ms_default,
                   library_device_ms=dev_named, library_device_ms_default=dev_default)
    # the kernels' own device time: the L2-cold loop above also holds the
    # host's time per call where that exceeds the kernels'
    records["flash_attention_fwd"]["device_ms"] = device_ms(ops.forward, sets, 20)
    records["flash_attention_bwd"]["device_ms"] = device_ms(ops.backward, bwd_sets, 10)
    f32_route_checks(records)


# The f32 route (CUDA cores; phase 8's card-against-CPU check runs it): f32
# math on both sides, so the forward agrees within 2e-5 and the backward
# within 1e-5 relative plus 1e-5 of each gradient's largest value.
F32_FWD_TOL = 2e-5
F32_BWD_TOL = 1e-5


def f32_route_checks(records: dict) -> None:
    """The flash kernels on f32 inputs against their plain version, at a
    small shape with a ragged S, GQA 2:1 and a sliding window."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    b, s, hq, hkv = 2, 77, 4, 2
    readings = {}
    for d in (64, 128):
        q, k, v, d_out = (torch.randn(shape, generator=gen, device="cuda")
                          for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
        kw = dict(causal=True, sliding_window=40)
        out, lse = ops.forward(q, k, v, **kw)
        expect, _ = ref.attention_fwd_ref(q, k, v, **kw)
        fwd = check_close(f"flash_attention_fwd (f32, D {d})", out, expect,
                          allowance=lambda o, e: ((o - e).abs() / (F32_FWD_TOL * (1 + e.abs()))).max().item())
        grads = ops.backward(q, k, v, out, lse, d_out, **kw)
        bwd = max(check_close(f"flash_attention_bwd {name} (f32, D {d})", g, e,
                              allowance=lambda o, e_: excess_bwd(o, e_, F32_BWD_TOL, F32_BWD_TOL))["excess"]
                  for name, g, e in zip(("dq", "dk", "dv"), grads,
                                        ref.attention_bwd_ref(q, k, v, out, lse, d_out, **kw)))
        readings[f"d{d}"] = {"fwd_excess": fwd["excess"], "bwd_excess": bwd}
    records["flash_attention_fwd"]["f32_route"] = readings


def fused_checks(records: dict, trees: dict) -> None:
    """Each fused update through its ops wrapper over every leaf of the tree
    its training run updates (``trees``: kernel -> leaf shapes), held bit
    for bit against its plain version leaf by leaf, then timed (the trees
    are far larger than L2)."""
    import torch

    from repro_torch.kernels.fused_optim import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    lr, gamma, beta, delta, nu = 0.3, 1e4, 0.9, 1.0, 1.0

    def leaves(shapes, positive=False):
        out = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
        return [x.abs_() for x in out] if positive else out

    for kname, shapes in trees.items():
        n = sum(math.prod(s) for s in shapes)
        w, g = leaves(shapes), leaves(shapes)
        if kname == "fused_psgd":
            state = [leaves(shapes)]
            wrapper = lambda w_, g_, a_: ops.psgd_update(w_, g_, a_, lr=lr, gamma=gamma)
            plain = lambda w_, g_, a_: [ref.psgd_ref(*x, lr=lr, gamma=gamma) for x in zip(w_, g_, a_)]
            outputs = lambda w_, st: [w_]
            moved = 16 * n  # w, g, anchor read; w written
        elif kname == "fused_momentum":
            state = [leaves(shapes)]
            wrapper = lambda w_, g_, u_: ops.momentum_update(w_, g_, u_, lr=lr, beta=beta)
            plain = lambda w_, g_, u_: list(zip(*[ref.momentum_ref(*x, lr=lr, beta=beta)
                                                  for x in zip(w_, g_, u_)]))
            outputs = lambda w_, st: [w_, st[0]]
            moved = 20 * n  # w, g, u read; w, u written
        else:
            state = [leaves(shapes), leaves(shapes), leaves(shapes, positive=True)]
            wrapper = lambda w_, g_, a_, z_, s_: ops.adagrad_da_update(
                w_, g_, a_, z_, s_, lr=lr, delta=delta, nu=nu)
            plain = lambda w_, g_, a_, z_, s_: list(zip(*[
                ref.adagrad_da_ref(*x, lr=lr, delta=delta, nu=nu) for x in zip(w_, g_, a_, z_, s_)]))
            outputs = lambda w_, st: [w_, st[1], st[2]]
            moved = 28 * n  # g, anchor, z, s2 read; w, z, s2 written (w is not read)
        expect = plain(w, g, *state)
        expect = [expect] if kname == "fused_psgd" else expect
        wrapper(w, g, *state)
        torch.cuda.synchronize()
        mismatched, max_err = 0, 0.0
        for got_leaves, exp_leaves in zip(outputs(w, state), expect):
            for x, e in zip(got_leaves, exp_leaves):
                mismatched += int((x != e).sum())
                max_err = max(max_err, (x - e).abs().max().item())
        if mismatched:
            fail(f"{kname}: {mismatched} elements differ from the plain version (max {max_err:.3e})")
        del expect
        records[kname] = dict(
            max_abs_err=max_err, elements=n, leaves=len(shapes),
            ms=timed(wrapper, [(w, g, *state)], 10),
            plain_ms=timed(plain, [(w, g, *state)], 2),
            bound=bound(moved, 6 * n, F32_FLOPS),
            library_ms=None,
        )
        del w, g, state
        torch.cuda.empty_cache()


def expected_ladder(schedule) -> tuple:
    """(stages, batch sizes) of every update, from the schedule's own
    updates_per_stage and its stage batch sizes."""
    stages, batches = [], []
    for s, m in enumerate(schedule.updates_per_stage()):
        stages += [s] * m
        batches += [int(round(schedule.b1 * schedule.rho**s))] * m
    return stages, batches


def run_sebs(cfg, optimizer, *, eta: float, device: str, seq: int, b1: int, c1: int, stages: int,
             params=None):
    """One SEBS run (rho 2, microbatch b1) from seed-0 weights (or
    ``params``), every launch counter zeroed just before and read just
    after. Returns (log, wall s, launches, per-update seconds, state)."""
    import torch

    from repro_torch.core import SEBS, SEBSTrainer
    from repro_torch.data import DataPipeline, TokenDataset
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_optim import ops as optim_ops
    from repro_torch.kernels.gla import ops as gla_ops
    from repro_torch.models import LanguageModel
    from repro_torch.obs import Tracer
    from repro_torch.train import TrainState, init_train_state

    model = LanguageModel(cfg)
    schedule = SEBS(b1=b1, C1=c1, rho=2.0, num_stages=stages, eta=eta)
    tracer = Tracer()
    trainer = SEBSTrainer(model, optimizer, schedule,
                          DataPipeline(TokenDataset(cfg.vocab_size, seq, seed=0), device=device),
                          microbatch=b1, mode="accumulate", accum_mode="psum_each", tracer=tracer)
    if params is None:
        state = init_train_state(model, optimizer, seed=0, device=device)
    else:
        state = TrainState(params, optimizer.init(params), 0)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for ops in (flash_ops, optim_ops, gla_ops):
        ops.reset_launches()
    t0 = time.perf_counter()
    state, log = trainer.run(state, log_every=1)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**flash_ops.LAUNCHES, **optim_ops.LAUNCHES, **gla_ops.LAUNCHES}
    updates = [ev["dur"] for ev in tracer.events if ev.get("name") == "train.update"]
    if log.stages != expected_ladder(schedule)[0] or log.batch_sizes != expected_ladder(schedule)[1]:
        fail(f"{cfg.name}: stages {log.stages} / batches {log.batch_sizes} differ from the "
             f"schedule's ladder {expected_ladder(schedule)}")
    return log, wall, launches, updates, state, trainer


def check_training(label: str, log, launches: dict, kernels) -> None:
    if not all(math.isfinite(x) for x in log.losses):
        fail(f"{label}: a loss is not finite: {log.losses}")
    if not log.losses[-1] < log.losses[0]:
        fail(f"{label}: the last loss {log.losses[-1]:.4f} is not below the first {log.losses[0]:.4f}")
    for kname in kernels:
        if launches[kname] <= 0:
            fail(f"{label}: {kname} was not launched on the main path")


# Learning rates of the card-against-CPU runs (smoke, float32, 4 updates).
# rwkv6's smoke run amplifies rounding: its group norm starts at y = 0 on
# the first position (u = 0), so at qwen's 0.3 a CPU run whose weights move
# by 1e-7 ends far from the unmoved one. The control run below measures that
# at the rate used, and must stay within half the tolerance for the
# comparison to mean anything; where the rate is below 0.3, the three runs
# are also made at 0.3 and recorded, as the reason for the lower rate.
CARD_CPU_ETAS = {"qwen2.5-3b": 0.3, "rwkv6-1.6b": 0.01}
CARD_CPU_REFERENCE_ETA = 0.3
CARD_CPU_RTOL = 1e-4


def card_cpu_agreement(arch: str) -> dict:
    """``arch`` smoke in float32 from the same weights on the CPU (plain
    versions) and on the card (kernels): the first update's gradients leaf
    by leaf (within 1e-4 of each leaf's norm), and the losses of a short
    SEBS run (within 1e-4 relative). A control run on the CPU from weights
    moved by 1e-7 relative shows how far rounding alone carries the losses."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.train.step import _grads_over_microbatches
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config(arch, "smoke").replace(compute_dtype="float32")
    model = LanguageModel(cfg)
    # the same seed-0 weights on both: made on the CPU, then moved
    base = model.init(seed=0, device="cpu")
    tokens = torch.from_numpy(np.asarray(TokenDataset(cfg.vocab_size, 32, seed=1).batch(0, 4)["tokens"]))
    def copy_to(tree, device):  # the runs update their weights in place
        return tree_map(lambda x: x.detach().to(device, copy=True), tree)

    grads = {}
    for device in ("cpu", "cuda"):
        params = copy_to(base, device)
        for w in tree_leaves(params):
            w.requires_grad_(True)
        g, _ = _grads_over_microbatches(model, params, {"tokens": tokens.to(device)}, 1, 0.0)
        grads[device] = [x.detach().cpu() for x in g]
    grad_worst = max((torch.linalg.vector_norm(c - a) / torch.linalg.vector_norm(a)).item()
                     for a, c in zip(grads["cpu"], grads["cuda"]))
    if grad_worst > CARD_CPU_RTOL:
        fail(f"{arch}: card and CPU gradients differ by {grad_worst:.2e} of a leaf's norm")
    gen = torch.Generator().manual_seed(1)
    moved = tree_map(lambda x: x * (1 + 1e-7 * torch.randn(x.shape, generator=gen)), base)

    def gaps(eta):
        """Losses of the CPU, card and control runs at ``eta``, and the card's
        and the control's largest relative distance from the CPU run."""
        losses = {}
        for label, device, weights in (("cpu", "cpu", base), ("cuda", "cuda", base),
                                       ("control", "cpu", moved)):
            log = run_sebs(cfg, make_optimizer("psgd", gamma=1e4), eta=eta, device=device,
                           seq=32, b1=4, c1=8, stages=2, params=copy_to(weights, device))[0]
            losses[label] = log.losses
        return losses, *(max(abs(a - b) / abs(a) for a, b in zip(losses["cpu"], losses[other]))
                         for other in ("cuda", "control"))

    eta = CARD_CPU_ETAS[arch]
    losses, worst, control = gaps(eta)
    if control > CARD_CPU_RTOL / 2:
        fail(f"{arch}: the control run moves {control:.2e} from weights moved by 1e-7: the "
             f"comparison cannot hold {CARD_CPU_RTOL:.0e} at eta {eta}")
    if worst > CARD_CPU_RTOL:
        fail(f"{arch}: card and CPU losses differ by {worst:.2e} relative: {losses}")
    print(f"card vs cpu: {arch} smoke f32, first-update gradients within {grad_worst:.2e} of a "
          f"leaf's norm; {len(losses['cpu'])} updates at eta {eta}, losses within "
          f"{worst:.2e} relative (control run from weights moved by 1e-7: {control:.2e})", flush=True)
    out = {"cpu": losses["cpu"], "cuda": losses["cuda"], "max_rel": worst, "control_max_rel": control,
           "grad_max_rel": grad_worst, "eta": eta}
    if eta < CARD_CPU_REFERENCE_ETA:
        _, worst_ref, control_ref = gaps(CARD_CPU_REFERENCE_ETA)
        print(f"card vs cpu: {arch} at eta {CARD_CPU_REFERENCE_ETA} (not held, the reason for eta "
              f"{eta}): card {worst_ref:.2e}, control {control_ref:.2e} relative", flush=True)
        out["at_reference_eta"] = {"eta": CARD_CPU_REFERENCE_ETA, "max_rel": worst_ref,
                                   "control_max_rel": control_ref}
    return out


def stage_table(log, updates, seq: int) -> dict:
    """Per stage: batch, updates, median update time, tokens per second."""
    per_stage: dict = {}
    for st, bs, dur in zip(log.stages, log.batch_sizes, updates):
        per_stage.setdefault(st, []).append((bs, dur))
    return {
        st: {"batch": rows[0][0], "updates": len(rows),
             "median_update_ms": sorted(d for _, d in rows)[len(rows) // 2] * 1e3,
             "tokens_per_s": sum(bs * (seq + 1) for bs, _ in rows) / sum(d for _, d in rows)}
        for st, rows in per_stage.items()
    }


def print_training(label: str, log, wall: float, peak: int, launches: dict, stages: dict, seq: int) -> None:
    print(f"train {label}: {len(log.steps)} updates in {wall:.1f} s | losses "
          + " ".join(f"{x:.4f}" for x in log.losses) + f" | peak memory {peak / 2**30:.1f} GiB "
          f"| launches {launches}", flush=True)
    for st, row in stages.items():
        print(f"train {label} stage {st}: batch {row['batch']} x {seq + 1} tokens, {row['updates']} "
              f"updates, median {row['median_update_ms']:.1f} ms an update, "
              f"{row['tokens_per_s']:.0f} tokens/s (first update included)", flush=True)


def trace_update(label: str, trainer, state, optimizer, lr: float):
    """One stage-2 update (4 microbatches of 4) traced on the device, after
    an untraced one timed for comparison. Returns (profile, untraced ms)."""
    import torch

    from repro_torch.train import build_train_step

    step = build_train_step(trainer.model, optimizer, accum_steps=4)
    batch = trainer.pipeline.next_batch(16)
    batch = {k: v.reshape((4, 4) + tuple(v.shape[1:])) for k, v in batch.items()}
    step(state, batch, lr, 2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch, lr, 2)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    prof = device_profile(lambda: step(state, batch, lr, 2))
    print(f"{label} profile: one update of 4 microbatches, device busy {prof['busy_ms']:.1f} ms "
          f"of {prof['wall_ms']:.1f} ms wall, idle {100 * prof['idle_share']:.1f}% | "
          f"{prof['activities']} device activities | untraced update {untraced_ms:.1f} ms", flush=True)
    for kname, (ms, n) in list(prof["by_kernel"].items())[:10]:
        print(f"{label} profile: {ms:9.2f} ms {n:6d} x  {kname[:100]}")
    return prof, untraced_ms


def serve_rwkv6(cfg) -> dict:
    """Phase 10: the paged engine serving rwkv6-1.6b at full width (8 slots,
    cache 2048, 256-token prefill chunks; 8 requests of 512 prompt tokens,
    the first 256 shared, and 32 new tokens, half greedy, half t=0.8,
    top_k=50), counters zeroed just before and read just after. Prefix
    sharing is off for a recurrent model, so nothing is reused; every chunk
    launches the GLA forward once a layer. Then the same batch again, traced
    on the device, and greedy tokens on the card against the CPU path's on
    rwkv6 smoke."""
    import torch

    from repro_torch.kernels.gla import ops as gla_ops
    from repro_torch.kernels.paged_decode import ops as paged_ops
    from repro_torch.models import LanguageModel
    from repro_torch.serve import PagedContinuousBatchingEngine

    model = LanguageModel(cfg)
    params = model.init(seed=0, device="cuda")
    engine = PagedContinuousBatchingEngine(
        model, params, max_slots=8, page_size=16, cache_len=2048, prefill_chunks=(256,), seed=0,
    )
    rng = torch.Generator().manual_seed(7)
    prefix = torch.randint(0, cfg.vocab_size, (256,), generator=rng)

    def submit_batch():
        return [
            engine.submit(torch.cat([prefix, torch.randint(0, cfg.vocab_size, (256,), generator=rng)]).numpy(),
                          max_new_tokens=32, temperature=0.0 if i % 2 == 0 else 0.8,
                          top_k=0 if i % 2 == 0 else 50)
            for i in range(8)
        ]

    engine.submit(prefix.numpy(), max_new_tokens=4)  # warm-up
    engine.run()
    engine.reset_stats()
    ids = submit_batch()
    torch.cuda.synchronize()
    paged_ops.reset_launches()
    gla_ops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**paged_ops.LAUNCHES, **gla_ops.LAUNCHES}
    for rid in ids:
        gen_tokens = results[rid][512:]
        if len(gen_tokens) != 32 or gen_tokens.min() < 0 or gen_tokens.max() >= cfg.vocab_size:
            fail(f"rwkv6 request {rid}: bad generated tokens {gen_tokens.tolist()}")
    engine.pool.check()
    stats, mem = copy.deepcopy(engine.stats), engine.memory_stats()
    if engine.prefix_sharing or stats["prefix_tokens_reused"] != 0:
        fail("rwkv6: prefix sharing must be off for a recurrent model")
    if launches["gla_fwd"] != cfg.num_layers * stats["prefill_chunks"]:
        fail(f"rwkv6: gla_fwd launched {launches['gla_fwd']} times, not {cfg.num_layers} x "
             f"{stats['prefill_chunks']} prefill chunks")
    if launches["fused_sample"] <= 0:
        fail("rwkv6: fused_sample was not launched on the serving path")
    submit_batch()
    profile = device_profile(engine.run)
    engine.pool.check()
    decode_tick_ms = sorted(stats["decode_tick_s"])[len(stats["decode_tick_s"]) // 2] * 1e3
    print(
        f"rwkv6 engine: {len(ids)} requests x 32 tokens in {wall:.3f} s | decode {stats['decoded_tokens']} "
        f"tokens = {stats['decoded_tokens'] / wall:.1f} tok/s | median decode tick {decode_tick_ms:.2f} ms "
        f"| {stats['ticks']} ticks, {stats['prefill_chunks']} chunks | prefix reused "
        f"{stats['prefix_tokens_reused']} | kv bytes peak {mem['kv_bytes_peak']} "
        f"| peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | launches {launches}",
        flush=True,
    )
    print(f"rwkv6 profile: device busy {profile['busy_ms']:.1f} ms of {profile['wall_ms']:.1f} ms wall, "
          f"idle {100 * profile['idle_share']:.1f}% | {profile['activities']} device activities", flush=True)
    for kname, (ms, n) in list(profile["by_kernel"].items())[:8]:
        print(f"rwkv6 profile: {ms:9.2f} ms {n:6d} x  {kname[:100]}")
    del engine, params, results
    gc.collect()
    torch.cuda.empty_cache()
    small_input_agreement("rwkv6-1.6b")
    return {"wall_s": wall, "decoded_tokens": stats["decoded_tokens"], "ticks": stats["ticks"],
            "prefill_chunks": stats["prefill_chunks"], "median_decode_tick_ms": decode_tick_ms,
            "launches": launches, "profile": profile}


def train_rwkv6(cfg) -> dict:
    """Phase 11: SEBSTrainer with pSGD on rwkv6-1.6b at full width, on phase
    7's schedule (12 updates at batch 4, 8, 16 by 1, 2 and 4 microbatches of
    4 x 513 tokens), counters zeroed just before and read just after: the
    GLA forward runs twice a layer and microbatch (remat), the backward
    once. Then one stage-2 update traced on the device, and the card's
    losses against the CPU path's on rwkv6 smoke."""
    import torch

    from repro_torch.optim import make_optimizer

    seq, b1 = 512, 4
    psgd = make_optimizer("psgd", gamma=1e4)
    eta = ETAS["rwkv6_psgd"]
    log, wall, launches, updates, state, trainer = run_sebs(
        cfg, psgd, eta=eta, device="cuda", seq=seq, b1=b1, c1=16, stages=3)
    peak = torch.cuda.max_memory_allocated()
    check_training("rwkv6 psgd, full width", log, launches, ("gla_fwd", "gla_bwd", "fused_psgd"))
    micro = sum(bs // b1 for bs in log.batch_sizes)
    expect = {"gla_fwd": cfg.num_layers * 2 * micro, "gla_bwd": cfg.num_layers * micro}
    for kname, n in expect.items():
        if launches[kname] != n:
            fail(f"rwkv6 training: {kname} launched {launches[kname]} times, not {n}")
    stages = stage_table(log, updates, seq)
    print_training("rwkv6 psgd", log, wall, peak, launches, stages, seq)
    profile, untraced_ms = trace_update("rwkv6 train", trainer, state, psgd, eta)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    agreement = card_cpu_agreement("rwkv6-1.6b")
    return {"layers": cfg.num_layers, "eta": eta, "losses": log.losses, "wall_s": wall,
            "peak_gib": peak / 2**30, "launches": launches, "stages": stages, "profile": profile,
            "untraced_update_ms": untraced_ms, "card_vs_cpu": agreement}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs one CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SegmentSpec
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.paged_decode import ops
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
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
    seconds = _cuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + " ".join(f"{n}={s:.1f}s" for n, s in seconds.items()), flush=True)
    for lib, log in _cuda.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"ptxas[{lib}]: {line.strip()}")
    hgmma = hgmma_counts()
    print("sass HGMMA per flash kernel: " + ", ".join(f"{n} {c}" for n, c in hgmma.items()), flush=True)
    for kname, count in hgmma.items():
        if "_tc_kernel" in kname and count == 0:
            fail(f"{kname} has no HGMMA in its SASS: the bf16 route is not on the tensor cores")

    # 3. kernels against their plain versions
    cfg = get_config("qwen2.5-3b", "full")
    reduced = cfg.replace(segments=(SegmentSpec(body=cfg.segments[0].body, repeat=8),))
    records: dict = {}
    kernel_checks(records)
    flash_checks(records)
    fused_checks(records, {"fused_psgd": leaf_shapes(cfg), "fused_momentum": leaf_shapes(reduced),
                           "fused_adagrad_da": leaf_shapes(reduced)})
    gla_serving_shape = gla_checks(records)
    fwd_rec, bwd_rec = records["flash_attention_fwd"], records["flash_attention_bwd"]
    print(f"flash yardstick, ms a call (device ms in brackets): SDPA ({fwd_rec['library_backend']}) fwd "
          f"{fwd_rec['library_ms']:.4f} ({fwd_rec['library_device_ms']:.4f}), bwd {bwd_rec['library_ms']:.4f} "
          f"({bwd_rec['library_device_ms']:.4f}); default dispatch fwd {fwd_rec['library_ms_default']:.4f} "
          f"({fwd_rec['library_device_ms_default']:.4f}), bwd {bwd_rec['library_ms_default']:.4f} "
          f"({bwd_rec['library_device_ms_default']:.4f}) | kernels fwd {fwd_rec['ms']:.4f} "
          f"({fwd_rec['device_ms']:.4f}), bwd {bwd_rec['ms']:.4f} ({bwd_rec['device_ms']:.4f})"
          f" | f32 route, in units of its allowance: " + ", ".join(
              f"D {d[1:]} fwd {r['fwd_excess']:.3f} bwd {r['bwd_excess']:.3f}"
              for d, r in fwd_rec["f32_route"].items()), flush=True)
    print("kernel checks: ok | tolerance readings, in units of the allowance (sound <= 1 < planted "
          "fault): " + ", ".join(f"{n} {r['excess']:.3f} vs {r['fault_excess']:.1f}"
                                 for n, r in records.items() if "excess" in r)
          + " | fused updates bit-equal over " + ", ".join(
              f"{n} {r['elements']} elements in {r['leaves']} leaves"
              for n, r in records.items() if "elements" in r), flush=True)

    # 4. the serving path at full width
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

    small_input_agreement("qwen2.5-3b")
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
    del engine, params, probe, results
    gc.collect()
    torch.cuda.empty_cache()

    # 7. the training path: SEBS with pSGD at full width
    seq, b1 = 512, 4
    psgd = make_optimizer("psgd", gamma=1e4)
    log, train_wall, train_launches, updates, state, trainer = run_sebs(
        cfg, psgd, eta=ETAS["psgd"], device="cuda", seq=seq, b1=b1, c1=16, stages=3)
    train_peak = torch.cuda.max_memory_allocated()
    check_training("psgd, full width", log, train_launches,
                   ("flash_attention_fwd", "flash_attention_bwd", "fused_psgd"))
    train_stages = stage_table(log, updates, seq)
    print_training(f"psgd {cfg.name}", log, train_wall, train_peak, train_launches, train_stages, seq)

    # 9. where the time goes: one stage-2 update (4 microbatches), traced on the device
    train_profile, untraced_ms = trace_update("train", trainer, state, psgd, ETAS["psgd"])
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()

    # 7b. momentum and AdaGrad-DA, full width at 8 layers
    runs = {"psgd": {"layers": cfg.num_layers, "eta": ETAS["psgd"], "losses": log.losses,
                     "wall_s": train_wall, "peak_gib": train_peak / 2**30,
                     "launches": dict(train_launches), "stages": train_stages}}
    for opt_name, hp, kname in (("momentum", {"beta": 0.9}, "fused_momentum"),
                                 ("adagrad_da", {}, "fused_adagrad_da")):
        eta = ETAS[opt_name]
        rlog, rwall, rlaunches, _, rstate, _ = run_sebs(
            reduced, make_optimizer(opt_name, **hp), eta=eta, device="cuda", seq=seq, b1=b1, c1=16,
            stages=3)
        peak = torch.cuda.max_memory_allocated()
        check_training(f"{opt_name}, 8 layers", rlog, rlaunches,
                       ("flash_attention_fwd", "flash_attention_bwd", kname))
        train_launches[kname] = rlaunches[kname]
        runs[opt_name] = {"layers": reduced.num_layers, "eta": eta, "losses": rlog.losses,
                          "wall_s": rwall, "peak_gib": peak / 2**30, "launches": rlaunches}
        print(f"train {opt_name}: {reduced.num_layers} layers, {len(rlog.steps)} updates in {rwall:.1f} s "
              f"| losses " + " ".join(f"{x:.4f}" for x in rlog.losses)
              + f" | peak memory {peak / 2**30:.1f} GiB | launches {rlaunches}", flush=True)
        del rstate
        gc.collect()
        torch.cuda.empty_cache()

    # 8. card against CPU on a small input
    agreement = card_cpu_agreement("qwen2.5-3b")

    # 10-11. rwkv6-1.6b at full width: served, then trained, through the GLA kernels
    rwkv = get_config("rwkv6-1.6b", "full")
    rwkv_serving = serve_rwkv6(rwkv)
    rwkv_training = train_rwkv6(rwkv)

    replaces = {
        "paged_flash_decode": "src/repro/kernels/paged_decode/kernel.py:84",
        "paged_chunk_prefill": "src/repro/kernels/paged_decode/kernel.py:171",
        "fused_sample": "src/repro/kernels/paged_decode/kernel.py:238",
        "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:76",
        "flash_attention_bwd": "no TPU counterpart (JAX forward only)",
        "fused_psgd": "src/repro/kernels/fused_optim/kernel.py:82",
        "fused_momentum": "src/repro/kernels/fused_optim/kernel.py:88",
        "fused_adagrad_da": "src/repro/kernels/fused_optim/kernel.py:96",
        "gla_fwd": "src/repro/kernels/gla/kernel.py:81",
        "gla_bwd": "no TPU counterpart (the JAX package differentiates gla_scan)",
    }
    sources = {
        "paged_flash_decode": "paged_decode/csrc/paged_attention.cu",
        "paged_chunk_prefill": "paged_decode/csrc/paged_attention.cu",
        "fused_sample": "paged_decode/csrc/fused_sample.cu",
        "flash_attention_fwd": "flash_attention/csrc/flash_attention.cu",
        "flash_attention_bwd": "flash_attention/csrc/flash_attention.cu",
        "fused_psgd": "fused_optim/csrc/fused_optim.cu",
        "fused_momentum": "fused_optim/csrc/fused_optim.cu",
        "fused_adagrad_da": "fused_optim/csrc/fused_optim.cu",
        "gla_fwd": "gla/csrc/gla.cu",
        "gla_bwd": "gla/csrc/gla.cu",
    }
    all_launches = {**launches, **train_launches}
    # the GLA kernels run on both rwkv6 paths: serving (the forward) and training
    for kname in ("gla_fwd", "gla_bwd"):
        all_launches[kname] = rwkv_serving["launches"].get(kname, 0) + rwkv_training["launches"][kname]
    kernels = []
    for kname, rec in records.items():
        bound_ms, bound_by = rec["bound"]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/{sources[kname]}",
            "replaces": replaces[kname],
            "launches": all_launches[kname], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": rec.get("library_ms"),
        })
    record = {"kernels": kernels}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        **record, "nvidia_smi": smi, "tolerance": {
            n: {key: r[key] for key in ("excess", "fault_excess")} for n, r in records.items() if "excess" in r
        }, "library_none": {n: LIBRARY_NONE if n.startswith("fused_") else LIBRARY_NONE_GLA
                            for n, r in records.items()
                            if n.startswith(("fused_", "gla_")) and r.get("library_ms") is None},
        "flash": {"hgmma": hgmma, **{n: {key: records[n][key] for key in (
            "device_ms", "library_backend", "library_ms_default", "library_device_ms",
            "library_device_ms_default", "f32_route") if key in records[n]}
            for n in ("flash_attention_fwd", "flash_attention_bwd")}},
        "gla_fwd_serving_shape": {"ms": gla_serving_shape["ms"], "plain_ms": gla_serving_shape["plain_ms"],
                                  "bound_ms": gla_serving_shape["bound"][0],
                                  "bound_by": gla_serving_shape["bound"][1]},
        "rwkv6": {"serving": rwkv_serving, "training": rwkv_training},
        "profile": profile, "engine": {
            "wall_s": wall, "decoded_tokens": stats["decoded_tokens"], "ticks": stats["ticks"],
            "prefill_chunks": stats["prefill_chunks"], "median_decode_tick_ms": decode_tick_ms,
            "pages_peak": mem["pages_peak"], "prefix_tokens_reused": stats["prefix_tokens_reused"],
        }, "train": {"runs": runs, "profile": train_profile, "untraced_update_ms": untraced_ms,
                     "card_vs_cpu": agreement},
    }, indent=1))
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
