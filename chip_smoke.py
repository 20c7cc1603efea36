#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Checks that CUDA is present (else exits 1) and prints the card's name
   and power limit; turns TF32 off for matmul and cuDNN.
2. Builds every kernel family (``src/repro_torch/kernels/*/csrc``) with
   nvcc, one process per source, in parallel; prints ptxas' registers,
   spills and wgmma warnings, and the HGMMA (wgmma) count in the SASS of
   each flash kernel, which must be above 0 for the bf16 (tensor-core)
   ones, and the HMMA/HGMMA count of each GLA kernel, which must be above 0
   for the bf16 ones that hold products (GLA_TC_KERNELS), and of each
   paged-attention kernel, which must be above 0 for the bf16 ones
   (namespace tc, PAGED_TC_KERNELS); the D 80 instantiations (zamba2's
   shared attention) of the flash and paged kernels must be there.
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
   dlog_w) must not be; the backward gives the same bits twice; a
   strong-decay input at the training shape (log_w -30 a step on every
   fifth channel) stays finite and within GLA_TOL. The GLA kernels' device
   time comes from torch.profiler, as the flash kernels' does, and so does
   the paged kernels': decode at the ragged lengths and at the serving
   shape (8 slots of 544 tokens sharing a 256-token prefix), which must
   also agree and give the same bits twice, chunk prefill and the sampler,
   whose tokens must equal the plain version's at 8 rows and at one row
   of qwen2.5-3b's vocabulary and at 8 rows of rwkv6-1.6b's. At zamba2's
   shapes: the flash forward and backward at D 80 (B 4, S 513, 32/32
   heads), the paged decode at D 80 and G 1 (8 slots of 544, the same bits
   twice) and the chunk prefill at D 80, with the faults above; the GLA
   forward and backward with the current token included at Mamba2's
   training shape (B 4, S 513, 80 heads) and zamba2's decays, the planted
   fault being the current token's term left out, and at a decay 8 times
   steeper, finite and within GLA_TOL.
4. Drives the serving path: the paged continuous-batching engine serving
   qwen2.5-3b at full width with random weights from a seeded generator,
   with every launch counter zeroed just before and read just after.
5. Checks the serving output: every request completes with in-vocabulary
   tokens, the page pool is consistent, prefix pages were reused, every
   kernel was launched, the full model's logits are finite, and on a small
   input the card's greedy tokens equal those of the CPU path.
6. Serves the same batch again under torch.profiler, tracing the device
   only, and prints the device's busy time, idle share, top kernels and
   the paged decode and prefill kernels' and the sampler's share.
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
    sampler every tick, no prefix is shared; traces the same batch again
    (the GLA kernels' and the sampler's share);
    greedy tokens on the card equal the CPU path's on rwkv6 smoke.
11. Trains rwkv6-1.6b at full width with SEBS and pSGD on phase 7's
    schedule: the GLA forward runs twice a layer and microbatch (remat), the
    backward once; traces a stage-2 update; on rwkv6 smoke the card agrees
    with the CPU path as in phase 8 (its SEBS run at eta 0.01, where the
    control run holds: see CARD_CPU_ETAS).
12. Serves qwen2.5-3b at full width (phase 4's weights) through the dense
    engines, right after phase 6: the continuous engine (8 slots, cache
    1,024) on phase 4's requests, counters zeroed just before and read
    just after (the flash forward once a layer and prefill, the sampler
    once a tick and a first token, no paged kernel), traced again on the
    device (the flash forward's and the sampler's share); the static
    engine on the same 8 prompts, greedy (one batched prefill); agreement
    of the two on the greedy requests is reported, not required. On
    qwen2.5-3b and rwkv6-1.6b smoke in float32 both engines' greedy tokens
    on the card equal the CPU path's.
13. Kills and resumes training at full width cut to 4 layers (after phase
    14): phase 7's schedule with pSGD, uninterrupted; then saving every 6
    updates and stopped after 8; then a fresh trainer resuming from the
    checkpoint (a temporary directory, removed after). Losses, stages and
    final params must be bit-identical to the uninterrupted run; prints
    the seconds of each save's copy to the host, each write and the
    restore.
14. Trains with AdamW, LARS and LAMB (plain PyTorch updates), each 4 SEBS
    updates at full width on 8 layers (after phase 7b): finite losses; on
    qwen2.5-3b smoke in float32 the card's losses within 1e-4 relative of
    the CPU path's.

15. Serves zamba2-2.7b at full width through the paged engine on phase 4's
    traffic (no prefix reused: sharing is off for a hybrid model), counters
    zeroed just before and read just after (GLA forward 54 a chunk, chunk
    prefill 9 a chunk, decode 9 a tick: the shared attention at D 80),
    traced on the device; the static engine on the same prompts (one
    batched prefill: the flash forward at D 80 9 times, GLA 54); on zamba2
    smoke with ssm_state 64 in float32 the greedy tokens of the paged and
    both dense engines on the card equal the CPU path's.
16. Trains zamba2-2.7b at full width with SEBS and pSGD (eta 0.3) on phase
    7's schedule: GLA forward 2 x 54 and backward 54 a microbatch, flash
    forward 2 x 9 and backward 9; traces a stage-2 update; on zamba2 smoke
    (ssm_state 64) the card agrees with the CPU path as in phase 8.
17. Trains gemma2-9b at full width cut to 8 of its 42 layers with SEBS and
    pSGD: the soft-capped attention takes the plain _sdpa route (as in the
    JAX package; no flash launch); on gemma2 smoke the card agrees with the
    CPU path as in phase 8, and the paged and dense engines' greedy tokens
    on the card equal the CPU's.

18. Serves dbrx-132b at full width cut to 4 of its 40 layers (13.65 B f32
    parameters, 54.6 GB) through the paged engine on phase 4's traffic
    (decode 4 a tick, chunk prefill 4 a chunk at G 6, the sampler every
    tick at V 100,352; the shared prefix reused), traced on the device with
    the MoE layers' share (moe_breakdown: router, dispatch, the dispatch and
    combine products, the expert products, the weight casts); then the
    continuous and static engines on the same prompts; on dbrx smoke in
    float32 the greedy tokens of the three engines on the card equal the
    CPU path's.
19. Trains dbrx-132b at full width cut to 1 of its 40 layers with SEBS and
    pSGD on phase 7's schedule (flash forward 2 and backward 1 a
    microbatch, pSGD 1 an update): finite, falling losses, the stage ladder
    exact, the traced stage-2 update's router loss finite, positive and at
    most E x k; on dbrx and arctic smoke the card agrees with the CPU path
    as in phase 8, each path's expert choices reported and every routing
    flip printed with its probability gap.
20. Serves arctic-480b at full width cut to 1 of its 35 layers (55.4 GB;
    each 17.8 GB expert tensor cast to bf16 only for its product) through
    the paged engine on phase 4's traffic (G 7, V 32,000) and then the
    static engine, peak memory below the card's; on arctic smoke the greedy
    tokens of the three engines on the card equal the CPU path's; on
    internvl2 smoke with vision_embeds the card's loss and gradients equal
    the CPU path's.

21. The kernels at whisper-tiny's shapes: the flash forward and backward
    non-causal at the encoder's (B 4, S 1500 = 23 x 64 + 28, 6/6 heads, D
    64) on the bf16 and the f32 routes, the planted faults (a key dropped,
    a causal mask where none belongs, Di left out) outside; causal at the
    decoder's (B 4, S 448); the paged decode and chunk prefill at D 64, G
    1; the sampler at whisper's 51,865 logits; the fused updates bit for
    bit over Fig. 3's ResNet leaves. SDPA's times beside the flash ones.
22. Serves whisper-tiny at full width (4 + 4 layers) through the paged
    engine (8 slots, cache 448, pages of 16, 64-token chunks): 8 requests,
    each with its own (1, 1500, 384) audio, half with the 4-token start
    sequence as the prompt and half with 128 previous-text tokens before
    it, 96 new tokens, half greedy; launches exact (an encoding, 4 flash
    forwards, an admission; decode 4 a tick; chunk prefill 4 a chunk;
    sampler 1 a tick), traced on the device; then the continuous and the
    static engines.
23. Trains whisper-tiny at full width with SEBS and pSGD on phase 7's
    schedule (rows of 449 tokens with their audio): flash forward 2 x 8
    and backward 8 a microbatch (encoder non-causal, decoder causal);
    finite, falling losses; a stage-2 update traced.
24. On whisper smoke in float32 the card agrees with the CPU path as in
    phase 8 (batches with audio), and the greedy tokens of the three
    engines with per-request audio are equal.
25. The paper's experiments: Fig. 3 at the JAX file's settings (all 8
    methods, in four processes sharing the card; update counts and batch paths as the schedules give them; a
    fused update's kernel launched once an update), Fig. 2's b*(x) at both
    rates over the full grid with the correlation, adaptive SEBS, and
    ResNet-20 at its real shape card against CPU (forward, backward, a
    pSGD update).

26. Elastic exact-sync training (``repro_torch.distributed``): qwen2.5-3b at
    full width cut to 2 layers, phase 7's schedule with pSGD, on devices
    [cuda:0] x budget for budgets 1, 2 and 4 (one worker process each,
    sharing the card; gloo for control, the partial sums through shared
    host slots; the caller's state to rank 0 by CUDA IPC). One microbatch's
    gradient has the same bits twice; losses, stages, batch sizes, GNS and
    final params are bit-identical across the budgets; the widths run are
    {1}, {1, 2}, {1, 2, 4}; the ledger is the one sync.py predicts; every
    worker launched the flash forward and backward for its microbatches and
    the fused pSGD for its updates. A run killed at update 9 under budget 4
    (saves at 4 and 8) resumes under budget 2 bit-identically; the
    launcher's --dp-elastic runs on the visible card. Prints update ms by
    stage and budget, the all-gather's host ms (copy out, barriers, copy
    back), the reshards' ms and each worker's peak, with the card's name
    and power limit.
27. Local SGD on the same model at budget 4 (momentum 0.9, local_interval 2,
    save_every 3): saves snap to updates [3, 6, 10, 12], losses finite, the
    state collapsed at the end, fewer collectives than updates.
30. Rule-based storage sharding: SEBSTrainer(mesh=make_host_mesh(2, 2) on
    cuda:0 x 4, param_axes=...) on phase 26's model and schedule, each
    layer gathered where it runs and the gradient exchanged as shard slices
    (``distributed/sharded.py``): losses and final params bit-identical to
    phase 26's budget 1; each worker launched the fused pSGD once an update
    (on its shards) and the flash kernels for its microbatches; each
    worker's memory_allocated between updates within 2% of its shards'
    bytes counted from the specs, and its peak in a stage-2 update within
    10% of the dry run's count of its rank's step (the same mesh and
    depth). Prints the layer gathers', the collectives' (copy out /
    barriers / copy back) and the optimizer's ms and the updates' ms by
    stage, and each worker's peak.
31. ElasticTrainer(param_axes=...) at budget 4: losses and params
    bit-identical to phase 26's budget 4; the same peaks against the count
    (the ("data",) mesh of 4) and timings.
32. The dry run and the roofline (run right after phase 9, on its state):
    (a) qwen2.5-3b train_4k counted on meta tensors on the (16, 16) mesh
    (``repro_torch.launch.dryrun``): rank 0's argument and peak bytes,
    FLOPs, bytes accessed, collective bytes by type and the three roofline terms at
    the H100's published peaks, in under 10 s on the host; (b) one stage-2
    update of phase 7's cell under each remat policy (nothing_saveable,
    dots_saveable, dots_no_batch, save_block_outputs; each twice, the second
    round in reverse order) from the same params, the dry-run counts in
    worker processes meanwhile:
    losses and params bit-identical across the policies, the flash forward
    288 and backward 144 launches an update under each, the peak (less the
    reference copies held) within 10% of the dry run's for the same step on
    the (1, 1) mesh; prints each update's ms beside the roofline's compute
    and memory terms and the share, with the card's name and power limit.

33. The paper's Fig. 1 (``repro_torch.experiments.fig1_util``, right
    after phase 25): the momentum train step on qwen2.5-3b at smoke size
    and at full width, µs a sample at batches 1, 2, 4, 8, 16, 32 of 64
    tokens (3 timed steps each): below at batch 32 than at batch 1 at both
    sizes, the flash kernels and the fused momentum launched once a layer
    (the forward twice, under remat) and once a step, within 30 s; prints
    the six times with the card's name and power limit.
34. An MoE layer's experts over the mesh's ``model`` groups
    (``distributed/sharded.py``): SEBSTrainer(mesh=make_host_mesh(2, 2))
    on cuda:0 x 4, dbrx-132b and arctic-480b smoke at f32, pSGD, 6 updates
    (at width 2 a model group without rows), against the same schedule in
    one process: the ladder equal, losses within 1e-4 relative and every
    param within 1e-4 of its leaf's norm; whether the bits matched is
    printed; each worker's launches exact.
35. dbrx-132b at full width cut to 1 of its 40 layers on (1, 2), two
    workers on cuda:0 with 8 experts each, the state built from a seed on
    rank 0's device and kept on the workers (``run_on_mesh(...,
    init_seed=0)``): one update of 4 rows of 513 tokens, each worker's
    peak within 10% of the dry run's count of its rank; prints the
    update's ms, the experts' all-to-alls', the gathers' and the
    collectives' parts.
36. The sharded serving forward (``distributed/mesh_serve.py``) on (2, 2)
    x cuda:0, qwen2.5-3b and dbrx-132b smoke at f32 from one spawn: the
    prefill and 3 greedy decode steps' logits against the single-process
    engine's calls, qwen bit-identical, dbrx within 1e-4 of their scale.

28. Disaggregated prefill/decode serving (``DisaggregatedEngine``, both
    workers on cuda:0: two pools, two caches, the export / move / import
    seam) of qwen2.5-3b at full width on phase 4's weights and requests
    (prefill ring 2), after phase 4's warm-up request, under
    REPRO_SANITIZE=1 with the seam wrapped (seam_checks) and the counters
    zeroed just before and read just after: every request completes, 8
    transfers, the greedy streams equal phase 4's bit for bit, each block
    bit-equal to the prefill pool at export and to the decode pool at
    adoption (and unchanged while it waited), the launches those the stats
    predict (paged decode 36 a decode tick and a tail tick, chunk prefill
    36 a chunk, the sampler a tick and a first token), the decode worker
    with no chunk step, the prefill worker with one a size and at most one
    tail tick at width 2, both workers on the same weight tensors, no
    sanitizer error. Then a timed run (sanitizers off, nothing wrapped) on
    fresh prompts of the same shape: tok/s, the median decode tick and
    TTFT p50 beside phase 4's, the seam's bytes, export and import device
    ms, both pools' peaks, peak memory.
29. The same for zamba2-2.7b at full width against phase 15's paged run
    (the shared attention's pages at D 80 and the Mamba2 state rows across
    the seam; GLA forward 54 a chunk); then on qwen2.5-3b, rwkv6-1.6b
    (state rows only) and zamba2-2.7b smoke (ssm_state 64) in float32 the
    disaggregated engine's greedy tokens on the card equal the CPU path's,
    under REPRO_SANITIZE=1.

Phase 3 also holds the MoE family's shapes: the flash forward and backward
at G 6 (B 4, S 513, 48/8 heads), the forward at dbrx's dense prefills and
at G 7 (B 8, S 512, 56/8), the paged decode and chunk prefill at G 6 and G
7, the sampler at 8 rows of 100,352 and 32,000, and the fused pSGD bit for
bit over one dbrx layer's expert tensors.

Any failed phase exits non-zero. The last lines of standard output are the
kernels' JSON record, the card's name and power limit as nvidia-smi gives
them, and ``{"ok": true, "device": {...}}``. A copy of the record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from cardbench import (  # noqa: E402  (tools/cardbench.py: timing, traces, SASS, pools, sampler rows)
    copies_for, device_trace, excess, nbytes, nvidia_smi, paged_pool, sampler_rows, sampler_work, sass_counts,
    timed,
)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
OUT_DIR = ROOT / "chiprun_out"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_ms(fn, arg_sets, iters: int) -> float:
    """Device busy ms per call of ``fn(*args)`` (cardbench.device_ms)."""
    from cardbench import device_ms as per_call

    return per_call(fn, arg_sets, iters, OUT_DIR)[0]


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


def cost_bound(cost, peak_ops: float):
    """The bound of a kernel's ``cost(...)`` (operations, bytes), the
    function the dry run counts the kernel's work with."""
    ops, bytes_moved = cost
    return bound(bytes_moved, ops, peak_ops)


def merge(readings: list) -> dict:
    """The worst reading of each kind: the largest error and excess, the
    planted fault closest to passing."""
    out = {key: max(r[key] for r in readings) for key in ("max_abs_err", "excess")}
    faults = [r["fault_excess"] for r in readings if "fault_excess" in r]
    if faults:
        out["fault_excess"] = min(faults)
    return out


def tensor_op_counts(lib: str, name_of) -> dict:
    """The tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma) in the
    SASS of each kernel of library ``lib``: ``name_of(mangled name)`` (None
    to skip a function) -> count."""
    counts = {name: tensor_ops for name, (tensor_ops, _) in sass_counts(lib, name_of).items()}
    if not counts:
        fail(f"cuobjdump found no {lib} kernel in the built library")
    return counts


def hgmma_counts() -> dict:
    """The HGMMA (wgmma) instructions in the SASS of each flash kernel:
    name<head_dim> -> count."""
    import re

    def name_of(mangled):
        found = re.search(r"\d+(flash_\w+?_kernel)ILi(\d+)E", mangled)
        return f"{found.group(1)}<{found.group(2)}>" if found else None

    return tensor_op_counts("flash_attention", name_of)


# the bf16 GLA kernels that hold matrix products (the two scans are elementwise)
GLA_TC_KERNELS = ("tc::local_kernel<false>", "tc::local_kernel<true>", "tc::fwd_out_kernel",
                  "tc::bwd_chunk_kernel")


def gla_tensor_op_counts() -> dict:
    """HMMA and HGMMA in the SASS of each GLA kernel: the bf16 route's
    (namespace tc) and the f32 route's, name -> count."""
    import re

    def name_of(mangled):
        found = re.search(r"\d+((?:local|fwd_scan|bwd_scan|fwd_out|bwd_chunk|gla_fwd|gla_bwd)_kernel)"
                          r"(ILb([01])E)?", mangled)
        if not found:
            return None
        name = found.group(1) + (f"<{'true' if found.group(3) == '1' else 'false'}>" if found.group(2) else "")
        return f"tc::{name}" if "2tc" in mangled else name

    return tensor_op_counts("gla", name_of)


# the bf16 paged-attention kernels, all of which hold products (decode's
# combine pass only merges partials)
PAGED_TC_KERNELS = tuple(f"tc::attend_kernel<{d}, {kind}>" for d in (64, 80, 128, 256)
                         for kind in ("decode", "prefill"))
# the bf16 flash kernels that hold products, at every head_dim they take (80:
# zamba2's shared attention)
FLASH_TC_KERNELS = tuple(f"{kind}_tc_kernel<{d}>" for d in (64, 80, 128)
                         for kind in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"))


def paged_tensor_op_counts() -> dict:
    """HMMA and HGMMA in the SASS of each paged-attention kernel: the bf16
    route's (namespace tc) and the f32 route's, name -> count."""
    import re

    def name_of(mangled):
        found = re.search(r"\d+(attend_kernel|combine_kernel|paged_decode_kernel|paged_prefill_kernel)"
                          r"ILi(\d+)E(?:Li\d+ELi\d+ELi\d+ELb([01])E)?", mangled)
        if not found:
            return None
        name, arg, decode = found.groups()
        if name == "attend_kernel":
            return f"tc::{name}<{arg}, {'decode' if decode == '1' else 'prefill'}>"
        return f"tc::{name}<{arg}>" if "2tc" in mangled else f"{name}<{32 * int(arg)}>"

    return tensor_op_counts("paged_attention", name_of)


def kernel_checks(kernel_records: dict) -> dict:
    """Phase 3: every kernel's wrapper (what the engine calls) against its
    plain version at full width. Returns the decode's serving-shape timings."""
    import torch

    from repro_torch.kernels.paged_decode import kernel, ops, ref

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
    out = ops.paged_flash_decode(q, k, v, table, pos)
    readings = [check_close("paged_flash_decode", out, ref.paged_attention_ref(q, k, v, table, pos),
                            ref.paged_attention_ref(q, k, v, table, dropped))]
    if not torch.equal(out, ops.paged_flash_decode(q, k, v, table, pos)):
        fail("paged_flash_decode: two runs on the same inputs differ")
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
        device_ms=device_ms(ops.paged_flash_decode, sets, 50),
        plain_ms=timed(ref.paged_attention_ref, sets, 20),
        bound=bound(io + kv, 4 * hq * d * sum(lengths), BF16_FLOPS),
    )
    # the serving shape: 8 slots of 544 tokens (512 of prompt, 32 decoded)
    # whose first 16 pages hold the shared 256-token prefix
    lengths = [544] * b
    k, v, table = paged_pool(gen, pages=pages, ps=ps, hkv=hkv, d=d, lengths=lengths, prefix_pages=16)
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32, device="cuda")
    out = ops.paged_flash_decode(q, k, v, table, pos)
    serving = check_close("paged_flash_decode (serving shape)", out, ref.paged_attention_ref(q, k, v, table, pos),
                          ref.paged_attention_ref(q, k, v, table, pos - 1))
    if not torch.equal(out, ops.paged_flash_decode(q, k, v, table, pos)):
        fail("paged_flash_decode (serving shape): two runs on the same inputs differ")
    kernel_records["paged_flash_decode"].update(merge(readings + [serving]))
    sets = [(q.clone(), k.clone(), v.clone(), table, pos) for _ in range(copies_for(nbytes(q, k, v)))]
    kv = kv_bytes_read(table, pos, ps, hkv, d, 2)
    decode_serving = dict(
        ms=timed(ops.paged_flash_decode, sets, 200),
        device_ms=device_ms(ops.paged_flash_decode, sets, 50),
        plain_ms=timed(ref.paged_attention_ref, sets, 20),
        bound=bound(io + kv, 4 * hq * d * sum(lengths), BF16_FLOPS),
    )
    del k, v, sets

    # -- paged chunk prefill: one 256-token chunk at pos_start 0 and 256
    c = 256
    k, v, table = paged_pool(gen, pages=pages, ps=ps, hkv=hkv, d=d, lengths=[512])
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
        device_ms=device_ms(ops.paged_chunk_prefill, sets, 20),
        plain_ms=timed(ref.paged_prefill_ref, sets, 10),
        bound=bound(io + kv, 4 * hq * d * visible, BF16_FLOPS),
    )

    # -- fused sampler: 8 rows of qwen2.5-3b's vocabulary (greedy, t=0.8 with
    #    top_k in {0, 1, 50}, a duplicated 50th value, a top_k above the
    #    vocabulary), one row (a request's first token) and 8 rows of
    #    rwkv6-1.6b's; every token must equal the plain version's. The bound
    #    counts what these rows need: every logit once, and the noise of the
    #    logits each row scores (all of a keep-all row's, a top-k row's kept
    #    ones; greedy rows none) (cardbench.sampler_work).
    shapes = {name: sampler_reading(name, gen, rows, vocab) for name, rows, vocab in (
        ("b8_v151936", 8, 151936), ("b1_v151936", 1, 151936), ("b8_v65536", 8, 65536))}
    kernel_records["fused_sample"] = {**shapes["b8_v151936"], "shapes": shapes}
    return decode_serving


def sampler_reading(name: str, gen, rows: int, vocab: int) -> dict:
    """The sampler's wrapper on ``rows`` rows of ``vocab`` logits (greedy,
    t=0.8 with top_k in {0, 1, 50}, a duplicated 50th value, a top_k above
    the vocabulary: cardbench.sampler_rows): every token must equal the
    plain version's. Timed L2-cold, on the device and plain; the bound
    counts what these rows need (cardbench.sampler_work)."""
    from repro_torch.kernels.paged_decode import kernel, ops, ref

    logits, noise, temperature, top_k = sampler_rows(gen, rows, vocab)
    got = ops.fused_sample(logits, noise, temperature, top_k)
    expect = ref.fused_sample_ref(logits, noise, temperature, top_k)
    mismatched = int((got != expect).sum())
    if mismatched:
        fail(f"fused_sample ({name}): {mismatched} tokens differ from the plain version: "
             f"{got.tolist()} vs {expect.tolist()}")
    sets = [(logits.clone(), noise.clone(), temperature, top_k)
            for _ in range(copies_for(nbytes(logits, noise)))]
    work_bytes, work_ops = sampler_work(logits, temperature, top_k)
    return dict(
        max_abs_err=mismatched,  # tokens that differ
        ms=timed(ops.fused_sample, sets, 100),
        device_ms=device_ms(ops.fused_sample, sets, 20),
        plain_ms=timed(ref.fused_sample_ref, sets, 20),
        bound=bound(work_bytes, work_ops, F32_FLOPS),
        splits=kernel.sample_layout(rows, vocab)[1],
    )


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def small_input_agreement(arch: str, smoke=None) -> None:
    """Greedy tokens of the engine on the card (kernels) equal the CPU
    path's (plain versions) on ``arch`` smoke (or ``smoke``) in float32."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.serve import PagedContinuousBatchingEngine

    cfg = (smoke or get_config(arch, "smoke")).replace(compute_dtype="float32")
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


def device_profile(run, prepare=None) -> dict:
    """``run()`` under torch.profiler, tracing the device only
    (cardbench.device_trace, which calls ``prepare()`` before each
    attempt), with the GLA, the paged decode and prefill
    kernels' and the sampler's ms, the sampler's launches, and the 15
    largest kernels."""
    trace = device_trace(run, OUT_DIR, prepare)
    by_kernel = trace["by_kernel"]
    sampler = [(ms, n) for name, (ms, n) in by_kernel.items() if SAMPLER_KERNEL_NAME in name]
    return {
        **trace,
        "gla_ms": sum(ms for name, (ms, _) in by_kernel.items() if any(k in name for k in GLA_KERNEL_NAMES)),
        "flash_fwd_ms": sum(ms for name, (ms, _) in by_kernel.items() if FLASH_FWD_KERNEL_NAME in name),
        **{f"{kind}_ms": sum(ms for name, (ms, _) in by_kernel.items() if paged_kind(name) == kind)
           for kind in ("paged_decode", "paged_prefill")},
        "sampler_ms": sum(ms for ms, _ in sampler), "sampler_launches": sum(n for _, n in sampler),
        "by_kernel": dict(list(by_kernel.items())[:15]),
    }


def paged_kind(name: str):
    """"paged_decode" or "paged_prefill" for a paged-attention kernel's name
    in a trace (paged_attention.cu: the bf16 route's tc::attend_kernel<...,
    true> and tc::combine_kernel decode, tc::attend_kernel<..., false>
    prefills; the f32 route's kernels are named for what they do), else None."""
    if "paged_decode_kernel" in name or "tc::combine_kernel" in name or (
            "tc::attend_kernel" in name and "true>" in name):
        return "paged_decode"
    if "paged_prefill_kernel" in name or ("tc::attend_kernel" in name and "false>" in name):
        return "paged_prefill"
    return None


# the sampler's kernel in a trace (fused_sample.cu)
SAMPLER_KERNEL_NAME = "sample_kernel"
# the flash forward kernels in a trace (flash_attention.cu: flash_fwd_tc_kernel, flash_fwd_kernel)
FLASH_FWD_KERNEL_NAME = "flash_fwd"
# the GLA kernels' names in a trace (gla.cu): the bf16 passes, the f32 route, du's sum
GLA_KERNEL_NAMES = ("tc::local_kernel", "tc::fwd_scan_kernel", "tc::fwd_out_kernel", "tc::bwd_scan_kernel",
                    "tc::bwd_chunk_kernel", "du_reduce_kernel", "gla_fwd_kernel", "gla_bwd_kernel")


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
# zamba2-2.7b (all 54 layers): 10.8185 -> 10.7078 at 0.3, NaN by the eighth
# update at 1 and the fifth at 3. gemma2-9b at 8 layers: from 22.0247 (its
# embedding scaled by sqrt(d_model) into the final soft-cap of 30) 22.0003 /
# 21.9404 / 21.6336 after 12 updates at 0.01 / 0.03 / 0.1, and 33.98 /
# 32.22 / 33.47 at 0.3 / 1 / 3 (on an H100 80GB HBM3 at 700 W).
# dbrx-132b at 1 of its 40 layers (phase 19), from 11.9921: 12.0271 / 12.0103
# / 11.9952 / 11.9657 / 12.0340 after 12 updates at 0.1 / 0.3 / 0.5 / 0.7 /
# 1, NaN by the ninth update at 1.5, 2 and 3 and earlier at 10, 30 and 100
# (run_sebs, as tools/train_lr_scan.py --arch dbrx-132b --layers 1 runs it;
# on an H100 80GB HBM3 at 700 W): 0.7 is the one rate that ended below its
# start, by 0.026, where one batch's loss moves ~0.02 from the next.
# The adaptive optimizers (phase 14) at rates usual for each: AdamW 1e-3
# (its first steps move every weight by about eta), LAMB 1e-2 and LARS 1
# (each leaf moves by eta times its own norm, scaled by 0.01 for LARS).
ETAS = {"psgd": 1.0, "momentum": 0.3, "adagrad_da": 1.0, "rwkv6_psgd": 1.0,
        "zamba2_psgd": 0.3, "gemma2_psgd": 0.1, "dbrx_psgd": 0.7, "whisper_psgd": 0.3, "adamw": 1e-3, "lars": 1.0,
        "lamb": 1e-2}


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
    (batch, head) over S positions (``kernels/gla/ops.py``'s ``products``)."""
    from repro_torch.kernels.gla.ops import products

    return products(s, backward=backward)


def dlog_w_without_chunk_totals(q, k, v, lw, u, dy, d_lw, include_current: bool = False):
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
                                       include_current=include_current, initial_state=state)
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
    records["gla_fwd"] = dict(
        **merge(fwd),
        ms=timed(lambda *a: ops.forward(*a, include_current=False, save_states=True), sets, 50),
        plain_ms=timed(lambda q_, k_, v_, lw_, u_: ref.gla_fwd_ref(q_, k_, v_, lw_, bonus_u=u_,
                                                                   include_current=False), sets, 3),
        bound=cost_bound(ops.cost(q, k, v, lw, u), BF16_FLOPS),
        library_ms=None,
    )
    records["gla_bwd"] = dict(
        **merge(bwd),
        ms=timed(lambda *a: ops.backward(*a, include_current=False), bwd_sets, 20),
        plain_ms=timed(lambda *a: ref.gla_bwd_ref(*a[:6], a[8], a[9], include_current=False),
                       bwd_sets, 2),
        # reads q, k, v, dy, log_w and u; writes dq, dk, dv, dlog_w and du
        bound=cost_bound(ops.cost(q, k, v, lw, u, backward=True), BF16_FLOPS),
        library_ms=None,
    )
    # the kernels' own device time (the L2-cold loop also holds the host's time a call)
    records["gla_fwd"]["device_ms"] = device_ms(
        lambda *a: ops.forward(*a, include_current=False, save_states=True), sets, 20)
    records["gla_bwd"]["device_ms"] = device_ms(lambda *a: ops.backward(*a, include_current=False),
                                                bwd_sets, 10)
    del q, k, v, lw, dy, y, final, states, grads, again, expect, fault, sets, bwd_sets
    # strong decay at the training shape: every fifth channel at log_w -30 a step, where
    # exp(-W) overflows within a chunk
    q, k, v, lw, u, _, dy = gla_inputs(gen, 4, 513, 32, initial_state=False)
    lw[..., ::5] = -30.0
    y, final, states = ops.forward(q, k, v, lw, u, include_current=False, save_states=True)
    expect_y, expect_final = ref.gla_fwd_ref(q, k, v, lw, bonus_u=u, include_current=False)
    fwd.append(check_scaled("gla_fwd y (strong decay)", y, expect_y, "y"))
    fwd.append(check_scaled("gla_fwd final state (strong decay)", final, expect_final, "float32"))
    grads = ops.backward(q, k, v, lw, u, None, states, final, dy, None, include_current=False)
    expect = ref.gla_bwd_ref(q, k, v, lw, u, None, dy, None, include_current=False)
    for name, g, e in zip(("dq", "dk", "dv", "dlog_w", "du"), grads, expect):
        tol = "grad" if g.dtype == torch.bfloat16 else "float32"
        bwd.append(check_scaled(f"gla_bwd {name} (strong decay)", g, e, tol))
    records["gla_bwd"].update(merge(bwd))
    del q, k, v, lw, dy, y, final, states, grads, expect
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
        device_ms=device_ms(lambda *a: ops.forward(*a, include_current=False), sets, 20),
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


def flash_shape(records: dict, gen, b: int, s: int, hq: int, hkv: int, d: int, suffix: str = "",
                causal: bool = True) -> None:
    """The flash kernels through their ops wrappers at one shape (bf16,
    causal or not): the forward against its plain version with a planted
    fault (each query's last visible key dropped; without the causal mask
    also the causal mask where none belongs, the worse-hidden of the two
    held), the backward with one (Di left out), the same bits twice;
    L2-cold and device times, the plain versions', the bound and SDPA's
    under a named backend and the default dispatch. Into
    ``records["flash_attention_fwd" + suffix]`` and the backward's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    name_fwd, name_bwd = "flash_attention_fwd" + suffix, "flash_attention_bwd" + suffix
    q, k, v = flash_inputs(gen, b, s, hq, hkv, d)
    d_out = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = ops.forward(q, k, v, causal=causal)
    expect, _ = ref.attention_fwd_ref(q, k, v, causal=causal)
    # planted fault: query i sees keys up to i - 1 (its last visible key dropped)
    dropped = ref.attention_ref(q, k[:, :-1], v[:, :-1], causal=causal)
    fwd = check_close(name_fwd, out, expect, dropped)
    if not causal:  # and a causal mask where none belongs
        masked = check_close(name_fwd, out, expect, ref.attention_ref(q, k, v, causal=True))
        fwd["fault_excess"] = min(fwd["fault_excess"], masked["fault_excess"])
    grads = ops.backward(q, k, v, out, lse, d_out, causal=causal)
    expect_grads = ref.attention_bwd_ref(q, k, v, out, lse, d_out, causal=causal)
    fault_grads = ref.attention_bwd_ref(q, k, v, torch.zeros_like(out), lse, d_out, causal=causal)  # Di left out
    again = ops.backward(q, k, v, out, lse, d_out, causal=causal)
    if not all(torch.equal(x, y) for x, y in zip(grads, again)):
        fail(f"{name_bwd}: two runs on the same inputs differ")
    bwd = {"max_abs_err": 0.0, "excess": 0.0, "fault_excess": float("inf")}
    for name, g, e, f in zip(("dq", "dk", "dv"), grads, expect_grads, fault_grads):
        x = excess_bwd(g, e)
        if not torch.isfinite(g).all() or x > 1:
            fail(f"{name_bwd} {name}: kernel disagrees with its plain version ({x:.2f} x the allowance)")
        bwd["max_abs_err"] = max(bwd["max_abs_err"], (g.float() - e.float()).abs().max().item())
        bwd["excess"] = max(bwd["excess"], x)
        if name != "dv":  # dV does not read Di
            bwd["fault_excess"] = min(bwd["fault_excess"], excess_bwd(f, e))
    if bwd["fault_excess"] <= 1:
        fail(f"{name_bwd}: the tolerance cannot tell a missing Di term from the right answer")

    n_sets = copies_for(nbytes(q, k, v, d_out, out))
    sets = [(q.clone(), k.clone(), v.clone()) for _ in range(n_sets)]
    bwd_sets = [(*x, out.clone(), lse.clone(), d_out.clone()) for x in sets]
    fwd_fn = functools.partial(ops.forward, causal=causal)
    bwd_fn = functools.partial(ops.backward, causal=causal)
    records[name_fwd] = dict(
        **fwd,
        ms=timed(fwd_fn, sets, 50),
        plain_ms=timed(functools.partial(ref.attention_fwd_ref, causal=causal), sets, 5),
        bound=cost_bound(ops.cost(q, k, v, causal=causal), BF16_FLOPS),
    )
    records[name_bwd] = dict(
        **bwd,
        ms=timed(bwd_fn, bwd_sets, 20),
        plain_ms=timed(functools.partial(ref.attention_bwd_ref, causal=causal), bwd_sets, 3),
        # reads q, k, v, out, dO and lse; writes dq, dk, dv; the four
        # products of the gradient (dV, dP, dQ, dK), the recomputation of
        # P being the kernel's choice
        bound=cost_bound(ops.cost(q, k, v, causal=causal, backward=True), BF16_FLOPS),
    )
    # the library yardstick: SDPA on the (B, H, S, D) layout, forward and
    # backward, under one named backend (library_ms; flash where it takes
    # GQA, else memory-efficient) and under PyTorch's default dispatch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in x) for x in sets]

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(q_, k_, v_, is_causal=causal, enable_gqa=True)

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
            (records[name_fwd], records[name_bwd]), named, default):
        rec.update(library_ms=ms_named, library_backend=backend.name, library_ms_default=ms_default,
                   library_device_ms=dev_named, library_device_ms_default=dev_default)
    # the kernels' own device time: the L2-cold loop above also holds the
    # host's time per call where that exceeds the kernels'
    records[name_fwd]["device_ms"] = device_ms(fwd_fn, sets, 20)
    records[name_bwd]["device_ms"] = device_ms(bwd_fn, bwd_sets, 10)


def flash_inputs(gen, b: int, s: int, hq: int, hkv: int, d: int):
    """bf16 q (B, S, hq, D) and k, v (B, S, hkv, D) on the card."""
    import torch

    return tuple(torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                 for h in (hq, hkv, hkv))


def flash_serving_prefills(records: dict, name: str, gen, batches, hq: int, hkv: int, d: int,
                           seqs=(512,), causal: bool = True) -> None:
    """The flash forward at a serving engine's prefills, B of S tokens for
    each B in ``batches`` and S in ``seqs`` (by default 512: no tail tile),
    causal or not, against its plain version with flash_shape's planted
    faults (each query's last visible key dropped; without the causal mask
    also the causal mask where none belongs); folded into
    ``records[name]``'s worst readings and kept under its
    ``"serving_prefill"``."""
    from repro_torch.kernels.flash_attention import ops, ref

    serving = {}
    for b, s in itertools.product(batches, seqs):
        q, k, v = flash_inputs(gen, b, s, hq, hkv, d)
        label = f"{name} (serving prefill, B {b} S {s})"
        out, expect = ops.forward(q, k, v, causal=causal)[0], ref.attention_fwd_ref(q, k, v, causal=causal)[0]
        reading = check_close(label, out, expect, ref.attention_ref(q, k[:, :-1], v[:, :-1], causal=causal))
        if not causal:
            masked = check_close(label, out, expect, ref.attention_ref(q, k, v, causal=True))
            reading["fault_excess"] = min(reading["fault_excess"], masked["fault_excess"])
        serving[f"b{b}_s{s}"] = reading
    records[name].update(merge([records[name], *serving.values()]), serving_prefill=serving)


def flash_checks(records: dict) -> None:
    """The flash kernels at the training path's shapes: qwen2.5-3b,
    microbatch 4 of 512 + 1 tokens (B 4, S 513, 16 query and 2 KV heads,
    head_dim 128), the forward also with a window of 100 and at the dense
    serving path's prefills (phase 12): B 1 (the continuous engine) and B 8
    (the static one); then the f32 route."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    hq, hkv, d = 16, 2, 128
    flash_shape(records, gen, 4, 513, hq, hkv, d)
    q, k, v = flash_inputs(gen, 4, 513, hq, hkv, d)
    window = check_close("flash_attention_fwd (window 100)", ops.forward(q, k, v, sliding_window=100)[0],
                         ref.attention_ref(q, k, v, sliding_window=100))
    records["flash_attention_fwd"].update(merge([records["flash_attention_fwd"], window]))
    flash_serving_prefills(records, "flash_attention_fwd", gen, (1, 8), hq, hkv, d)
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
        if kname.startswith("fused_psgd"):
            state = [leaves(shapes)]
            wrapper = lambda w_, g_, a_: ops.psgd_update(w_, g_, a_, lr=lr, gamma=gamma)
            plain = lambda w_, g_, a_: [ref.psgd_ref(*x, lr=lr, gamma=gamma) for x in zip(w_, g_, a_)]
            outputs = lambda w_, st: [w_]
        elif kname.startswith("fused_momentum"):
            state = [leaves(shapes)]
            wrapper = lambda w_, g_, u_: ops.momentum_update(w_, g_, u_, lr=lr, beta=beta)
            plain = lambda w_, g_, u_: list(zip(*[ref.momentum_ref(*x, lr=lr, beta=beta)
                                                  for x in zip(w_, g_, u_)]))
            outputs = lambda w_, st: [w_, st[0]]
        else:
            state = [leaves(shapes), leaves(shapes), leaves(shapes, positive=True)]
            wrapper = lambda w_, g_, a_, z_, s_: ops.adagrad_da_update(
                w_, g_, a_, z_, s_, lr=lr, delta=delta, nu=nu)
            plain = lambda w_, g_, a_, z_, s_: list(zip(*[
                ref.adagrad_da_ref(*x, lr=lr, delta=delta, nu=nu) for x in zip(w_, g_, a_, z_, s_)]))
            outputs = lambda w_, st: [w_, st[1], st[2]]
        expect = plain(w, g, *state)
        expect = [expect] if kname.startswith("fused_psgd") else expect
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
            device_ms=device_ms(wrapper, [(w, g, *state)], 5),
            plain_ms=timed(plain, [(w, g, *state)], 2),
            # pSGD reads w, g, the anchor and writes w; momentum reads w, g, u and
            # writes w, u; AdaGrad-DA reads g, the anchor, z, s2 and writes w, z, s2
            bound=cost_bound(ops.cost(next(b for b in ops.LAUNCHES if kname.startswith(b)), w, g, *state),
                             F32_FLOPS),
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


def flash_launches() -> dict:
    """The flash kernels' launch counts, and under ``<kernel>_noncausal``
    those of them made without the causal mask."""
    from repro_torch.kernels.flash_attention import ops

    return {**ops.LAUNCHES, **{f"{n}_noncausal": c for n, c in ops.LAUNCHES_NONCAUSAL.items()}}


def run_sebs(cfg, optimizer, *, eta: float, device: str, seq: int, b1: int, c1: int, stages: int,
             params=None, dataset=None, **run_kw):
    """One SEBS run (rho 2, microbatch b1) from seed-0 weights (or
    ``params``) on the seed-0 token stream (or ``dataset``), every launch
    counter zeroed just before and read just after; ``run_kw`` goes to
    ``SEBSTrainer.run`` (checkpointing). Returns (log, wall s, launches,
    per-update seconds, state, trainer)."""
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
                          DataPipeline(dataset or TokenDataset(cfg.vocab_size, seq, seed=0), device=device),
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
    state, log = trainer.run(state, log_every=1, **run_kw)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**flash_launches(), **optim_ops.LAUNCHES, **gla_ops.LAUNCHES}
    updates = [ev["dur"] for ev in tracer.events if ev.get("name") == "train.update"]
    if run_kw.get("stop_after_updates") is None and (
            log.stages != expected_ladder(schedule)[0] or log.batch_sizes != expected_ladder(schedule)[1]):
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
CARD_CPU_ETAS = {"qwen2.5-3b": 0.3, "rwkv6-1.6b": 0.01, "zamba2-2.7b": 0.3, "gemma2-9b": 0.3,
                 "dbrx-132b": 0.3, "arctic-480b": 0.3}
CARD_CPU_REFERENCE_ETA = 0.3
CARD_CPU_RTOL = 1e-4


@contextlib.contextmanager
def capture_routing():
    """Records, on the host, the router probabilities and the experts chosen
    at every routing that models/layers/moe.py makes inside the block (each
    MoE layer's forward, and again at its recomputation under remat)."""
    from repro_torch.models.layers import moe

    calls: list = []
    choose = moe.top_experts

    def recording(probs, top_k):
        chosen = choose(probs, top_k)
        calls.append((probs.detach().float().cpu(), chosen.cpu()))
        return chosen

    moe.top_experts = recording
    try:
        yield calls
    finally:
        moe.top_experts = choose


def routing_report(arch: str, cpu: list, card: list, cfg) -> dict:
    """The expert choices of the CPU path and the card's, each counted per
    expert, and every token whose chosen set differs between them (a flip),
    printed with the CPU's probability gap between its k-th and (k+1)-th
    expert: a flip at a near-tie is rounding, one at a wide gap a fault."""
    import torch

    if len(cpu) != len(card):
        fail(f"{arch}: {len(cpu)} routings on the CPU, {len(card)} on the card")
    k, e = cfg.top_k, cfg.num_experts
    counts = {"cpu": torch.zeros(e, dtype=torch.int64), "card": torch.zeros(e, dtype=torch.int64)}
    flips, tokens = [], 0
    for call, ((probs, a), (_, c)) in enumerate(zip(cpu, card)):
        counts["cpu"] += torch.bincount(a.flatten(), minlength=e)
        counts["card"] += torch.bincount(c.flatten(), minlength=e)
        same = (a.sort(-1).values == c.sort(-1).values).all(-1)
        tokens += same.numel()
        for where in (~same).nonzero().tolist():
            ranked = probs[tuple(where)].sort(descending=True).values
            flips.append({"call": call, "token": where, "gap": (ranked[k - 1] - ranked[k]).item()})
    print(f"card vs cpu: {arch} routing over {len(cpu)} routings of {tokens} tokens (top-{k} of {e}): "
          f"expert choices cpu {counts['cpu'].tolist()}, card {counts['card'].tolist()}; "
          f"{len(flips)} tokens chose other experts" + "".join(
              f" | flip at routing {f['call']}, token {f['token']}: probability gap {f['gap']:.3e}"
              for f in flips), flush=True)
    return {"routings": len(cpu), "tokens": tokens, "cpu": counts["cpu"].tolist(),
            "card": counts["card"].tolist(), "flips": flips}


def card_cpu_agreement(arch: str, smoke=None) -> dict:
    """``arch`` smoke (or ``smoke``) in float32 from the same weights on the
    CPU (plain versions) and on the card (kernels): the first update's gradients leaf
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

    cfg = (smoke or get_config(arch, "smoke")).replace(compute_dtype="float32")
    model = LanguageModel(cfg)
    # the same seed-0 weights on both: made on the CPU, then moved
    base = model.init(seed=0, device="cpu")
    tokens = torch.from_numpy(np.asarray(TokenDataset(cfg.vocab_size, 32, seed=1).batch(0, 4)["tokens"]))
    def copy_to(tree, device):  # the runs update their weights in place
        return tree_map(lambda x: x.detach().to(device, copy=True), tree)

    grads, routing = {}, {}
    for device in ("cpu", "cuda"):
        params = copy_to(base, device)
        for w in tree_leaves(params):
            w.requires_grad_(True)
        with capture_routing() as routing[device]:
            g, _ = _grads_over_microbatches(model, params, {"tokens": tokens.to(device)}, 1, 0.0)
        grads[device] = [x.detach().cpu() for x in g]
    routes = routing_report(arch, routing["cpu"], routing["cuda"], cfg) if cfg.num_experts else None
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
           "grad_max_rel": grad_worst, "eta": eta, "routing": routes}
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
    an untraced one timed for comparison. Returns (profile, untraced ms,
    the untraced update's metrics)."""
    import torch

    from repro_torch.train import build_train_step

    step = build_train_step(trainer.model, optimizer, accum_steps=4)
    batch = trainer.pipeline.next_batch(16)
    batch = {k: v.reshape((4, 4) + tuple(v.shape[1:])) for k, v in batch.items()}
    step(state, batch, lr, 2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = step(state, batch, lr, 2)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    prof = device_profile(lambda: step(state, batch, lr, 2))
    print(f"{label} profile: one update of 4 microbatches, device busy {prof['busy_ms']:.1f} ms "
          f"of {prof['wall_ms']:.1f} ms wall, idle {100 * prof['idle_share']:.1f}% | "
          f"{prof['activities']} device activities | untraced update {untraced_ms:.1f} ms | GLA kernels "
          f"{prof['gla_ms']:.2f} ms", flush=True)
    for kname, (ms, n) in list(prof["by_kernel"].items())[:10]:
        print(f"{label} profile: {ms:9.2f} ms {n:6d} x  {kname[:100]}")
    return prof, untraced_ms, metrics


REMAT_POLICIES = ("nothing_saveable", "dots_saveable", "dots_no_batch", "save_block_outputs")
DRYRUN_SECONDS = 10.0  # phase 32(a)'s limit on the host
REMAT_PEAK_TOL = 0.10  # the card's peak against the dry run's, relative


def _dry_run_train_4k():
    """(the dry run's summary of qwen2.5-3b train_4k on the (16, 16) mesh,
    its host seconds after a warm-up at smoke size), in a worker process."""
    import torch

    from repro_torch.launch import dryrun

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    # warm-up at smoke size: PyTorch imports some modules at first use
    dryrun.count_combo(get_config("qwen2.5-3b", "smoke"), InputShape("warm", 16, 4, "train"),
                       make_host_mesh(2, 2, devices=["meta"] * 4))
    t0 = time.perf_counter()
    summary = dryrun.run_combo("qwen2.5-3b", "train_4k", False)
    return summary, time.perf_counter() - t0


def _count_update(cfg, seq: int, policy: str):
    """(the dry run's count of phase 7's stage-2 update under ``policy`` on
    the (1, 1) mesh, its host seconds), in a worker process."""
    import torch

    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    summary = dryrun.count_train(cfg.replace(remat_policy=policy), InputShape("phase7_stage2", seq, 16, "train"),
                                 make_production_mesh(devices=["meta"]), accum_steps=4, optimizer_name="psgd")
    return summary, time.perf_counter() - t0


def dry_run_report(summary: dict, seconds: float) -> dict:
    """Phase 32(a): the meta dry run of qwen2.5-3b train_4k on the (16, 16)
    mesh (``repro_torch.launch.dryrun``, nothing allocated): rank 0's bytes,
    FLOPs and collective bytes and the three roofline terms at the H100's
    published peaks. Fails if it took DRYRUN_SECONDS or more on the host."""
    from repro_torch.roofline.analysis import roofline_from_summary

    terms = roofline_from_summary(summary)
    mem, coll = summary["memory"], summary["collectives"]
    print(f"phase 32(a) dry run qwen2.5-3b train_4k on {summary['mesh']} (meta, counted on the host in "
          f"{seconds:.2f} s): per rank arguments {mem['argument_bytes_per_device']} B, peak "
          f"{mem['peak_bytes_per_device']} B, flops {summary['cost']['flops']:.6e}, bytes accessed "
          f"{summary['cost']['bytes_accessed']:.6e}, collective bytes {coll['total_bytes']} "
          f"({', '.join(f'{k} {v}' for k, v in sorted(coll['by_type_bytes'].items()))}) | roofline (H100 "
          f"published peaks) compute {terms.compute_s:.4f} s, memory {terms.memory_s:.4f} s, collective "
          f"{terms.collective_s:.4f} s, dominant {terms.dominant}", flush=True)
    if seconds >= DRYRUN_SECONDS:
        fail(f"phase 32(a): the dry run took {seconds:.1f} s on the host, not under {DRYRUN_SECONDS:.0f} s")
    return {"seconds": seconds, "memory": mem, "cost": {k: summary["cost"][k] for k in ("flops", "bytes_accessed")},
            "collectives": coll, "terms": {"compute_s": terms.compute_s, "memory_s": terms.memory_s,
                                           "collective_s": terms.collective_s, "dominant": terms.dominant}}


def remat_start(cfg, trainer, state, optimizer, lr: float) -> tuple:
    """Phase 32: starts the dry-run counts in worker processes (spawned, one
    CPU thread each, five of the host's cores), runs phase 7's stage-2
    update under each remat policy on the card (b), and returns with the
    counts still running (they finish beside the next phases):
    (the pool, its futures, the card's measurements)."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(1 + len(REMAT_POLICIES),
                                                  mp_context=multiprocessing.get_context("spawn"))
    dry = pool.submit(_dry_run_train_4k)
    seq = trainer.pipeline.ds.seq_len + 1
    counts = {p: pool.submit(_count_update, cfg, seq, p) for p in REMAT_POLICIES}
    return pool, dry, counts, remat_update(cfg, trainer, state, optimizer, lr)


def remat_finish(started: tuple, smi: str) -> dict:
    """Phase 32's report once the counts are in: (b) each update against the
    dry run's count of it, (a) the dry run of train_4k; stops the workers."""
    pool, dry, counts, measured = started
    t0 = time.perf_counter()
    with pool:
        counted = {p: f.result() for p, f in counts.items()}
        report = {"update": remat_check(measured, counted, smi), "dry_run": dry_run_report(*dry.result())}
    print(f"phase 32: waited {time.perf_counter() - t0:.1f} s for the counts", flush=True)
    return report


def remat_update(cfg, trainer, state, optimizer, lr: float) -> dict:
    """Phase 32(b) on the card: stage-2 updates of phase 7's cell (full
    width, 4 microbatches of 4 x 513, pSGD) under each remat policy, twice
    each (the policies in order, then in reverse order), from the same
    params each time (restored from a copy on the card; the anchors do
    not move within a stage), each after reset_peak_memory_stats() (phase 9
    has run the step warm). Fails
    unless the losses and params are bit-identical across the policies and
    the flash forward ran twice a layer and microbatch and the backward
    once. Returns each policy's ms (the mean of its two runs, and the runs),
    loss, peak (the larger of its two, less the reference copies held) and
    launches."""
    import torch

    from repro_torch.kernels.fused_optim import ops as optim_ops
    from repro_torch.models import LanguageModel
    from repro_torch.train import build_train_step
    from repro_torch.utils.tree import tree_leaves

    batch = trainer.pipeline.next_batch(16)
    batch = {k: v.reshape((4, 4) + tuple(v.shape[1:])) for k, v in batch.items()}
    leaves = tree_leaves(state.params)
    with torch.no_grad():
        start = [w.detach().clone() for w in leaves]
    held = sum(nbytes(w) for w in start)
    first = None
    out = {p: {"ms_runs": [], "peak_bytes": 0} for p in REMAT_POLICIES}
    expect = {"flash_attention_fwd": 2 * 4 * cfg.num_layers, "flash_attention_bwd": 4 * cfg.num_layers,
              "fused_psgd": 1}
    steps = {p: build_train_step(LanguageModel(cfg.replace(remat_policy=p)), optimizer, accum_steps=4)
             for p in REMAT_POLICIES}
    # two rounds, the second in reverse order, so that no policy always runs first
    for policy in REMAT_POLICIES + REMAT_POLICIES[::-1]:
        with torch.no_grad():
            for w, x in zip(leaves, start):
                w.copy_(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for ops in (optim_ops, sys.modules["repro_torch.kernels.flash_attention.ops"]):
            ops.reset_launches()
        t0 = time.perf_counter()
        _, metrics = steps[policy](state, batch, lr, 2)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - held
        launches = {**flash_launches(), "fused_psgd": optim_ops.LAUNCHES["fused_psgd"]}
        loss = metrics["loss"].item()
        if any(launches[k] != n for k, n in expect.items()):
            fail(f"phase 32 {policy}: launches {launches}, not {expect}")
        if first is None:
            with torch.no_grad():
                first = (loss, [w.detach().clone() for w in leaves])
            held += sum(nbytes(w) for w in first[1])
        elif loss != first[0] or not all(torch.equal(w, x) for w, x in zip(leaves, first[1])):
            fail(f"phase 32 {policy}: the loss ({loss!r} vs {first[0]!r}) or the params differ from "
                 f"{REMAT_POLICIES[0]}'s")
        rec = out[policy]
        rec["ms_runs"].append(ms)
        rec.update(ms=sum(rec["ms_runs"]) / len(rec["ms_runs"]), loss=loss, peak_bytes=max(rec["peak_bytes"], peak),
                   launches=launches)
    with torch.no_grad():  # leave the params as phase 9 left them
        for w, x in zip(leaves, start):
            w.copy_(x)
    return out


def remat_check(measured: dict, counted: dict, smi: str) -> dict:
    """Phase 32(b)'s report: each policy's update ms beside the roofline's
    compute and memory terms of the dry run's count of the same step on the
    (1, 1) mesh, and the card's peak against the count's. Fails where the
    peak is REMAT_PEAK_TOL or more from the count's."""
    from repro_torch.roofline.analysis import HW

    out = {}
    for policy, m in measured.items():
        predicted, dry_s = counted[policy]
        dry_peak = predicted["memory"]["peak_bytes_per_device"]
        compute_s = predicted["cost"]["flops"] / HW["peak_flops"]
        memory_s = predicted["cost"]["bytes_accessed"] / HW["hbm_bw"]
        rel = abs(m["peak_bytes"] - dry_peak) / dry_peak
        out[policy] = {**m, "dry_peak_bytes": dry_peak, "peak_rel_diff": rel, "flops": predicted["cost"]["flops"],
                       "bytes_accessed": predicted["cost"]["bytes_accessed"],
                       "activation_bytes": predicted["memory"]["activation_bytes_per_microbatch"],
                       "compute_s": compute_s, "memory_s": memory_s,
                       "share": max(compute_s, memory_s) * 1e3 / m["ms"], "dry_run_s": dry_s}
        print(f"phase 32(b) {policy}: update {m['ms']:.1f} ms (runs " + " / ".join(f"{x:.1f}" for x in m["ms_runs"])
              + f") | roofline compute {compute_s * 1e3:.1f} ms, memory "
              f"{memory_s * 1e3:.1f} ms, share {100 * out[policy]['share']:.1f}% | flops "
              f"{predicted['cost']['flops']:.6e} | peak {m['peak_bytes'] / 2**30:.2f} GiB vs dry run "
              f"{dry_peak / 2**30:.2f} GiB ({100 * rel:.1f}%) | activations a microbatch "
              f"{out[policy]['activation_bytes'] / 2**30:.2f} GiB | loss {m['loss']:.6f} | launches {m['launches']} "
              f"| counted in {dry_s:.1f} s | {smi}", flush=True)
        if rel >= REMAT_PEAK_TOL:
            fail(f"phase 32 {policy}: peak {m['peak_bytes']} B is {100 * rel:.1f}% from the dry run's {dry_peak} B")
    return out


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
    profile = device_profile(engine.run, submit_batch)
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
          f"idle {100 * profile['idle_share']:.1f}% | {profile['activities']} device activities | GLA kernels "
          f"{profile['gla_ms']:.2f} ms, sampler {profile['sampler_ms']:.3f} ms over {profile['sampler_launches']} "
          f"launches", flush=True)
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
    profile, untraced_ms, _ = trace_update("rwkv6 train", trainer, state, psgd, eta)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    agreement = card_cpu_agreement("rwkv6-1.6b")
    return {"layers": cfg.num_layers, "eta": eta, "losses": log.losses, "wall_s": wall,
            "peak_gib": peak / 2**30, "launches": launches, "stages": stages, "profile": profile,
            "untraced_update_ms": untraced_ms, "card_vs_cpu": agreement}


def dense_small_input_agreement(arch: str, smoke=None) -> None:
    """Greedy tokens of both dense engines on the card (the flash forward,
    the sampler) equal the CPU path's on ``arch`` smoke (or ``smoke``) in
    float32: the static batch (4 prompts of 8) and the continuous ring (2
    slots, prompts of 1 to 8 tokens)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.serve import ContinuousBatchingEngine, ServeEngine

    cfg = (smoke or get_config(arch, "smoke")).replace(compute_dtype="float32")
    model = LanguageModel(cfg)
    cpu_params = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    static_prompts = rng.integers(0, cfg.vocab_size, (4, 8))
    ring_prompts = [rng.integers(0, cfg.vocab_size, n) for n in (1, 5, 8, 3)]
    streams = {}
    for device in ("cpu", "cuda"):
        params = to_device(cpu_params, device)
        static = ServeEngine(model, params, cache_len=32, device=device).generate(static_prompts, 6)
        engine = ContinuousBatchingEngine(model, params, cache_len=32, max_slots=2, seed=0, device=device)
        ids = [engine.submit(p, max_new_tokens=6) for p in ring_prompts]
        out = engine.run()
        streams[device] = (static.tolist(), [out[i].tolist() for i in ids])
    if streams["cpu"] != streams["cuda"]:
        fail(f"{arch} dense greedy tokens differ: cpu {streams['cpu']} vs cuda {streams['cuda']}")


def serve_dense(cfg, model, params, prompts) -> dict:
    """Phase 12: the dense engines serving ``cfg`` at full width. The
    continuous engine (8 slots, cache 1,024) on phase 4's requests (8 x 512
    prompt tokens + 32 new, half greedy, half t=0.8, top_k=50), counters
    zeroed just before and read just after: the flash forward launches once
    a layer and prefill, the sampler once a tick and a first token, no paged
    kernel. Then the same batch traced on the device, the static engine on
    the 8 prompts (greedy), and both engines on the card against the CPU
    path on qwen2.5-3b and rwkv6-1.6b smoke."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_decode import ops as paged_ops
    from repro_torch.serve import ContinuousBatchingEngine, ServeEngine

    n, new, cache_len = len(prompts), 32, 1024
    engine = ContinuousBatchingEngine(model, params, max_slots=8, cache_len=cache_len, seed=0)

    def submit_batch():
        return [engine.submit(p, max_new_tokens=new, temperature=0.0 if i % 2 == 0 else 0.8,
                              top_k=0 if i % 2 == 0 else 50) for i, p in enumerate(prompts)]

    engine.submit(prompts[0][:64], max_new_tokens=4)  # warm-up
    engine.run()
    engine.reset_stats()
    ids = submit_batch()
    torch.cuda.synchronize()
    flash_ops.reset_launches()
    paged_ops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**flash_ops.LAUNCHES, **paged_ops.LAUNCHES}
    stats = copy.deepcopy(engine.stats)
    for rid in ids:
        gen_tokens = results[rid][len(prompts[0]):]
        if len(gen_tokens) != new or gen_tokens.min() < 0 or gen_tokens.max() >= cfg.vocab_size:
            fail(f"dense request {rid}: bad generated tokens {gen_tokens.tolist()}")
    expect = {"flash_attention_fwd": cfg.num_layers * n, "fused_sample": stats["ticks"] + n,
              "flash_attention_bwd": 0, "paged_flash_decode": 0, "paged_chunk_prefill": 0}
    for kname, count in expect.items():
        if launches[kname] != count:
            fail(f"dense serving: {kname} launched {launches[kname]} times, not {count}")
    profile = device_profile(engine.run, submit_batch)
    tick_ms = sorted(stats["decode_tick_s"])[len(stats["decode_tick_s"]) // 2] * 1e3

    static = ServeEngine(model, params, cache_len=cache_len)
    batch = np.stack(prompts)
    static.generate(batch[:1, :64], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    flash_ops.reset_launches()
    paged_ops.reset_launches()
    t0 = time.perf_counter()
    out = static.generate(batch, max_new_tokens=new)
    torch.cuda.synchronize()
    static_wall = time.perf_counter() - t0
    static_launches = {**flash_ops.LAUNCHES, **paged_ops.LAUNCHES}
    if static_launches["flash_attention_fwd"] != cfg.num_layers:
        fail(f"static serving: flash_attention_fwd launched {static_launches['flash_attention_fwd']} "
             f"times, not {cfg.num_layers} (one batched prefill)")
    if out.shape != (n, batch.shape[1] + new) or out.min() < 0 or out.max() >= cfg.vocab_size:
        fail(f"static serving: bad output of shape {out.shape}")
    # agreement of the greedy requests, reported only: random weights give
    # near-tied logits, and a batch-1 bf16 prefill is not bit-equal to a batch-8 one
    p = batch.shape[1]
    greedy = [i for i in range(n) if i % 2 == 0]
    agree = [float(np.mean(results[ids[i]][p:] == out[i][p:])) for i in greedy]
    first_agree = sum(int(results[ids[i]][p] == out[i][p]) for i in greedy)
    print(f"phase 12 dense continuous: {n} requests x {new} tokens in {wall:.3f} s | decode "
          f"{stats['decoded_tokens']} tokens = {stats['decoded_tokens'] / wall:.1f} tok/s | median tick "
          f"{tick_ms:.2f} ms | {stats['ticks']} ticks | launches {launches}", flush=True)
    print(f"phase 12 dense profile: device busy {profile['busy_ms']:.1f} ms of {profile['wall_ms']:.1f} ms "
          f"wall, idle {100 * profile['idle_share']:.1f}% | flash forward {profile['flash_fwd_ms']:.2f} ms "
          f"({100 * profile['flash_fwd_ms'] / profile['busy_ms']:.1f}% of busy), sampler "
          f"{profile['sampler_ms']:.3f} ms ({100 * profile['sampler_ms'] / profile['busy_ms']:.2f}%) over "
          f"{profile['sampler_launches']} launches", flush=True)
    for kname, (ms, count) in list(profile["by_kernel"].items())[:8]:
        print(f"phase 12 dense profile: {ms:9.2f} ms {count:6d} x  {kname[:100]}")
    print(f"phase 12 dense static: {n} x {p} greedy prompts + {new} tokens in {static_wall:.3f} s = "
          f"{n * new / static_wall:.1f} tok/s | launches {static_launches} | greedy tokens equal to the "
          f"continuous engine's: {agree} (first token {first_agree}/{len(greedy)}), not required",
          flush=True)
    for arch in ("qwen2.5-3b", "rwkv6-1.6b"):
        dense_small_input_agreement(arch)
    print("phase 12 dense small input: greedy tokens of both dense engines on the card equal the CPU "
          "path's on qwen2.5-3b and rwkv6-1.6b smoke (f32)", flush=True)
    return {"wall_s": wall, "decoded_tokens": stats["decoded_tokens"], "ticks": stats["ticks"],
            "median_decode_tick_ms": tick_ms, "launches": launches, "profile": profile,
            "static": {"wall_s": static_wall, "launches": static_launches},
            "greedy_agreement": agree, "first_token_agreement": first_agree}


def resume_full_width(cfg) -> dict:
    """Phase 13: kill and resume at full width (``cfg`` cut in depth) on
    phase 7's schedule with pSGD: an uninterrupted run; a run saving every 6
    updates and stopped after 8; a fresh trainer resuming from its
    checkpoint. Losses, stages and final params must be bit-identical to the
    uninterrupted run's. The checkpoints go to a temporary directory,
    removed after the phase."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_leaves

    class TimedCheckpointManager(CheckpointManager):
        """Times each disk write (in the writer thread)."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.write_s = []

        def _write_and_retain(self, path, arrays, meta):
            t0 = time.perf_counter()
            super()._write_and_retain(path, arrays, meta)
            self.write_s.append(time.perf_counter() - t0)

    kw = dict(eta=ETAS["psgd"], device="cuda", seq=512, b1=4, c1=16, stages=3)

    def spans(trainer, name):
        return [ev["dur"] for ev in trainer.tracer.events if ev.get("name") == name]

    def uninterrupted():
        log, wall, _, _, state, _ = run_sebs(cfg, make_optimizer("psgd", gamma=1e4), **kw)
        return log, wall, state

    ref_log, ref_wall, ref_state = uninterrupted()
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        with TimedCheckpointManager(directory, keep_last=2) as ckpt:
            killed_log, _, _, _, state, trainer = run_sebs(
                cfg, make_optimizer("psgd", gamma=1e4), checkpointer=ckpt, save_every=6,
                stop_after_updates=8, **kw)
            saves = spans(trainer, "train.save")
            del state, trainer
            gc.collect()
            torch.cuda.empty_cache()
        with TimedCheckpointManager(directory, keep_last=2) as ckpt2:
            log, wall, launches, _, state, trainer = run_sebs(
                cfg, make_optimizer("psgd", gamma=1e4), checkpointer=ckpt2, save_every=6, resume=True, **kw)
            restores, saves2 = spans(trainer, "train.restore"), spans(trainer, "train.save")
        write_s = ckpt.write_s + ckpt2.write_s
        size = sum(f.stat().st_size for f in Path(directory).rglob("*") if f.is_file())
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    same_params = all(torch.equal(a, b) for a, b in zip(tree_leaves(ref_state.params), tree_leaves(state.params)))
    if killed_log.steps != list(range(1, 9)) or log.steps != ref_log.steps:
        fail(f"resume: updates {killed_log.steps} then {log.steps}, not 1..8 then {ref_log.steps}")
    if log.losses != ref_log.losses or log.stages != ref_log.stages or not same_params:
        del state, trainer
        again_log, _, again_state = uninterrupted()
        twice = again_log.losses == ref_log.losses and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(ref_state.params), tree_leaves(again_state.params)))
        fail(f"resume: the resumed run is not bit-identical to the uninterrupted one (losses {log.losses} "
             f"vs {ref_log.losses}, params equal {same_params}); two uninterrupted runs agree: {twice}")
    print(f"phase 13 resume: {cfg.num_layers} layers, {len(ref_log.steps)} updates, killed after 8 (saved at "
          f"6), resumed: losses, stages and params bit-identical | uninterrupted {ref_wall:.1f} s, resumed "
          f"{wall:.1f} s | checkpoint {size / 1e9:.2f} GB on disk (retained) | device->host copy "
          + ", ".join(f"{x:.2f}" for x in saves + saves2) + " s a save | write "
          + ", ".join(f"{x:.2f}" for x in write_s) + " s | restore "
          + ", ".join(f"{x:.2f}" for x in restores) + f" s | resumed launches {launches}", flush=True)
    return {"layers": cfg.num_layers, "losses": log.losses, "save_copy_s": saves + saves2,
            "write_s": write_s, "restore_s": restores, "bytes_on_disk": size, "wall_s": wall,
            "uninterrupted_wall_s": ref_wall, "launches": launches}


ADAPTIVE_RTOL = 1e-4


def adaptive_optimizers(cfg) -> dict:
    """Phase 14: AdamW, LARS and LAMB (plain PyTorch updates) each take 4
    SEBS updates (batch 4, 4, 8, 8) at full width on ``cfg`` (cut in
    depth); losses must be finite. On qwen2.5-3b smoke in float32 the
    card's losses are within 1e-4 relative of the CPU path's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_map

    smoke = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    base = LanguageModel(smoke).init(seed=0, device="cpu")
    out = {}
    for name in ("adamw", "lars", "lamb"):
        eta = ETAS[name]
        log, wall, launches, _, state, _ = run_sebs(cfg, make_optimizer(name), eta=eta, device="cuda",
                                                    seq=512, b1=4, c1=8, stages=2)
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in log.losses):
            fail(f"{name}: a loss is not finite: {log.losses}")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        losses = {device: run_sebs(smoke, make_optimizer(name), eta=eta, device=device, seq=32, b1=4, c1=8,
                                   stages=2, params=tree_map(lambda x: x.to(device, copy=True), base))[0].losses
                  for device in ("cpu", "cuda")}
        worst = max(abs(a - b) / abs(a) for a, b in zip(losses["cpu"], losses["cuda"]))
        if worst > ADAPTIVE_RTOL:
            fail(f"{name}: card and CPU losses differ by {worst:.2e} relative: {losses}")
        print(f"phase 14 {name}: {cfg.num_layers} layers, eta {eta}, {len(log.steps)} updates in {wall:.1f} s | "
              f"losses " + " ".join(f"{x:.4f}" for x in log.losses) + f" | peak memory {peak / 2**30:.1f} GiB "
              f"| smoke f32 card vs cpu within {worst:.2e} relative | launches {launches}", flush=True)
        out[name] = {"eta": eta, "losses": log.losses, "wall_s": wall, "peak_gib": peak / 2**30,
                     "card_vs_cpu_max_rel": worst, "smoke_losses": losses}
    return out


# zamba2-2.7b's shapes: the shared attention's 32 heads of 80 (G 1), Mamba2's
# 80 heads of K = V = 64 (d_in 5,120 / ssm_head_dim 64), and the smoke config
# that the card-against-CPU checks run, its ssm_state raised from 16 to the
# GLA kernels' K = 64
ZAMBA2_HEADS, ZAMBA2_HEAD_DIM, MAMBA2_HEADS = 32, 80, 80


def zamba2_smoke():
    from repro_torch.configs import get_config

    return get_config("zamba2-2.7b", "smoke").replace(ssm_state=64)


def paged_shape_checks(records: dict, suffix: str, hq: int, hkv: int, d: int, seed: int,
                       prefix_pages: int = 0, lengths=None, chunk: int = 256) -> None:
    """The paged kernels at one model's attention shape (pages of 16):
    decode at the serving shape (8 slots of ``lengths`` tokens, 544 each by
    default, the first ``prefix_pages`` pages shared by every slot), the
    same bits twice, and a chunk prefill of ``chunk`` tokens at pos_start 0
    and ``chunk``, each against its plain version with the last visible key
    dropped as the planted fault. Into ``records["paged_flash_decode" +
    suffix]`` and ``records["paged_chunk_prefill" + suffix]``."""
    import torch

    from repro_torch.kernels.paged_decode import ops, ref

    label = suffix.lstrip("_").upper()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, ps, pages = 8, 16, 1025
    lengths = lengths or [544] * b
    k, v, table = paged_pool(gen, pages=pages, ps=ps, hkv=hkv, d=d, lengths=lengths, prefix_pages=prefix_pages)
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32, device="cuda")
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
    out = ops.paged_flash_decode(q, k, v, table, pos)
    readings = [check_close(f"paged_flash_decode ({label}, serving shape)", out,
                            ref.paged_attention_ref(q, k, v, table, pos),
                            ref.paged_attention_ref(q, k, v, table, pos - 1))]
    if not torch.equal(out, ops.paged_flash_decode(q, k, v, table, pos)):
        fail(f"paged_flash_decode ({label}): two runs on the same inputs differ")
    sets = [(q.clone(), k.clone(), v.clone(), table, pos) for _ in range(copies_for(nbytes(q, k, v)))]
    io = nbytes(q) * 2 + nbytes(table, pos)
    kv = kv_bytes_read(table, pos, ps, hkv, d, 2)
    records["paged_flash_decode" + suffix] = dict(
        **merge(readings),
        ms=timed(ops.paged_flash_decode, sets, 200),
        device_ms=device_ms(ops.paged_flash_decode, sets, 50),
        plain_ms=timed(ref.paged_attention_ref, sets, 20),
        bound=bound(io + kv, 4 * hq * d * sum(lengths), BF16_FLOPS),
        library_ms=None,
    )
    del k, v, sets
    c = chunk
    k, v, table = paged_pool(gen, pages=pages, ps=ps, hkv=hkv, d=d, lengths=[2 * c])
    q = torch.randn((1, c, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
    readings = []
    for start in (0, c):
        ps_t = torch.tensor([start], dtype=torch.int32, device="cuda")
        fault = ref.paged_prefill_ref(q, k, v, table, ps_t - 1) if start else None
        readings.append(check_close(f"paged_chunk_prefill ({label}, pos_start {start})",
                                    ops.paged_chunk_prefill(q, k, v, table, ps_t),
                                    ref.paged_prefill_ref(q, k, v, table, ps_t), fault))
    ps_t = torch.tensor([c], dtype=torch.int32, device="cuda")
    sets = [(q.clone(), k.clone(), v.clone(), table, ps_t) for _ in range(copies_for(nbytes(q, k, v)))]
    visible = sum(c + i + 1 for i in range(c))
    io = nbytes(q) * 2 + nbytes(table, ps_t)
    kv = kv_bytes_read(table, ps_t + c - 1, ps, hkv, d, 2)
    records["paged_chunk_prefill" + suffix] = dict(
        **merge(readings),
        ms=timed(ops.paged_chunk_prefill, sets, 50),
        device_ms=device_ms(ops.paged_chunk_prefill, sets, 20),
        plain_ms=timed(ref.paged_prefill_ref, sets, 10),
        bound=bound(io + kv, 4 * hq * d * visible, BF16_FLOPS),
        library_ms=None,
    )


def mamba2_gla_inputs(gen, b: int, s: int, steep: float = 1.0):
    """GLA's operands as Mamba2 makes them at zamba2-2.7b's width, bf16 with
    f32 log_w: q = C and k = B (B, S, 64) shared by the 80 heads, v = dt x,
    log_w = -softplus(dt) exp(A_log) on every k channel with A_log =
    log(linspace(1, 16, 80)) as initialized (``steep`` multiplies it) and
    dt_bias 0; and a gradient dy."""
    import torch
    import torch.nn.functional as F

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    h = MAMBA2_HEADS
    dtp = F.softplus(rand(b, s, h))
    a = torch.linspace(1.0, 16.0, h, device="cuda") * steep
    lw = (-dtp * a)[..., None].expand(b, s, h, 64).contiguous()
    q, k = (rand(b, s, 1, 64).expand(b, s, h, 64).to(torch.bfloat16).contiguous() for _ in range(2))
    v = (rand(b, s, h, 64) * dtp[..., None]).to(torch.bfloat16)
    return q, k, v, lw, rand(b, s, h, 64).to(torch.bfloat16)


def mamba2_gla_checks(records: dict) -> None:
    """The GLA kernels with the current token included (Mamba2's route) at
    zamba2-2.7b's decays, against the plain recurrence, within GLA_TOL: the
    forward and backward at the training shape (microbatch 4 of 513 tokens,
    80 heads), there again at a steeper planted decay (A x 8, a chunk's log
    decay past -1e4); the forward at the paged engine's prefill chunk (B 1,
    S 256, from the state a previous chunk left) and at the static engine's
    prefill (B 8, S 512, from a zeroed state). Planted faults: the current
    token's term q_t . (k_t v_t) left out of y, dq, dk and dv; each chunk's
    total decay term left out of dlog_w; the initial state dropped (prefill
    chunk). Into ``records["gla_fwd_mamba2"]`` and
    ``records["gla_bwd_mamba2"]``, with the bound of the same work counted
    from Mamba2's own operands (C, B and dt, before their broadcast over
    heads and K) beside the kernels'."""
    import torch

    from repro_torch.kernels.gla import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(12)
    fwd, bwd = [], []

    def without_current(q, k, v, expect_y):
        """y with the current token's term q_t . (k_t v_t) left out."""
        return expect_y.float() - (q.float() * k.float()).sum(-1, keepdim=True) * v.float()

    for steep, tag in ((1.0, ""), (8.0, ", steep decay")):
        q, k, v, lw, dy = mamba2_gla_inputs(gen, 4, 513, steep)
        y, final, states = ops.forward(q, k, v, lw, include_current=True, save_states=True)
        expect_y, expect_final = ref.gla_fwd_ref(q, k, v, lw, include_current=True)
        fwd.append(check_scaled(f"gla_fwd y (Mamba2, B 4, S 513, H 80{tag})", y, expect_y, "y",
                                without_current(q, k, v, expect_y)))
        fwd.append(check_scaled(f"gla_fwd final state (Mamba2{tag})", final, expect_final, "float32"))
        grads = ops.backward(q, k, v, lw, None, None, states, final, dy, None, include_current=True)
        expect = ref.gla_bwd_ref(q, k, v, lw, None, None, dy, None, include_current=True)
        again = ops.backward(q, k, v, lw, None, None, states, final, dy, None, include_current=True)
        if not all(torch.equal(x, y_) for x, y_ in zip(grads, again) if x is not None):
            fail(f"gla_bwd (Mamba2{tag}): two runs on the same inputs differ")
        qk = (q.float() * k.float()).sum(-1, keepdim=True)
        dyv = (dy.float() * v.float()).sum(-1, keepdim=True)
        faults = {"dq": expect[0].float() - k.float() * dyv, "dk": expect[1].float() - q.float() * dyv,
                  "dv": expect[2].float() - qk * dy.float(),
                  "dlog_w": dlog_w_without_chunk_totals(q, k, v, lw, None, dy, expect[3], include_current=True)}
        for name, g, e in zip(("dq", "dk", "dv", "dlog_w"), grads, expect):
            tol = "grad" if g.dtype == torch.bfloat16 else "float32"
            bwd.append(check_scaled(f"gla_bwd {name} (Mamba2{tag})", g, e, tol, faults[name]))
        if steep != 1.0:
            continue
        sets = [(q.clone(), k.clone(), v.clone(), lw.clone()) for _ in range(copies_for(nbytes(q, k, v, lw)))]
        bwd_sets = [(*x, None, None, states.clone(), final.clone(), dy.clone(), None) for x in sets]
        b, s, h = q.shape[:3]
        # Mamba2's own operands: C and B (B, S, 64) bf16 and dt (B, S, H) f32,
        # which the layer broadcasts over heads and K into q, k and log_w
        own = 2 * nbytes(q[:, :, 0]) + 4 * b * s * h
        fwd_ops, bwd_ops = b * h * gla_products(s, backward=False), b * h * gla_products(s, backward=True)
        records["gla_fwd_mamba2"] = dict(
            ms=timed(lambda *a: ops.forward(*a, include_current=True, save_states=True), sets, 50),
            device_ms=device_ms(lambda *a: ops.forward(*a, include_current=True, save_states=True), sets, 20),
            plain_ms=timed(lambda *a: ref.gla_fwd_ref(*a, include_current=True), sets, 2),
            # reads q, k, v and log_w; writes y and the final state
            bound=bound(nbytes(q, k, v, lw) + nbytes(v) + 4 * b * h * 64 * 64, fwd_ops, BF16_FLOPS),
            bound_own_operands=bound(own + nbytes(v) * 2 + 4 * b * h * 64 * 64, fwd_ops, BF16_FLOPS),
            library_ms=None,
        )
        records["gla_bwd_mamba2"] = dict(
            ms=timed(lambda *a: ops.backward(*a, include_current=True), bwd_sets, 20),
            device_ms=device_ms(lambda *a: ops.backward(*a, include_current=True), bwd_sets, 10),
            plain_ms=timed(lambda *a: ref.gla_bwd_ref(*a[:6], a[8], a[9], include_current=True), bwd_sets, 1),
            # reads q, k, v, dy and log_w; writes dq, dk, dv and dlog_w
            bound=bound(nbytes(q, k, v, dy, lw) + nbytes(q, k, v, lw), bwd_ops, BF16_FLOPS),
            # reads C, B, dt, v and dy; writes their gradients
            bound_own_operands=bound(2 * own + nbytes(v, dy) + nbytes(v), bwd_ops, BF16_FLOPS),
            library_ms=None,
        )
        del sets, bwd_sets
    del q, k, v, lw, dy, y, final, states, grads, again, expect, faults
    # the paged engine's prefill chunk (phase 15): 256 tokens of one request
    # from the state its previous chunk left in the slot
    q, k, v, lw, _ = mamba2_gla_inputs(gen, 1, 256)
    s0 = ref.gla_fwd_ref(*mamba2_gla_inputs(gen, 1, 256)[:4], include_current=True)[1]
    y, final, _ = ops.forward(q, k, v, lw, None, s0, include_current=True)
    expect_y, expect_final = ref.gla_fwd_ref(q, k, v, lw, include_current=True, initial_state=s0)
    dropped = ref.gla_fwd_ref(q, k, v, lw, include_current=True)[0]
    fwd.append(check_scaled("gla_fwd y (Mamba2, B 1, S 256, initial state)", y, expect_y, "y", dropped))
    fwd.append(check_scaled("gla_fwd final state (Mamba2, B 1, S 256)", final, expect_final, "float32"))
    sets = [(q.clone(), k.clone(), v.clone(), lw.clone(), None, s0.clone())
            for _ in range(copies_for(nbytes(q, k, v, lw, s0)))]
    b, s, h = q.shape[:3]
    records["gla_fwd_mamba2"]["serving_chunk"] = dict(
        ms=timed(lambda *a: ops.forward(*a, include_current=True), sets, 100),
        device_ms=device_ms(lambda *a: ops.forward(*a, include_current=True), sets, 20),
        # reads q, k, v, log_w and the state; writes y and the state
        bound=bound(nbytes(q, k, v, lw, s0) + nbytes(v, s0), b * h * gla_products(s, backward=False),
                    BF16_FLOPS),
    )
    del q, k, v, lw, s0, y, final, sets
    # the static engine's prefill (phase 15): 8 prompts of 512 tokens from a zeroed cache
    q, k, v, lw, _ = mamba2_gla_inputs(gen, 8, 512)
    s0 = torch.zeros((8, MAMBA2_HEADS, 64, 64), device="cuda")
    expect_y = ref.gla_fwd_ref(q, k, v, lw, include_current=True, initial_state=s0)[0]
    fwd.append(check_scaled("gla_fwd y (Mamba2, B 8, S 512)",
                            ops.forward(q, k, v, lw, None, s0, include_current=True)[0], expect_y, "y",
                            without_current(q, k, v, expect_y)))
    records["gla_fwd_mamba2"].update(merge(fwd))
    records["gla_bwd_mamba2"].update(merge(bwd))


def zamba2_kernel_checks(records: dict) -> None:
    """Phase 3 at zamba2-2.7b's shapes: the flash kernels at D 80 (B 4,
    S 513, 32/32 heads; the forward also at the static engine's prefill,
    B 8 of 512 tokens), the paged kernels at D 80, GLA as Mamba2 runs it."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(10)
    flash_shape(records, gen, 4, 513, ZAMBA2_HEADS, ZAMBA2_HEADS, ZAMBA2_HEAD_DIM, suffix="_d80")
    flash_serving_prefills(records, "flash_attention_fwd_d80", gen, (8,), ZAMBA2_HEADS, ZAMBA2_HEADS,
                           ZAMBA2_HEAD_DIM)
    # zamba2's shared attention: G 1, 32 kv heads of 80, no shared prefix
    # (prefix sharing is off for zamba2)
    paged_shape_checks(records, "_d80", ZAMBA2_HEADS, ZAMBA2_HEADS, ZAMBA2_HEAD_DIM, seed=11)
    mamba2_gla_checks(records)


def serve_zamba2(cfg, keep: dict) -> dict:
    """Phase 15: the paged engine serving zamba2-2.7b at full width on phase
    4's traffic (8 slots, cache 2048, pages of 16, 256-token chunks; 8
    requests of 512 prompt tokens, the first 256 shared, and 32 new, half
    greedy, half t=0.8, top_k=50), counters zeroed just before and read just
    after. Prefix sharing is off for a hybrid model, so nothing is reused;
    every chunk launches the GLA forward once a Mamba2 layer (54) and the
    chunk prefill once a shared-attention application (9), every tick the
    decode 9 times and the sampler once. Then the same batch traced on the
    device; the static engine on the 8 prompts (greedy: one batched prefill,
    the flash forward at D 80 9 times and the GLA forward 54 times); and on
    zamba2 smoke (ssm_state 64) in float32 the greedy tokens of the paged and
    both dense engines on the card equal the CPU path's. ``keep`` takes the
    warm-up prompt, the measured prompts, their greedy streams and the TTFT
    p50, which phase 29 compares with."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gla import ops as gla_ops
    from repro_torch.kernels.paged_decode import ops as paged_ops
    from repro_torch.models import LanguageModel
    from repro_torch.serve import PagedContinuousBatchingEngine, ServeEngine
    from repro_torch.utils.tree import tree_leaves

    shared = sum(seg.repeat for seg in cfg.segments if seg.shared_attn)
    model = LanguageModel(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: {cfg.name} full, {sum(w.numel() for w in tree_leaves(params))} params ({cfg.param_dtype}, "
          f"compute {cfg.compute_dtype}) in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    engine = PagedContinuousBatchingEngine(
        model, params, max_slots=8, page_size=16, cache_len=2048, prefill_chunks=(256,), seed=0,
    )
    rng = torch.Generator().manual_seed(9)
    prefix = torch.randint(0, cfg.vocab_size, (256,), generator=rng)
    prompts = []

    def submit_batch():
        prompts.append([torch.cat([prefix, torch.randint(0, cfg.vocab_size, (256,), generator=rng)]).numpy()
                        for _ in range(8)])
        return [engine.submit(p, max_new_tokens=32, temperature=0.0 if i % 2 == 0 else 0.8,
                              top_k=0 if i % 2 == 0 else 50) for i, p in enumerate(prompts[-1])]

    engine.submit(prefix.numpy(), max_new_tokens=4)  # warm-up
    engine.run()
    engine.reset_stats()
    ids = submit_batch()
    torch.cuda.synchronize()
    for ops in (paged_ops, gla_ops, flash_ops):
        ops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**paged_ops.LAUNCHES, **gla_ops.LAUNCHES, **flash_ops.LAUNCHES}
    for rid in ids:
        gen_tokens = results[rid][512:]
        if len(gen_tokens) != 32 or gen_tokens.min() < 0 or gen_tokens.max() >= cfg.vocab_size:
            fail(f"zamba2 request {rid}: bad generated tokens {gen_tokens.tolist()}")
    engine.pool.check()
    stats, mem = copy.deepcopy(engine.stats), engine.memory_stats()
    keep.update(warmup=prefix.numpy(), prompts=prompts[0], prefix=prefix,
                greedy=[results[rid] for rid in ids[::2]],
                ttft_ms=sorted(engine.scheduler.requests[rid].ttft_s for rid in ids)[len(ids) // 2] * 1e3)
    if engine.prefix_sharing or stats["prefix_tokens_reused"] != 0:
        fail("zamba2: prefix sharing must be off for a hybrid model")
    expect = {"gla_fwd": cfg.num_layers * stats["prefill_chunks"],
              "paged_chunk_prefill": shared * stats["prefill_chunks"],
              "paged_flash_decode": shared * stats["ticks"], "fused_sample": stats["ticks"] + len(ids),
              "flash_attention_fwd": 0, "flash_attention_bwd": 0, "gla_bwd": 0}
    for kname, n in expect.items():
        if launches[kname] != n:
            fail(f"zamba2 serving: {kname} launched {launches[kname]} times, not {n}")
    with torch.inference_mode():
        probe, _ = model.decode_step(
            params, torch.zeros((1, 1), dtype=torch.int32, device="cuda"),
            model.paged_state_slice(engine.cache, 1), torch.zeros((1,), dtype=torch.int32, device="cuda"),
            torch.zeros((1, engine.max_pages), dtype=torch.int32, device="cuda"),
        )
    if probe.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(probe).all():
        fail("zamba2: full-width decode logits are not finite")
    profile = device_profile(engine.run, submit_batch)
    engine.pool.check()
    tick_ms = sorted(stats["decode_tick_s"])[len(stats["decode_tick_s"]) // 2] * 1e3
    print(
        f"phase 15 zamba2 paged: {len(ids)} requests x 32 tokens in {wall:.3f} s | decode "
        f"{stats['decoded_tokens']} tokens = {stats['decoded_tokens'] / wall:.1f} tok/s | median decode tick "
        f"{tick_ms:.2f} ms | {stats['ticks']} ticks, {stats['prefill_chunks']} chunks | prefix reused "
        f"{stats['prefix_tokens_reused']} | kv bytes a page {model.paged_kv_bytes_per_page(16)}, peak "
        f"{mem['kv_bytes_peak']} | peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | "
        f"launches {launches}", flush=True)
    print(f"phase 15 zamba2 profile: device busy {profile['busy_ms']:.1f} ms of {profile['wall_ms']:.1f} ms "
          f"wall, idle {100 * profile['idle_share']:.1f}% | GLA kernels {profile['gla_ms']:.2f} ms, paged decode "
          f"{profile['paged_decode_ms']:.2f} ms, prefill {profile['paged_prefill_ms']:.2f} ms, sampler "
          f"{profile['sampler_ms']:.3f} ms over {profile['sampler_launches']} launches", flush=True)
    for kname, (ms, n) in list(profile["by_kernel"].items())[:8]:
        print(f"phase 15 zamba2 profile: {ms:9.2f} ms {n:6d} x  {kname[:100]}")
    del engine, results, probe
    gc.collect()
    torch.cuda.empty_cache()

    static = ServeEngine(model, params, cache_len=1024)
    batch = np.stack(prompts[0])
    static.generate(batch[:1, :64], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    for ops in (paged_ops, gla_ops, flash_ops):
        ops.reset_launches()
    t0 = time.perf_counter()
    out = static.generate(batch, max_new_tokens=32)
    torch.cuda.synchronize()
    static_wall = time.perf_counter() - t0
    static_launches = {**paged_ops.LAUNCHES, **gla_ops.LAUNCHES, **flash_ops.LAUNCHES}
    for kname, n in (("flash_attention_fwd", shared), ("gla_fwd", cfg.num_layers), ("paged_flash_decode", 0)):
        if static_launches[kname] != n:
            fail(f"zamba2 static serving: {kname} launched {static_launches[kname]} times, not {n} "
                 f"(one batched prefill)")
    if out.shape != (8, 512 + 32) or out.min() < 0 or out.max() >= cfg.vocab_size:
        fail(f"zamba2 static serving: bad output of shape {out.shape}")
    print(f"phase 15 zamba2 static: 8 x 512 greedy prompts + 32 tokens in {static_wall:.3f} s = "
          f"{8 * 32 / static_wall:.1f} tok/s | launches {static_launches}", flush=True)
    del static, params
    gc.collect()
    torch.cuda.empty_cache()
    small = zamba2_smoke()
    small_input_agreement("zamba2-2.7b", small)
    dense_small_input_agreement("zamba2-2.7b", small)
    print("phase 15 zamba2 small input: greedy tokens of the paged and both dense engines on the card "
          "equal the CPU path's on zamba2 smoke (ssm_state 64, f32)", flush=True)
    return {"wall_s": wall, "decoded_tokens": stats["decoded_tokens"], "ticks": stats["ticks"],
            "prefill_chunks": stats["prefill_chunks"], "median_decode_tick_ms": tick_ms,
            "kv_bytes_per_page": model.paged_kv_bytes_per_page(16), "launches": launches,
            "profile": profile, "static": {"wall_s": static_wall, "launches": static_launches}}


def train_zamba2(cfg) -> dict:
    """Phase 16: SEBSTrainer with pSGD on zamba2-2.7b at full width, on phase
    7's schedule (12 updates at batch 4, 8, 16 by 1, 2 and 4 microbatches of
    4 x 513 tokens), counters zeroed just before and read just after: the
    GLA forward runs twice a Mamba2 layer and microbatch (remat) and its
    backward once, the flash forward twice a shared-attention application
    and its backward once. Then one stage-2 update traced on the device, and
    the card's losses against the CPU path's on zamba2 smoke (ssm_state 64)."""
    import torch

    from repro_torch.optim import make_optimizer

    seq, b1 = 512, 4
    shared = sum(seg.repeat for seg in cfg.segments if seg.shared_attn)
    psgd = make_optimizer("psgd", gamma=1e4)
    eta = ETAS["zamba2_psgd"]
    log, wall, launches, updates, state, trainer = run_sebs(
        cfg, psgd, eta=eta, device="cuda", seq=seq, b1=b1, c1=16, stages=3)
    peak = torch.cuda.max_memory_allocated()
    check_training("zamba2 psgd, full width", log, launches,
                   ("gla_fwd", "gla_bwd", "flash_attention_fwd", "flash_attention_bwd", "fused_psgd"))
    micro = sum(bs // b1 for bs in log.batch_sizes)
    expect = {"gla_fwd": cfg.num_layers * 2 * micro, "gla_bwd": cfg.num_layers * micro,
              "flash_attention_fwd": shared * 2 * micro, "flash_attention_bwd": shared * micro,
              "fused_psgd": len(log.steps)}
    for kname, n in expect.items():
        if launches[kname] != n:
            fail(f"zamba2 training: {kname} launched {launches[kname]} times, not {n}")
    stages = stage_table(log, updates, seq)
    print_training("zamba2 psgd", log, wall, peak, launches, stages, seq)
    profile, untraced_ms, _ = trace_update("zamba2 train", trainer, state, psgd, eta)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    agreement = card_cpu_agreement("zamba2-2.7b", zamba2_smoke())
    return {"layers": cfg.num_layers, "eta": eta, "losses": log.losses, "wall_s": wall,
            "peak_gib": peak / 2**30, "launches": launches, "stages": stages, "profile": profile,
            "untraced_update_ms": untraced_ms, "card_vs_cpu": agreement}


def train_gemma2(cfg) -> dict:
    """Phase 17: SEBSTrainer with pSGD on gemma2-9b at full width cut to
    ``cfg``'s depth, on phase 7's schedule: the soft-capped attention runs
    the plain ``_sdpa`` route as in the JAX package (no flash launch), the
    fused pSGD once an update. Then the card's losses against the CPU
    path's on gemma2 smoke, and the greedy tokens of the paged engine (the
    paged kernels with the soft-cap, G 2, D 64) and of both dense engines
    there."""
    import torch

    from repro_torch.optim import make_optimizer

    seq, b1 = 512, 4
    psgd = make_optimizer("psgd", gamma=1e4)
    eta = ETAS["gemma2_psgd"]
    log, wall, launches, updates, state, _ = run_sebs(
        cfg, psgd, eta=eta, device="cuda", seq=seq, b1=b1, c1=16, stages=3)
    peak = torch.cuda.max_memory_allocated()
    check_training("gemma2 psgd", log, launches, ("fused_psgd",))
    for kname in ("flash_attention_fwd", "flash_attention_bwd"):
        if launches[kname] != 0:
            fail(f"gemma2 training: {kname} launched {launches[kname]} times: the soft-capped attention "
                 "takes _sdpa")
    stages = stage_table(log, updates, seq)
    print_training(f"gemma2 psgd, {cfg.num_layers} layers", log, wall, peak, launches, stages, seq)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    agreement = card_cpu_agreement("gemma2-9b")
    small_input_agreement("gemma2-9b")
    dense_small_input_agreement("gemma2-9b")
    print("phase 17 gemma2 small input: greedy tokens of the paged and both dense engines on the card "
          "equal the CPU path's on gemma2 smoke (f32)", flush=True)
    return {"layers": cfg.num_layers, "params": cfg.param_counts()["total"], "eta": eta,
            "losses": log.losses, "wall_s": wall, "peak_gib": peak / 2**30, "launches": launches,
            "stages": stages, "card_vs_cpu": agreement}


# The MoE family (phases 18-20). dbrx-132b: 48 query heads over 8 kv heads of
# 128 (G 6), 16 experts top-4, vocabulary 100,352; arctic-480b: 56 over 8
# (G 7), 128 experts top-2 beside a dense residual MLP, vocabulary 32,000.
# Neither fits one card at full width in f32: dbrx is served at 4 of its 40
# layers (13.65 B parameters, 54.6 GB) and trained at 1 (3.88 B: the
# weights, pSGD's anchor, the gradient sum and the bf16 expert copies),
# arctic is served at 1 of its 35 (13.8 B, 55.4 GB; one expert tensor is
# 4.46 B elements).
MOE_SHAPES = {"dbrx-132b": (48, 8, 128), "arctic-480b": (56, 8, 128)}
MOE_LAYERS = {"dbrx_serving": 4, "dbrx_training": 1, "arctic_serving": 1}


def moe_cut(arch: str, layers: int):
    from repro_torch.configs import get_config

    cfg = get_config(arch, "full")
    return cfg.replace(segments=(dataclasses.replace(cfg.segments[0], repeat=layers),))


def flash_forward_reading(records: dict, name: str, gen, b: int, s: int, hq: int, hkv: int, d: int) -> None:
    """The flash forward alone at one shape (bf16, causal) against its plain
    version, each query's last visible key dropped as the planted fault;
    L2-cold, device and plain times, the bound and SDPA's (flash backend
    where it takes GQA, else memory-efficient). Into ``records[name]``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops, ref

    q, k, v = flash_inputs(gen, b, s, hq, hkv, d)
    out, _ = ops.forward(q, k, v)
    reading = check_close(name, out, ref.attention_fwd_ref(q, k, v)[0], ref.attention_ref(q, k[:, :-1], v[:, :-1]))
    sets = [(q.clone(), k.clone(), v.clone()) for _ in range(copies_for(nbytes(q, k, v)))]
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in x) for x in sets]

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(q_, k_, v_, is_causal=True, enable_gqa=True)

    backend = SDPBackend.FLASH_ATTENTION
    try:
        with sdpa_kernel(backend):
            sdpa(*lib_sets[0])
    except RuntimeError:
        backend = SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel(backend):
        library_ms = timed(sdpa, lib_sets, 50)
    records[name] = dict(
        **reading,
        ms=timed(ops.forward, sets, 50),
        device_ms=device_ms(ops.forward, sets, 20),
        plain_ms=timed(ref.attention_fwd_ref, sets, 5),
        bound=cost_bound(ops.cost(q, k, v), BF16_FLOPS),
        library_ms=library_ms, library_backend=backend.name,
    )


def moe_kernel_checks(records: dict) -> None:
    """Phase 3 at the MoE family's shapes: the flash forward and backward at
    dbrx's training shape (B 4, S 513, 48/8 heads: G 6), its forward also
    at dbrx's dense prefills (B 1 and B 8 of 512) and at arctic's static
    prefill (B 8, S 512, 56/8: G 7); the paged decode and chunk prefill at G
    6 and G 7 (8 slots of 544 sharing a 256-token prefix); the sampler's
    tokens at 8 rows of 100,352 and of 32,000; the fused pSGD bit for bit
    over one dbrx layer's three expert tensors (1.06 B elements each)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(12)
    hq, hkv, d = MOE_SHAPES["dbrx-132b"]
    flash_shape(records, gen, 4, 513, hq, hkv, d, suffix="_g6")
    flash_serving_prefills(records, "flash_attention_fwd_g6", gen, (1, 8), hq, hkv, d)
    hq7, hkv7, d7 = MOE_SHAPES["arctic-480b"]
    flash_forward_reading(records, "flash_attention_fwd_g7", gen, 8, 512, hq7, hkv7, d7)
    paged_shape_checks(records, "_g6", hq, hkv, d, seed=13, prefix_pages=16)
    paged_shape_checks(records, "_g7", hq7, hkv7, d7, seed=14, prefix_pages=16)
    for name, vocab in (("fused_sample_v100352", 100352), ("fused_sample_v32000", 32000)):
        records[name] = sampler_reading(name, gen, 8, vocab)
    cfg = moe_cut("dbrx-132b", 1)
    experts = [(cfg.num_experts, cfg.d_model, cfg.d_ff)] * 2 + [(cfg.num_experts, cfg.d_ff, cfg.d_model)]
    fused_checks(records, {"fused_psgd_dbrx": experts})


def moe_breakdown(layer, x, cfg) -> dict:
    """Device ms of each step of the MoE layer (models/layers/moe.py
    ``apply``, its steps in its order) on ``layer``'s weights at ``x``'s
    shape: the router (logits, softmax), the dispatch and combine tensors,
    the dispatch product, the bf16 casts of the three expert tensors (each
    released after its product), the expert products with the SwiGLU, the
    combine product. Events between the steps, all enqueued behind a device
    sleep, so no host gap falls between them; the output must equal
    ``moe.apply``'s bit for bit."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.layers import moe

    b, s, d = x.shape
    gs = min(moe.GROUP_SIZE, s)
    n, capacity, dt = s // gs, moe.capacity_of(cfg, gs), x.dtype
    with torch.inference_mode():
        expect, _ = moe.apply(layer, x, cfg)
        torch.cuda.synchronize()
        marks = []

        def mark(label):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            marks.append((label, event))

        torch.cuda._sleep(200_000_000)  # ~0.1 s: the host enqueues every step meanwhile
        mark("start")
        xg = x.reshape(b, n, gs, d)
        probs = torch.softmax(torch.einsum("bngd,de->bnge", xg.float(), layer["router"]), dim=-1)
        mark("router")
        disp, combine = moe.dispatch_tensors(probs, cfg.top_k, capacity)
        disp, combine = disp.to(dt), combine.to(dt)
        mark("dispatch")
        xe = torch.einsum("bngec,bngd->bnecd", disp, xg)
        mark("dispatch_product")
        products = {}
        for name in ("w_gate", "w_up"):
            w = layer[name].to(dt)
            mark("casts")
            products[name] = torch.einsum("bnecd,edf->bnecf", xe, w)
            del w
            mark("expert_products")
        h = F.silu(products["w_gate"]) * products["w_up"]
        w = layer["w_down"].to(dt)
        mark("casts")
        ye = torch.einsum("bnecf,efd->bnecd", h, w)
        del w
        mark("expert_products")
        y = torch.einsum("bngec,bnecd->bngd", combine, ye).reshape(b, s, d)
        mark("combine_product")
        torch.cuda.synchronize()
    if not torch.equal(y, expect):
        fail(f"{cfg.name}: the MoE breakdown's steps do not give moe.apply's output")
    ms: dict = {}
    for (_, before), (label, after) in zip(marks, marks[1:]):
        ms[label] = ms.get(label, 0.0) + before.elapsed_time(after)
    ms["total"] = sum(ms.values())
    return ms


def moe_input(cfg, b: int, s: int, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)


def serve_moe_paged(cfg, label: str) -> tuple:
    """The paged engine serving ``cfg`` at full width (its layers cut) on
    phase 4's traffic (8 slots, cache 2048, pages of 16, 256-token chunks; 8
    requests of 512 prompt tokens, the first 256 shared, and 32 new, half
    greedy, half t=0.8, top_k=50), counters zeroed just before and read just
    after: the decode once a layer and tick, the chunk prefill once a layer
    and chunk, the sampler every tick (and for a first token); the prefix
    is reused (sharing stays on for MoE, as in JAX). Then the same batch
    traced on the device, and the MoE layer's device ms at a decode tick
    (8 x 1 token: 8 routing groups of one) and at a chunk (one group of
    256) from ``moe_breakdown``, against the trace's busy time. Returns
    (model, params, the measured batch's prompts, record)."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gla import ops as gla_ops
    from repro_torch.kernels.paged_decode import ops as paged_ops
    from repro_torch.models import LanguageModel
    from repro_torch.serve import PagedContinuousBatchingEngine
    from repro_torch.utils.tree import tree_leaves

    model = LanguageModel(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in tree_leaves(params))
    print(f"init: {cfg.name} full width, {cfg.num_layers} layers, {n_params} params ({cfg.param_dtype}, "
          f"compute {cfg.compute_dtype}) in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    engine = PagedContinuousBatchingEngine(
        model, params, max_slots=8, page_size=16, cache_len=2048, prefill_chunks=(256,), seed=0,
    )
    rng = torch.Generator().manual_seed(2)
    prefix = torch.randint(0, cfg.vocab_size, (256,), generator=rng)
    prompts = []

    def prompt():
        return torch.cat([prefix, torch.randint(0, cfg.vocab_size, (256,), generator=rng)]).numpy()

    def submit_batch():
        prompts.append([prompt() for _ in range(8)])
        return [engine.submit(p, max_new_tokens=32, temperature=0.0 if i % 2 == 0 else 0.8,
                              top_k=0 if i % 2 == 0 else 50) for i, p in enumerate(prompts[-1])]

    engine.submit(prompt(), max_new_tokens=4)  # warm-up: publishes the shared prefix
    engine.run()
    engine.reset_stats()
    ids = submit_batch()
    torch.cuda.synchronize()
    for ops in (paged_ops, gla_ops, flash_ops):
        ops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**paged_ops.LAUNCHES, **gla_ops.LAUNCHES, **flash_ops.LAUNCHES}
    for rid in ids:
        gen_tokens = results[rid][512:]
        if len(gen_tokens) != 32 or gen_tokens.min() < 0 or gen_tokens.max() >= cfg.vocab_size:
            fail(f"{label} request {rid}: bad generated tokens {gen_tokens.tolist()}")
    engine.pool.check()
    stats, mem = copy.deepcopy(engine.stats), engine.memory_stats()
    if not engine.prefix_sharing or stats["prefix_tokens_reused"] <= 0:
        fail(f"{label}: no prefix tokens were reused (sharing stays on for MoE)")
    layers = cfg.num_layers
    expect = {"paged_flash_decode": layers * stats["ticks"], "paged_chunk_prefill": layers * stats["prefill_chunks"],
              "flash_attention_fwd": 0, "flash_attention_bwd": 0, "gla_fwd": 0, "gla_bwd": 0}
    for kname, n in expect.items():
        if launches[kname] != n:
            fail(f"{label} paged serving: {kname} launched {launches[kname]} times, not {n}")
    if not stats["ticks"] <= launches["fused_sample"] <= stats["ticks"] + len(ids):
        fail(f"{label} paged serving: the sampler launched {launches['fused_sample']} times in "
             f"{stats['ticks']} ticks for {len(ids)} requests")
    with torch.inference_mode():
        probe, _ = model.decode_step(
            params, torch.zeros((1, 1), dtype=torch.int32, device="cuda"), model.paged_state_slice(engine.cache, 1),
            torch.zeros((1,), dtype=torch.int32, device="cuda"),
            torch.zeros((1, engine.max_pages), dtype=torch.int32, device="cuda"),
        )
    if probe.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(probe).all():
        fail(f"{label}: full-width decode logits are not finite")
    peak = torch.cuda.max_memory_allocated()
    profile = device_profile(engine.run, submit_batch)
    engine.pool.check()
    tick_ms = sorted(stats["decode_tick_s"])[len(stats["decode_tick_s"]) // 2] * 1e3
    del engine, results, probe
    gc.collect()
    torch.cuda.empty_cache()
    layer = params["seg0"]["b0"][0]["moe"]
    breakdown = {"decode_tick": moe_breakdown(layer, moe_input(cfg, 8, 1, 1), cfg),
                 "chunk": moe_breakdown(layer, moe_input(cfg, 1, 256, 2), cfg)}
    moe_ms = layers * (stats["ticks"] * breakdown["decode_tick"]["total"]
                       + stats["prefill_chunks"] * breakdown["chunk"]["total"])
    print(f"{label} paged: {len(ids)} requests x 32 tokens in {wall:.3f} s | decode {stats['decoded_tokens']} "
          f"tokens = {stats['decoded_tokens'] / wall:.1f} tok/s | median decode tick {tick_ms:.2f} ms | "
          f"{stats['ticks']} ticks, {stats['prefill_chunks']} chunks | prefix reused {stats['prefix_tokens_reused']} "
          f"| pages peak {mem['pages_peak']}/{mem['pages_capacity']} | peak memory {peak / 2**30:.1f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} | launches {launches}", flush=True)
    print(f"{label} profile: device busy {profile['busy_ms']:.1f} ms of {profile['wall_ms']:.1f} ms wall, idle "
          f"{100 * profile['idle_share']:.1f}% | paged decode {profile['paged_decode_ms']:.2f} ms, prefill "
          f"{profile['paged_prefill_ms']:.2f} ms, sampler {profile['sampler_ms']:.3f} ms over "
          f"{profile['sampler_launches']} launches | MoE layers ~{moe_ms:.1f} ms "
          f"({100 * moe_ms / profile['busy_ms']:.1f}% of busy) from their device ms a layer: " + "; ".join(
              f"{where} " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) for where, ms in breakdown.items()),
          flush=True)
    for kname, (ms, n) in list(profile["by_kernel"].items())[:8]:
        print(f"{label} profile: {ms:9.2f} ms {n:6d} x  {kname[:100]}")
    record = {"layers": layers, "params": n_params, "wall_s": wall, "decoded_tokens": stats["decoded_tokens"],
              "tok_s": stats["decoded_tokens"] / wall, "ticks": stats["ticks"],
              "prefill_chunks": stats["prefill_chunks"], "prefix_tokens_reused": stats["prefix_tokens_reused"],
              "median_decode_tick_ms": tick_ms, "peak_gib": peak / 2**30, "launches": launches,
              "profile": profile, "moe_breakdown_ms": breakdown, "moe_ms": moe_ms}
    return model, params, np.stack(prompts[0]), record


def serve_static_moe(cfg, model, params, batch, label: str) -> dict:
    """The static engine on the 8 prompts (greedy, one batched prefill of 8
    routing groups of 512: the flash forward once a layer), counters zeroed
    just before and read just after."""
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_decode import ops as paged_ops
    from repro_torch.serve import ServeEngine

    static = ServeEngine(model, params, cache_len=1024)
    static.generate(batch[:1, :64], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for ops in (paged_ops, flash_ops):
        ops.reset_launches()
    t0 = time.perf_counter()
    out = static.generate(batch, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**paged_ops.LAUNCHES, **flash_ops.LAUNCHES}
    for kname, n in (("flash_attention_fwd", cfg.num_layers), ("paged_flash_decode", 0),
                     ("fused_sample", 0)):
        if launches[kname] != n:
            fail(f"{label} static serving: {kname} launched {launches[kname]} times, not {n}")
    if out.shape != (8, 512 + 32) or out.min() < 0 or out.max() >= cfg.vocab_size:
        fail(f"{label} static serving: bad output of shape {out.shape}")
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} static: 8 x 512 greedy prompts + 32 tokens in {wall:.3f} s = {8 * 32 / wall:.1f} tok/s | "
          f"peak memory {peak / 2**30:.1f} GiB | launches {launches}", flush=True)
    return {"wall_s": wall, "tok_s": 8 * 32 / wall, "peak_gib": peak / 2**30, "launches": launches}


def serve_dbrx(cfg) -> dict:
    """Phase 18: dbrx-132b at full width, cut to ``cfg``'s 4 of 40 layers,
    served by the paged engine on phase 4's traffic (serve_moe_paged), then
    by the continuous engine (8 slots, cache 1,024; the flash forward once
    a layer and batch-1 prefill, the sampler once a tick and a first token)
    and the static engine on the same prompts; on dbrx smoke in float32 the
    greedy tokens of the three engines on the card equal the CPU path's."""
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_decode import ops as paged_ops
    from repro_torch.serve import ContinuousBatchingEngine

    label = "phase 18 dbrx"
    model, params, batch, record = serve_moe_paged(cfg, label)
    n, new = len(batch), 32
    engine = ContinuousBatchingEngine(model, params, max_slots=8, cache_len=1024, seed=0)
    engine.submit(batch[0][:64], max_new_tokens=4)  # warm-up
    engine.run()
    engine.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    ids = [engine.submit(p, max_new_tokens=new, temperature=0.0 if i % 2 == 0 else 0.8,
                         top_k=0 if i % 2 == 0 else 50) for i, p in enumerate(batch)]
    torch.cuda.synchronize()
    flash_ops.reset_launches()
    paged_ops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**flash_ops.LAUNCHES, **paged_ops.LAUNCHES}
    stats = engine.stats
    for rid in ids:
        gen_tokens = results[rid][512:]
        if len(gen_tokens) != new or gen_tokens.min() < 0 or gen_tokens.max() >= cfg.vocab_size:
            fail(f"{label} continuous request {rid}: bad generated tokens {gen_tokens.tolist()}")
    expect = {"flash_attention_fwd": cfg.num_layers * n, "fused_sample": stats["ticks"] + n,
              "paged_flash_decode": 0, "paged_chunk_prefill": 0}
    for kname, count in expect.items():
        if launches[kname] != count:
            fail(f"{label} continuous serving: {kname} launched {launches[kname]} times, not {count}")
    tick_ms = sorted(stats["decode_tick_s"])[len(stats["decode_tick_s"]) // 2] * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} continuous: {n} requests x {new} tokens in {wall:.3f} s | decode {stats['decoded_tokens']} "
          f"tokens = {stats['decoded_tokens'] / wall:.1f} tok/s | median decode tick {tick_ms:.2f} ms | peak "
          f"memory {peak / 2**30:.1f} GiB | launches {launches}", flush=True)
    record["continuous"] = {"wall_s": wall, "tok_s": stats["decoded_tokens"] / wall, "median_decode_tick_ms": tick_ms,
                            "peak_gib": peak / 2**30, "launches": launches}
    del engine, results
    gc.collect()
    torch.cuda.empty_cache()
    record["static"] = serve_static_moe(cfg, model, params, batch, label)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    small_input_agreement("dbrx-132b")
    dense_small_input_agreement("dbrx-132b")
    print(f"{label} small input: greedy tokens of the paged and both dense engines on the card equal the CPU "
          "path's on dbrx smoke (f32)", flush=True)
    return record


def train_dbrx(cfg) -> dict:
    """Phase 19: SEBSTrainer with pSGD on dbrx-132b at full width, cut to
    ``cfg``'s 1 of 40 layers, on phase 7's schedule (12 updates at batch 4,
    8, 16 by 1, 2 and 4 microbatches of 4 x 513 tokens: one routing group
    of 513 a row, capacity 161), counters zeroed just before and read just
    after: the flash forward twice a layer and microbatch (remat), its
    backward once, the fused pSGD once an update. Then one stage-2 update
    traced on the device, whose router loss (averaged over its
    microbatches) must be finite, positive and at most E x k a layer; the
    MoE layer's forward device ms at a microbatch (moe_breakdown); and on
    dbrx and arctic smoke the card's gradients (the router's included) and
    losses against the CPU path's, as in phase 8, with each path's expert
    choices reported."""
    import torch

    from repro_torch.optim import make_optimizer

    seq, b1 = 512, 4
    psgd = make_optimizer("psgd", gamma=1e4)
    eta = ETAS["dbrx_psgd"]
    log, wall, launches, updates, state, trainer = run_sebs(
        cfg, psgd, eta=eta, device="cuda", seq=seq, b1=b1, c1=16, stages=3)
    peak = torch.cuda.max_memory_allocated()
    check_training("dbrx psgd, full width", log, launches, ("flash_attention_fwd", "flash_attention_bwd", "fused_psgd"))
    micro = sum(bs // b1 for bs in log.batch_sizes)
    layers = cfg.num_layers
    expect = {"flash_attention_fwd": layers * 2 * micro, "flash_attention_bwd": layers * micro,
              "fused_psgd": len(log.steps), "gla_fwd": 0, "gla_bwd": 0}
    for kname, n in expect.items():
        if launches[kname] != n:
            fail(f"dbrx training: {kname} launched {launches[kname]} times, not {n}")
    stages = stage_table(log, updates, seq)
    print_training(f"dbrx psgd, {layers} layer", log, wall, peak, launches, stages, seq)
    profile, untraced_ms, metrics = trace_update("dbrx train", trainer, state, psgd, eta)
    aux = float(metrics["aux"])
    if not 0 < aux <= layers * cfg.num_experts * cfg.top_k:
        fail(f"dbrx training: router loss {aux} is not in (0, {layers * cfg.num_experts * cfg.top_k}]")
    layer = state.params["seg0"]["b0"][0]["moe"]
    breakdown = moe_breakdown(layer, moe_input(cfg, b1, seq + 1, 3), cfg)
    print(f"dbrx train: router loss of the stage-2 update {aux:.4f} (at most {cfg.num_experts * cfg.top_k} a "
          f"layer) | MoE forward device ms a layer at a microbatch (4 x 513): "
          + ", ".join(f"{k} {v:.3f}" for k, v in breakdown.items()), flush=True)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    agreement = {arch: card_cpu_agreement(arch) for arch in ("dbrx-132b", "arctic-480b")}
    return {"layers": layers, "eta": eta, "losses": log.losses, "wall_s": wall, "peak_gib": peak / 2**30,
            "launches": launches, "stages": stages, "profile": profile, "untraced_update_ms": untraced_ms,
            "aux": aux, "moe_breakdown_ms": breakdown, "card_vs_cpu": agreement}


def vision_card_cpu_agreement() -> dict:
    """internvl2 smoke in float32 with ``vision_embeds``: the loss and every
    gradient (``vision_proj``'s included) of one microbatch on the card
    equal the CPU path's, within 1e-4 relative and 1e-4 of each leaf's norm."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.train.step import _grads_over_microbatches
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config("internvl2-1b", "smoke").replace(compute_dtype="float32")
    model = LanguageModel(cfg)
    base = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))),
             "vision_embeds": torch.from_numpy(rng.standard_normal((4, cfg.num_vision_tokens, 1024)).astype(np.float32))}
    out = {}
    for device in ("cpu", "cuda"):
        params = tree_map(lambda x: x.to(device, copy=True), base)
        for w in tree_leaves(params):
            w.requires_grad_(True)
        g, m = _grads_over_microbatches(model, params, {k: v.to(device) for k, v in batch.items()}, 1, 0.0)
        out[device] = ([x.detach().cpu() for x in g], float(m["loss"]), params)
    params = out["cpu"][2]
    proj = {id(w) for w in tree_leaves(params["vision_proj"])}
    if not all(torch.linalg.vector_norm(g) > 0 for w, g in zip(tree_leaves(params), out["cpu"][0]) if id(w) in proj):
        fail("internvl2: the projector has no gradient")
    grad_worst = max((torch.linalg.vector_norm(c - a) / torch.linalg.vector_norm(a)).item()
                     for a, c in zip(out["cpu"][0], out["cuda"][0]))
    loss_rel = abs(out["cpu"][1] - out["cuda"][1]) / abs(out["cpu"][1])
    if grad_worst > CARD_CPU_RTOL or loss_rel > CARD_CPU_RTOL:
        fail(f"internvl2: card and CPU differ: gradients {grad_worst:.2e} of a leaf's norm, loss {loss_rel:.2e}")
    print(f"card vs cpu: internvl2 smoke f32 with vision_embeds, loss within {loss_rel:.2e} relative, "
          f"gradients (vision_proj's included) within {grad_worst:.2e} of a leaf's norm", flush=True)
    return {"loss_rel": loss_rel, "grad_max_rel": grad_worst}


def serve_arctic(cfg) -> dict:
    """Phase 20: arctic-480b at full width, cut to ``cfg``'s 1 of 35 layers
    (one expert tensor of 4.46 B elements; each cast to bf16, 8.9 GB, just
    before its product and released after it), served by the paged engine
    on phase 4's traffic (serve_moe_paged), then by the static engine on the
    same prompts (the flash forward at G 7); peak memory below the card's.
    On arctic smoke in float32 the greedy tokens of the paged and both dense
    engines on the card equal the CPU path's; internvl2 smoke with
    ``vision_embeds`` on the card equals the CPU path
    (vision_card_cpu_agreement)."""
    import torch

    label = "phase 20 arctic"
    model, params, batch, record = serve_moe_paged(cfg, label)
    record["static"] = serve_static_moe(cfg, model, params, batch, label)
    total = torch.cuda.get_device_properties(0).total_memory
    if max(record["peak_gib"], record["static"]["peak_gib"]) * 2**30 >= total:
        fail(f"{label}: peak memory at the card's {total / 2**30:.1f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    small_input_agreement("arctic-480b")
    dense_small_input_agreement("arctic-480b")
    print(f"{label} small input: greedy tokens of the paged and both dense engines on the card equal the CPU "
          "path's on arctic smoke (f32)", flush=True)
    record["vision_card_vs_cpu"] = vision_card_cpu_agreement()
    return record


# -- whisper-tiny (phases 21-24) ---------------------------------------------

# whisper's start sequence (<|startoftranscript|> <|en|> <|transcribe|>
# <|notimestamps|>) and <|startofprev|>, which opens the previous text
WHISPER_SOT = (50258, 50259, 50359, 50363)
WHISPER_PREV = 50361
WHISPER_TEXT_VOCAB = 50257  # the text tokens lie below the special ones
# (B, S, query heads, kv heads, D): the encoder's self-attention in training
# (4 a microbatch of 1,500 frames, non-causal) and the decoder's (4 rows of
# 448, causal)
WHISPER_ENC = (4, 1500, 6, 6, 64)
WHISPER_DEC = (4, 448, 6, 6, 64)
WHISPER_SERVE = {"slots": 8, "cache_len": 448, "page_size": 16, "chunk": 64, "new_tokens": 96, "prev": 128}


def f32_noncausal_check(record: dict, name: str, gen, b: int, s: int, hq: int, hkv: int, d: int) -> None:
    """The f32 route (CUDA cores) without the causal mask at one shape: the
    forward within 2e-5 and the backward within 1e-5 of the plain version,
    with the planted faults of the bf16 check (a key dropped, a causal mask
    where none belongs; Di left out) outside. Into ``record["f32_route"]``."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    q, k, v, d_out = (torch.randn(shape, generator=gen, device="cuda")
                      for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))

    def fwd_allowance(o, e):
        return ((o - e).abs() / (F32_FWD_TOL * (1 + e.abs()))).max().item()

    def bwd_allowance(o, e):
        return excess_bwd(o, e, F32_BWD_TOL, F32_BWD_TOL)

    out, lse = ops.forward(q, k, v, causal=False)
    expect, _ = ref.attention_fwd_ref(q, k, v, causal=False)
    readings = [check_close(f"{name} (f32)", out, expect, fault, allowance=fwd_allowance)
                for fault in (ref.attention_ref(q, k[:, :-1], v[:, :-1], causal=False),
                              ref.attention_ref(q, k, v, causal=True))]
    grads = ops.backward(q, k, v, out, lse, d_out, causal=False)
    expect_grads = ref.attention_bwd_ref(q, k, v, out, lse, d_out, causal=False)
    fault_grads = ref.attention_bwd_ref(q, k, v, torch.zeros_like(out), lse, d_out, causal=False)
    bwd = [check_close(f"{name} bwd {g_name} (f32)", g, e, f if g_name != "dv" else None, allowance=bwd_allowance)
           for g_name, g, e, f in zip(("dq", "dk", "dv"), grads, expect_grads, fault_grads)]
    record["f32_route"] = {
        "fwd_excess": max(r["excess"] for r in readings), "fwd_fault_excess": min(r["fault_excess"] for r in readings),
        "bwd_excess": max(r["excess"] for r in bwd), "bwd_fault_excess": min(r["fault_excess"] for r in bwd[:2]),
    }


def resnet_leaf_shapes(cfg) -> list:
    """Shapes of the ResNet's parameter leaves, in ``tree_leaves`` order."""
    from repro_torch.models import vision
    from repro_torch.utils.tree import tree_leaves

    return [tuple(w.shape) for w in tree_leaves(vision.init(0, cfg, device="cpu"))]


def whisper_kernel_checks(records: dict) -> None:
    """Phase 21, the kernels at whisper-tiny's shapes: the flash forward and
    backward non-causal at the encoder's (B 4, S 1500 = 23 x 64 + 28, 6/6
    heads, D 64) on the bf16 tensor-core route and the f32 route, and at
    each serving admission's (B 1); causal at the decoder's (B 4, S 448)
    and at its dense serving prefills (B 1 and 4 of 4 and 132 tokens); the
    paged decode and chunk prefill at D 64,
    G 1 (8 slots of 228 and 100 tokens, 64-token chunks); the sampler at 8
    rows of whisper's 51,865 logits; and the fused updates bit for bit over
    the leaves of Fig. 3's ResNet (sizes down to 8 elements)."""
    import torch

    from repro_torch.experiments import fig3_stagewise

    gen = torch.Generator(device="cuda").manual_seed(21)
    b, s, hq, hkv, d = WHISPER_ENC
    flash_shape(records, gen, b, s, hq, hkv, d, suffix="_whisper_enc", causal=False)
    f32_noncausal_check(records["flash_attention_fwd_whisper_enc"], "flash_attention_fwd_whisper_enc", gen,
                        b, s, hq, hkv, d)
    # serving: each admission's encoding (B 1; the static engine's batch of 4
    # is the shape above)
    flash_serving_prefills(records, "flash_attention_fwd_whisper_enc", gen, (1,), hq, hkv, d, seqs=(s,),
                           causal=False)
    b, s, hq, hkv, d = WHISPER_DEC
    flash_shape(records, gen, b, s, hq, hkv, d, suffix="_whisper_dec")
    # the decoder's dense prefills of the 4- and 132-token prompts: B 1 (the
    # continuous engine) and B 4 (the static one), each in one ragged tile
    prompts = (len(WHISPER_SOT), len(WHISPER_SOT) + WHISPER_SERVE["prev"])
    flash_serving_prefills(records, "flash_attention_fwd_whisper_dec", gen, (1, 4), hq, hkv, d, seqs=prompts)
    long_len = len(WHISPER_SOT) + WHISPER_SERVE["prev"] + WHISPER_SERVE["new_tokens"]
    short_len = len(WHISPER_SOT) + WHISPER_SERVE["new_tokens"]
    paged_shape_checks(records, "_whisper", hq, hkv, d, seed=22, lengths=[long_len, short_len] * 4,
                       chunk=WHISPER_SERVE["chunk"])
    records["fused_sample_v51865"] = sampler_reading("fused_sample_v51865", gen, 8, 51865)
    shapes = resnet_leaf_shapes(fig3_stagewise.CFG)
    fused_checks(records, {"fused_psgd_resnet": shapes, "fused_momentum_resnet": shapes,
                           "fused_adagrad_da_resnet": shapes})
    enc, enc_bwd = records["flash_attention_fwd_whisper_enc"], records["flash_attention_bwd_whisper_enc"]
    prefills = {**{f"encoder {k}": r for k, r in enc["serving_prefill"].items()},
                **{f"decoder {k}": r for k, r in records["flash_attention_fwd_whisper_dec"]["serving_prefill"].items()}}
    print("whisper's shapes, ms a call L2-cold (device ms in brackets; bound; plain): " + ", ".join(
        f"{n} {records[n]['ms']:.4f} ({records[n]['device_ms']:.4f}; "
        f"{records[n]['bound'][0]:.5f}; {records[n]['plain_ms']:.3f})"
        for n in ("flash_attention_fwd_whisper_enc", "flash_attention_bwd_whisper_enc",
                  "flash_attention_fwd_whisper_dec", "flash_attention_bwd_whisper_dec", "paged_flash_decode_whisper",
                  "paged_chunk_prefill_whisper", "fused_sample_v51865", "fused_psgd_resnet",
                  "fused_momentum_resnet", "fused_adagrad_da_resnet"))
          + f" | SDPA ({enc['library_backend']}) encoder fwd {enc['library_ms']:.4f} (device "
          f"{enc['library_device_ms']:.4f}), bwd {enc_bwd['library_ms']:.4f} ({enc_bwd['library_device_ms']:.4f}); "
          f"default dispatch fwd {enc['library_ms_default']:.4f} ({enc['library_device_ms_default']:.4f}), bwd "
          f"{enc_bwd['library_ms_default']:.4f} ({enc_bwd['library_device_ms_default']:.4f}) | encoder f32 route, in "
          f"units of its allowance: fwd {enc['f32_route']['fwd_excess']:.3f} (faults "
          f"{enc['f32_route']['fwd_fault_excess']:.1f}), bwd {enc['f32_route']['bwd_excess']:.3f} (fault "
          f"{enc['f32_route']['bwd_fault_excess']:.1f}) | serving prefills, in units of the allowance (fault): "
          + ", ".join(f"{k} {r['excess']:.3f} ({r['fault_excess']:.1f})" for k, r in prefills.items())
          + f" | ResNet leaves {len(shapes)}, "
          f"{records['fused_psgd_resnet']['elements']} elements", flush=True)


def whisper_requests(cfg, seed: int):
    """Phase 22's 8 requests: half with whisper's 4-token start sequence as
    the prompt, half with 128 previous-text tokens (``<|startofprev|>`` and
    127 text tokens) before it; each with its own (1, 1500, 384) audio from
    the seed; odd requests sampled (t 0.8, top_k 50), even ones greedy."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    requests = []
    for i in range(8):
        prompt = np.asarray(WHISPER_SOT, np.int32)
        if i >= 4:
            prev = rng.integers(0, WHISPER_TEXT_VOCAB, WHISPER_SERVE["prev"] - 1)
            prompt = np.concatenate([[WHISPER_PREV], prev, prompt]).astype(np.int32)
        audio = torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=gen, device="cuda")
        requests.append((prompt, audio, 0.0 if i % 2 == 0 else 0.8, 0 if i % 2 == 0 else 50))
    return requests


def encode_ms(model, params, audio, iters: int = 5) -> float:
    """Median device-clocked ms of one request's encoding (the encoder's 4
    layers over 1,500 frames: what each admission costs)."""
    import torch

    times = []
    with torch.inference_mode():
        for _ in range(iters + 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            model._encode(params, {"audio_embeds": audio})
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    return sorted(times[1:])[iters // 2]


def serve_whisper(cfg) -> dict:
    """Phase 22: whisper-tiny at full width (4 + 4 layers, the whole model)
    served by the paged engine (8 slots, cache 448, pages of 16, 64-token
    chunks) on 8 requests (whisper_requests) of 96 new tokens each, counters
    zeroed just before and read just after: each admission encodes its
    audio (the flash forward non-causal once an encoder layer), every chunk
    launches the chunk prefill and every tick the decode once a decoder
    layer, and the sampler once a tick (the prompts' tails ride the ticks
    teacher-forced, so no first token is sampled apart). The same batch
    traced on the device; then the continuous engine (the flash forward
    once an encoder and once a decoder layer a request, the sampler once a
    tick and once a first token) and the static engine (greedy: the short
    prompts, then the long ones, one batch each)."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_decode import ops as paged_ops
    from repro_torch.models import LanguageModel
    from repro_torch.serve import ContinuousBatchingEngine, PagedContinuousBatchingEngine, ServeEngine
    from repro_torch.utils.tree import tree_leaves

    layers, enc_layers, new = cfg.num_layers, cfg.encoder_layers, WHISPER_SERVE["new_tokens"]
    model = LanguageModel(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: {cfg.name} full, {sum(w.numel() for w in tree_leaves(params))} params ({cfg.param_dtype}, "
          f"compute {cfg.compute_dtype}) in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    engine = PagedContinuousBatchingEngine(
        model, params, max_slots=WHISPER_SERVE["slots"], page_size=WHISPER_SERVE["page_size"],
        cache_len=WHISPER_SERVE["cache_len"], prefill_chunks=(WHISPER_SERVE["chunk"],), seed=0,
    )
    batches = []

    def submit_batch(eng=engine, seed=None):
        batches.append(whisper_requests(cfg, 30 + len(batches) if seed is None else seed))
        return [eng.submit(p, max_new_tokens=new, temperature=t, top_k=k, memory=a)
                for p, a, t, k in batches[-1]]

    warm = whisper_requests(cfg, 29)[4]
    engine.submit(warm[0], max_new_tokens=4, memory=warm[1])  # warm-up
    engine.run()
    engine.reset_stats()
    ids = submit_batch()
    requests = batches[-1]
    torch.cuda.synchronize()
    for ops in (paged_ops, flash_ops):
        ops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**paged_ops.LAUNCHES, **flash_launches()}
    for rid, (prompt, *_) in zip(ids, requests):
        gen_tokens = results[rid][len(prompt):]
        if len(gen_tokens) != new or gen_tokens.min() < 0 or gen_tokens.max() >= cfg.vocab_size:
            fail(f"whisper request {rid}: bad generated tokens {gen_tokens.tolist()}")
    engine.pool.check()
    stats, mem = copy.deepcopy(engine.stats), engine.memory_stats()
    if engine.prefix_sharing:
        fail("whisper: prefix sharing must be off for an encoder-decoder model")
    chunk = WHISPER_SERVE["chunk"]
    first_sampled = sum(1 for p, *_ in requests if len(p) >= chunk and len(p) % chunk == 0)
    expect = {"flash_attention_fwd": enc_layers * len(ids), "flash_attention_fwd_noncausal": enc_layers * len(ids),
              "flash_attention_bwd": 0, "paged_chunk_prefill": layers * stats["prefill_chunks"], "paged_flash_decode": layers * stats["ticks"],
              "fused_sample": stats["ticks"] + first_sampled}
    for kname, n in expect.items():
        if launches[kname] != n:
            fail(f"whisper paged serving: {kname} launched {launches[kname]} times, not {n}")
    encode = encode_ms(model, params, requests[0][1])
    profile = device_profile(engine.run, submit_batch)
    engine.pool.check()
    tick_ms = sorted(stats["decode_tick_s"])[len(stats["decode_tick_s"]) // 2] * 1e3
    print(
        f"phase 22 whisper paged: {len(ids)} requests (4 of 4 prompt tokens, 4 of 132) x {new} tokens in "
        f"{wall:.3f} s | decode {stats['decoded_tokens']} tokens = {stats['decoded_tokens'] / wall:.1f} tok/s | "
        f"median decode tick {tick_ms:.2f} ms | {stats['ticks']} ticks, {stats['prefill_chunks']} chunks | encode "
        f"{encode:.3f} ms an admission (device) | pages peak {mem['pages_peak']}/{mem['pages_capacity']} | peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches {launches}", flush=True)
    print(f"phase 22 whisper profile: device busy {profile['busy_ms']:.1f} ms of {profile['wall_ms']:.1f} ms wall, "
          f"idle {100 * profile['idle_share']:.1f}% | flash forward {profile['flash_fwd_ms']:.2f} ms, paged decode "
          f"{profile['paged_decode_ms']:.2f} ms, prefill {profile['paged_prefill_ms']:.2f} ms, sampler "
          f"{profile['sampler_ms']:.3f} ms over {profile['sampler_launches']} launches", flush=True)
    for kname, (ms, n) in list(profile["by_kernel"].items())[:10]:
        print(f"phase 22 whisper profile: {ms:9.2f} ms {n:6d} x  {kname[:100]}")
    del engine, results
    gc.collect()

    continuous = ContinuousBatchingEngine(model, params, cache_len=WHISPER_SERVE["cache_len"],
                                          max_slots=WHISPER_SERVE["slots"], seed=0)
    continuous.submit(warm[0], max_new_tokens=4, memory=warm[1])  # warm-up
    continuous.run()
    continuous.reset_stats()
    cids = [continuous.submit(p, max_new_tokens=new, temperature=t, top_k=k, memory=a) for p, a, t, k in requests]
    torch.cuda.synchronize()
    for ops in (paged_ops, flash_ops):
        ops.reset_launches()
    t0 = time.perf_counter()
    cresults = continuous.run()
    torch.cuda.synchronize()
    cwall = time.perf_counter() - t0
    claunches = {**paged_ops.LAUNCHES, **flash_launches()}
    cstats = copy.deepcopy(continuous.stats)
    expect = {"flash_attention_fwd": (enc_layers + layers) * len(cids),
              "flash_attention_fwd_noncausal": enc_layers * len(cids), "paged_flash_decode": 0,
              "paged_chunk_prefill": 0, "fused_sample": cstats["ticks"] + len(cids)}
    for kname, n in expect.items():
        if claunches[kname] != n:
            fail(f"whisper continuous serving: {kname} launched {claunches[kname]} times, not {n}")
    for rid, (prompt, *_) in zip(cids, requests):
        gen_tokens = cresults[rid][len(prompt):]
        if len(gen_tokens) != new or gen_tokens.min() < 0 or gen_tokens.max() >= cfg.vocab_size:
            fail(f"whisper continuous request {rid}: bad generated tokens")
    ctick = sorted(cstats["decode_tick_s"])[len(cstats["decode_tick_s"]) // 2] * 1e3
    print(f"phase 22 whisper continuous: {cstats['decoded_tokens']} decode tokens in {cwall:.3f} s = "
          f"{cstats['decoded_tokens'] / cwall:.1f} tok/s | median tick {ctick:.2f} ms | launches {claunches}",
          flush=True)
    del continuous, cresults

    static = ServeEngine(model, params, cache_len=WHISPER_SERVE["cache_len"])
    static.generate(warm[0][None, :], max_new_tokens=2, memory=warm[1])  # warm-up
    static_runs = {}
    for label, group in (("short", requests[:4]), ("long", requests[4:])):
        prompts = np.stack([p for p, *_ in group])
        audio = torch.cat([a for _, a, *_ in group])
        torch.cuda.synchronize()
        for ops in (paged_ops, flash_ops):
            ops.reset_launches()
        t0 = time.perf_counter()
        out = static.generate(prompts, max_new_tokens=new, memory=audio)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        slaunches = {**paged_ops.LAUNCHES, **flash_launches()}
        if (slaunches["flash_attention_fwd"] != enc_layers + layers
                or slaunches["flash_attention_fwd_noncausal"] != enc_layers or slaunches["paged_flash_decode"]):
            fail(f"whisper static serving ({label}): launches {slaunches}, not one encoding and one prefill")
        if out.shape != (4, prompts.shape[1] + new) or out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"whisper static serving ({label}): bad output of shape {out.shape}")
        static_runs[label] = {"wall_s": swall, "tok_per_s": 4 * new / swall, "launches": slaunches}
    print("phase 22 whisper static: " + ", ".join(
        f"{n} prompts 4 x {new} greedy tokens in {r['wall_s']:.3f} s = {r['tok_per_s']:.1f} tok/s"
        for n, r in static_runs.items()), flush=True)
    peak = torch.cuda.max_memory_allocated()
    paths = (launches, claunches, *(r["launches"] for r in static_runs.values()))
    del static, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"wall_s": wall, "decoded_tokens": stats["decoded_tokens"], "ticks": stats["ticks"],
            "prefill_chunks": stats["prefill_chunks"], "median_decode_tick_ms": tick_ms,
            "encode_ms": encode, "launches": launches, "profile": profile, "peak_gib": peak / 2**30,
            # the flash forward by part over the three engines, as counted: the encoder's
            # launches non-causal, the decoder's causal
            "encoder_fwd": sum(run["flash_attention_fwd_noncausal"] for run in paths),
            "decoder_fwd": sum(run["flash_attention_fwd"] - run["flash_attention_fwd_noncausal"] for run in paths),
            "continuous": {"wall_s": cwall, "decoded_tokens": cstats["decoded_tokens"], "ticks": cstats["ticks"],
                           "median_decode_tick_ms": ctick, "launches": claunches},
            "static": static_runs}


class AudioRows:
    """A token stream with audio beside it: ``TokenDataset`` rows, and row
    ``i``'s (frames, d) audio embeddings from ``default_rng((seed, i))``,
    both pure in the sample index."""

    def __init__(self, vocab: int, seq: int, frames: int, d: int, seed: int = 0):
        from repro_torch.data import TokenDataset

        self.tokens = TokenDataset(vocab, seq, seed=seed)
        self.frames, self.d, self.seed = frames, d, seed

    def batch(self, offset: int, batch_size: int) -> dict:
        import numpy as np

        audio = np.stack([np.random.default_rng((self.seed, offset + i)).standard_normal(
            (self.frames, self.d), dtype=np.float32) for i in range(batch_size)])
        return {**self.tokens.batch(offset, batch_size), "audio_embeds": audio}


def train_whisper(cfg) -> dict:
    """Phase 23: SEBSTrainer with pSGD on whisper-tiny at full width, on
    phase 7's schedule (12 updates at batch 4, 8, 16 by 1, 2 and 4
    microbatches of 4 rows of 449 tokens, each with its (1500, 384) audio;
    remat), counters zeroed just before and read just after: the flash
    forward runs twice a layer and microbatch (remat; the encoder's
    non-causal, the decoder's causal) and the backward once. Then one
    stage-2 update traced on the device."""
    import torch

    from repro_torch.optim import make_optimizer

    seq, b1 = WHISPER_DEC[1], 4
    layers = cfg.num_layers + cfg.encoder_layers
    psgd = make_optimizer("psgd", gamma=1e4)
    eta = ETAS["whisper_psgd"]
    log, wall, launches, updates, state, trainer = run_sebs(
        cfg, psgd, eta=eta, device="cuda", seq=seq, b1=b1, c1=16, stages=3,
        dataset=AudioRows(cfg.vocab_size, seq, cfg.encoder_seq, cfg.d_model))
    peak = torch.cuda.max_memory_allocated()
    check_training("whisper psgd, full width", log, launches,
                   ("flash_attention_fwd", "flash_attention_bwd", "fused_psgd"))
    micro = sum(bs // b1 for bs in log.batch_sizes)
    expect = {"flash_attention_fwd": layers * 2 * micro, "flash_attention_bwd": layers * micro,
              "flash_attention_fwd_noncausal": cfg.encoder_layers * 2 * micro,
              "flash_attention_bwd_noncausal": cfg.encoder_layers * micro, "fused_psgd": len(log.steps)}
    for kname, n in expect.items():
        if launches[kname] != n:
            fail(f"whisper training: {kname} launched {launches[kname]} times, not {n}")
    stages = stage_table(log, updates, seq)
    print_training("whisper psgd", log, wall, peak, launches, stages, seq)
    profile, untraced_ms, _ = trace_update("whisper train", trainer, state, psgd, eta)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"eta": eta, "losses": log.losses, "wall_s": wall, "peak_gib": peak / 2**30, "launches": launches,
            "microbatches": micro, "stages": stages, "profile": profile, "untraced_update_ms": untraced_ms,
            # by part, as counted: the encoder's launches non-causal, the decoder's causal
            **{f"{part}_{kind}": launches[f"flash_attention_{kind}_noncausal"] if part == "encoder"
               else launches[f"flash_attention_{kind}"] - launches[f"flash_attention_{kind}_noncausal"]
               for part in ("encoder", "decoder") for kind in ("fwd", "bwd")}}


def whisper_card_cpu_agreement() -> dict:
    """Phase 24, whisper-tiny smoke (2 + 2 layers, 64 frames) in float32
    from the same weights on the CPU (plain versions) and on the card
    (kernels): the first update's gradients leaf by leaf within 1e-4 of
    each leaf's norm, the losses of a short SEBS run whose batches carry
    audio within 1e-4 relative (a control run on the CPU from weights moved
    by 1e-7 shows how far rounding alone carries them), and the greedy
    tokens of the paged, continuous and static engines with per-request
    audio equal."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.serve import ContinuousBatchingEngine, PagedContinuousBatchingEngine, ServeEngine
    from repro_torch.train.step import _grads_over_microbatches
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config("whisper-tiny", "smoke").replace(compute_dtype="float32")
    model = LanguageModel(cfg)
    base = model.init(seed=0, device="cpu")
    rows = AudioRows(cfg.vocab_size, 32, cfg.encoder_seq, cfg.d_model, seed=1).batch(0, 4)

    def copy_to(tree, device):  # the runs update their weights in place
        return tree_map(lambda x: x.detach().to(device, copy=True), tree)

    grads = {}
    for device in ("cpu", "cuda"):
        params = copy_to(base, device)
        for w in tree_leaves(params):
            w.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(device) for k, v in rows.items()}
        g, _ = _grads_over_microbatches(model, params, batch, 1, 0.0)
        grads[device] = [x.detach().cpu() for x in g]
    grad_worst = max((torch.linalg.vector_norm(c - a) / torch.linalg.vector_norm(a)).item()
                     for a, c in zip(grads["cpu"], grads["cuda"]))
    if grad_worst > CARD_CPU_RTOL:
        fail(f"whisper: card and CPU gradients differ by {grad_worst:.2e} of a leaf's norm")
    gen = torch.Generator().manual_seed(1)
    moved = tree_map(lambda x: x * (1 + 1e-7 * torch.randn(x.shape, generator=gen)), base)
    eta = CARD_CPU_REFERENCE_ETA
    losses = {}
    for label, device, weights in (("cpu", "cpu", base), ("cuda", "cuda", base), ("control", "cpu", moved)):
        log = run_sebs(cfg, make_optimizer("psgd", gamma=1e4), eta=eta, device=device, seq=32, b1=4, c1=8,
                       stages=2, params=copy_to(weights, device),
                       dataset=AudioRows(cfg.vocab_size, 32, cfg.encoder_seq, cfg.d_model, seed=1))[0]
        losses[label] = log.losses
    worst, control = (max(abs(a - b) / abs(a) for a, b in zip(losses["cpu"], losses[other]))
                      for other in ("cuda", "control"))
    if control > CARD_CPU_RTOL / 2:
        fail(f"whisper: the control run moves {control:.2e}: the comparison cannot hold {CARD_CPU_RTOL:.0e}")
    if worst > CARD_CPU_RTOL:
        fail(f"whisper: card and CPU losses differ by {worst:.2e} relative: {losses}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (4, 9, 4, 6)]
    audio = torch.from_numpy(rng.standard_normal((4, 1, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    streams = {}
    for device in ("cpu", "cuda"):
        params = copy_to(base, device)
        runs = {}
        for name, engine in (
                ("paged", PagedContinuousBatchingEngine(model, params, cache_len=32, max_slots=2, page_size=4,
                                                        prefill_chunks=(4,), seed=0, device=device)),
                ("continuous", ContinuousBatchingEngine(model, params, cache_len=32, max_slots=2, seed=0,
                                                        device=device))):
            ids = [engine.submit(p, max_new_tokens=6, memory=audio[i].to(device)) for i, p in enumerate(prompts)]
            out = engine.run()
            runs[name] = [out[i].tolist() for i in ids]
        runs["static"] = ServeEngine(model, params, cache_len=32, device=device).generate(
            np.stack([prompts[0], prompts[2]]), 6, memory=torch.cat([audio[0], audio[2]]).to(device)).tolist()
        streams[device] = runs
    if streams["cpu"] != streams["cuda"]:
        fail(f"whisper smoke greedy tokens differ: cpu {streams['cpu']} vs cuda {streams['cuda']}")
    print(f"phase 24 card vs cpu: whisper smoke f32, first-update gradients within {grad_worst:.2e} of a leaf's "
          f"norm; {len(losses['cpu'])} SEBS updates at eta {eta}, losses within {worst:.2e} relative (control "
          f"{control:.2e}); greedy tokens of the paged, continuous and static engines equal", flush=True)
    return {"grad_max_rel": grad_worst, "max_rel": worst, "control_max_rel": control, "eta": eta,
            "cpu": losses["cpu"], "cuda": losses["cuda"]}


# -- the paper's own experiments (phase 25) ----------------------------------

FIG3_FUSED = {"psgd": "fused_psgd", "momentum": "fused_momentum", "adagrad_da": "fused_adagrad_da"}
RESNET_RTOL = 1e-4


def resnet_card_cpu() -> dict:
    """ResNet-20 at its real shape (width 16, 3 blocks a stage, 32 px, batch
    16) from the same weights on the CPU and the card: the logits and the
    loss within 1e-4 relative, the gradients within 1e-4 of each leaf's
    norm, and one pSGD update's weights within 1e-4 of each leaf's norm."""
    import torch

    from repro_torch.data import ImageClassDataset
    from repro_torch.data.synthetic import key
    from repro_torch.models import vision
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = vision.VisionConfig()
    base = vision.init(0, cfg, device="cpu")
    batch = ImageClassDataset(n=4000, image_size=32, noise=1.2, seed=0).train_batch(key(5), 16, device="cpu")
    out = {}
    for device in ("cpu", "cuda"):
        params = tree_map(lambda x: x.to(device, copy=True), base)
        leaves = tree_leaves(params)
        for w in leaves:
            w.requires_grad_(True)
        x, y = batch["image"].to(device), batch["label"].to(device)
        logits = vision.apply(params, x, cfg)
        loss = -torch.log_softmax(logits, -1).gather(-1, y[:, None]).mean()
        grads = torch.autograd.grad(loss, leaves)
        opt = make_optimizer("psgd", gamma=1e4)
        state = opt.init(params)
        opt.update(list(grads), state, params, lr=0.15, stage=0)
        out[device] = (logits.detach().cpu(), float(loss.detach()), [g.cpu() for g in grads],
                       [w.detach().cpu() for w in leaves])
    (lc, fc, gc_, wc), (lg, fg, gg, wg) = out["cpu"], out["cuda"]
    reading = {
        "logits_max_rel": ((lg - lc).abs().max() / lc.abs().max()).item(),
        "loss_rel": abs(fg - fc) / abs(fc),
        "grad_max_rel": max((torch.linalg.vector_norm(b - a) / torch.linalg.vector_norm(a)).item()
                            for a, b in zip(gc_, gg)),
        "weights_max_rel": max((torch.linalg.vector_norm(b - a) / torch.linalg.vector_norm(a)).item()
                               for a, b in zip(wc, wg)),
    }
    if max(reading.values()) > RESNET_RTOL:
        fail(f"ResNet-20 card against CPU: {reading}")
    return reading


FIG3_WORKERS = 4  # Fig. 3's methods run in this many processes sharing the card


def _fig3_method(name: str):
    """One Fig. 3 method on the card in a worker process: (its result, the
    fused launches it made, its wall seconds)."""
    import torch

    from repro_torch.experiments import fig3_stagewise
    from repro_torch.kernels.fused_optim import ops as optim_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    schedule, opt_name, opt_kwargs = fig3_stagewise.methods()[name]
    optim_ops.reset_launches()
    t0 = time.perf_counter()
    res = fig3_stagewise._train(schedule, opt_name, opt_kwargs, device="cuda")
    torch.cuda.synchronize()
    return res, dict(optim_ops.LAUNCHES), time.perf_counter() - t0


FIG1_ITERS = 3  # timed steps a batch size (after one untimed)
FIG1_SECONDS = 30.0  # the phase's limit


def fig1_phase(smi: str) -> dict:
    """Phase 33: the paper's Fig. 1 on the card
    (``repro_torch.experiments.fig1_util``): the momentum train step on
    qwen2.5-3b at smoke size and at full width (36 layers, d 2,048), µs a
    sample at batches 1-32 of 64 tokens, the counters zeroed before each
    size and read after: the flash forward (twice a layer under remat) and
    backward once a layer a step, the fused momentum once a step. µs a
    sample at batch 32 must be below batch 1 at both sizes, and the phase
    within FIG1_SECONDS."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.experiments import fig1_util
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_optim import ops as optim_ops

    t0 = time.perf_counter()
    out = {}
    for variant in ("smoke", "full"):
        gc.collect()
        torch.cuda.empty_cache()
        flash_ops.reset_launches()
        optim_ops.reset_launches()
        tv = time.perf_counter()
        records = fig1_util.run(str(OUT_DIR / "experiments"), "cuda", variant, FIG1_ITERS)
        wall = time.perf_counter() - tv
        cfg = get_config("qwen2.5-3b", variant)
        steps = len(fig1_util.BATCHES) * (1 + FIG1_ITERS)
        want = {"flash_attention_fwd": (2 if cfg.remat else 1) * cfg.num_layers * steps,
                "flash_attention_bwd": cfg.num_layers * steps, "fused_momentum": steps}
        launches = {k: {**flash_ops.LAUNCHES, **optim_ops.LAUNCHES}[k] for k in want}
        if launches != want:
            fail(f"phase 33 fig1 {variant}: launches {launches}, not {want}")
        us = {int(k): v for k, v in records[0].context["per_sample_us"].items()}
        print(f"phase 33 fig1 {variant} ({cfg.num_layers} layers, d {cfg.d_model}): µs a sample by batch "
              + ", ".join(f"{b}: {v:.1f}" for b, v in us.items())
              + f"; b 1 -> 32 {records[1].value:.2f}x; launches {launches}; {wall:.1f} s | {smi}", flush=True)
        if not us[32] < us[1]:
            fail(f"phase 33 fig1 {variant}: µs a sample at batch 32 ({us[32]:.1f}) is not below batch 1 ({us[1]:.1f})")
        out[variant] = {"per_sample_us": us, "speedup": records[1].value, "launches": launches, "wall_s": wall}
    seconds = time.perf_counter() - t0
    if seconds > FIG1_SECONDS:
        fail(f"phase 33 fig1: {seconds:.1f} s, not within {FIG1_SECONDS:.0f} s")
    out["seconds"] = seconds
    return out


def paper_experiments() -> dict:
    """Phase 25: the paper's experiments on the card. Fig. 3 at the JAX
    file's settings (n 4,000, 16 px, width 8, 10 epochs, b1 32, rho 4, all 8
    methods, in FIG3_WORKERS processes sharing the card: each run is
    host-bound and independent), each method's counters zeroed before its
    run and read after:
    its update count and logged batches equal its schedule's plan, and the
    methods that update through a fused kernel launch it once an update.
    Fig. 2's b*(x) at both rates over the full grid, with the correlation;
    adaptive SEBS; ResNet-20 at its real shape, card against CPU."""
    import torch

    from repro_torch.experiments import adaptive_sebs, fig2_optimal_batch, fig3_stagewise
    from repro_torch.kernels.fused_optim import ops as optim_ops

    import concurrent.futures
    import multiprocessing

    out_dir = str(OUT_DIR / "experiments")
    fig3, fig3_launches = {}, {}
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(FIG3_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        runs = {name: pool.submit(_fig3_method, name) for name in fig3_stagewise.methods()}
        runs = {name: f.result() for name, f in runs.items()}
    for name, (schedule, opt_name, opt_kwargs) in fig3_stagewise.methods().items():
        path = fig3_stagewise.batch_path(schedule)
        res, launches, wall = runs[name]
        if res["updates"] != len(path) or res["log"]["batch"] != path[9::10]:
            fail(f"fig3 {name}: {res['updates']} updates / logged batches differ from the schedule's "
                 f"{len(path)} updates")
        fused = FIG3_FUSED.get(opt_name) if opt_kwargs.get("gamma") != float("inf") else None
        expect = {k: (res["updates"] if k == fused else 0) for k in optim_ops.LAUNCHES}
        if launches != expect:
            fail(f"fig3 {name}: fused launches {launches}, not {expect}")
        if not all(math.isfinite(x) for x in res["log"]["loss"]):
            fail(f"fig3 {name}: a loss is not finite")
        fig3[name] = {"updates": res["updates"], "test_acc": res["test_acc"], "final_loss": res["log"]["loss"][-1],
                      "wall_s": wall, "optimizer": opt_name, "launches": launches}
        fig3_launches[name] = launches
        print(f"phase 25 fig3 {name}: {res['updates']} updates ({opt_name}) in {wall:.1f} s | test acc "
              f"{res['test_acc']:.4f} | final loss {res['log']['loss'][-1]:.4f} | fused launches {launches}",
              flush=True)
    fig3_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    qp = fig2_optimal_batch.QuadraticProblem(n=10_000, d=100)
    best, table = fig2_optimal_batch.optimal_batches(qp, device="cuda")
    torch.cuda.synchronize()
    fig2_wall = time.perf_counter() - t0
    corr = {lr: fig2_optimal_batch.correlation(opt) for lr, opt in best.items()}
    for lr, opt in best.items():
        print(f"phase 25 fig2 lr {lr}: b*(x) {opt} | corr(log b*, log x) {corr[lr]:.3f}", flush=True)
    t0 = time.perf_counter()
    adaptive_records = adaptive_sebs.run(out_dir, device="cuda")
    adaptive_wall = time.perf_counter() - t0
    adaptive = {r.name: r.value for r in adaptive_records}
    schedule_path = next(r.context["batch_path"] for r in adaptive_records
                         if r.name == "adaptive_adaptive_sebs_updates")
    print(f"phase 25 adaptive SEBS: " + ", ".join(f"{k} {v:.6g}" for k, v in adaptive.items())
          + f" | adaptive batch path {schedule_path} | {adaptive_wall:.1f} s", flush=True)
    resnet = resnet_card_cpu()
    print(f"phase 25 ResNet-20 (width 16, 32 px) card vs cpu: {resnet} | fig3 {fig3_wall:.1f} s, fig2 (full grid) "
          f"{fig2_wall:.1f} s", flush=True)
    return {"fig3": fig3, "fig3_wall_s": fig3_wall, "fig2": {"optimal": {str(k): v for k, v in best.items()},
                                                           "corr": {str(k): v for k, v in corr.items()},
                                                           "scores": {str(k): v for k, v in table.items()},
                                                           "wall_s": fig2_wall},
            "adaptive": adaptive, "adaptive_batch_path": schedule_path, "adaptive_wall_s": adaptive_wall,
            "resnet_card_vs_cpu": resnet}


# Phases 26-27: elastic multi-worker SEBS training, four workers sharing the card.
ELASTIC_LAYERS = 2           # qwen2.5-3b at full width, cut in depth (the bit-identity gates do not
                             # depend on depth; tools/mesh_check.py --four-cards runs all 36 layers)
ELASTIC_DEADLINE = 600.0     # seconds an elastic run may take in all
ELASTIC_SAVE_EVERY = 4       # the killed budget-4 run saves at 4 and 8 (5 GB each)


def elastic_cut(cfg):
    return cfg.replace(segments=(dataclasses.replace(cfg.segments[0], repeat=ELASTIC_LAYERS),))


def elastic_run(cfg, params, budget: int, *, optimizer=("psgd", {"gamma": 1e4}), eta: float = 1.0,
                sync_mode: str = "exact", local_interval: int = 4, copy_params: bool = True, param_axes=None,
                **run_kw):
    """One ElasticTrainer run on ``budget`` workers of cuda:0 from ``params``
    (a copy of them unless ``copy_params`` is false; on the card, rank 0
    reads them through CUDA IPC) on phase 7's schedule (SEBS b1 4, C1 16,
    rho 2, 3 stages, 513-token rows). Returns (log, wall s, trainer, final
    state)."""
    import torch

    from repro_torch.core import SEBS
    from repro_torch.data import DataPipeline, TokenDataset
    from repro_torch.distributed import ElasticTrainer
    from repro_torch.models import LanguageModel
    from repro_torch.obs import Tracer
    from repro_torch.optim import make_optimizer
    from repro_torch.train import TrainState

    opt = make_optimizer(optimizer[0], **optimizer[1])
    params = copy.deepcopy(params) if copy_params else params
    trainer = ElasticTrainer(
        LanguageModel(cfg), opt, SEBS(b1=4, C1=16, rho=2.0, num_stages=3, eta=eta),
        DataPipeline(TokenDataset(cfg.vocab_size, 512, seed=0), device="cuda"), microbatch=4,
        sync_mode=sync_mode, local_interval=local_interval, device_budget=budget,
        devices=[torch.device("cuda", 0)] * budget, tracer=Tracer(), deadline=ELASTIC_DEADLINE,
        param_axes=param_axes)
    t0 = time.perf_counter()
    state, log = trainer.run(TrainState(params, opt.init(params), 0), log_every=1, **run_kw)
    return log, time.perf_counter() - t0, trainer, state


def elastic_expected(trainer, log, first: int = 0) -> tuple:
    """From the planner and sync.py alone, for the updates ``log`` holds
    (the workers ran those after update ``first``): per rank (microbatches,
    updates), and the exact-sync ledger (per-stage summary) the byte models
    predict for the whole run."""
    from repro_torch.core.stages import StageController
    from repro_torch.distributed import CommAccountant, sync_cost

    world = trainer.planner.device_budget
    micro, updates = [0] * world, [0] * world
    acct, width = CommAccountant(), None
    plans = StageController(trainer.controller.schedule, microbatch=4).plans()
    for plan, _ in zip(plans, log.steps):
        mp = trainer.planner.plan_for(plan)
        if width is not None and mp.width != width:
            acct.record_reshard(plan.stage, bytes_moved=trainer._state_bytes if mp.width > width else 0)
        width = mp.width
        for r in range(mp.width if acct.total("updates") >= first else 0):
            micro[r] += mp.local_accum
            updates[r] += 1
        collectives, moved = sync_cost("exact", mp.width, grad_bytes=trainer._grad_bytes,
                                       state_bytes=trainer._state_bytes)
        acct.record_update(plan.stage, collectives=collectives, bytes_moved=moved)
    return micro, updates, acct.summary()


def elastic_launch_check(label: str, trainer, log, layers: int, fused: str, first: int = 0) -> dict:
    """Every worker launched the flash forward (2 a layer and microbatch:
    remat) and backward (1) for its own microbatches and the fused update
    once for each update its replica took; the counts add up over ranks."""
    micro, updates, _ = elastic_expected(trainer, log, first)
    total: dict = {}
    for r, stats in enumerate(trainer.worker_stats):
        got = stats["launches"]
        want = {"flash_attention_fwd": 2 * layers * micro[r], "flash_attention_bwd": layers * micro[r],
                fused: updates[r]}
        if any(got[k] != v for k, v in want.items()) or min(want.values()) <= 0:
            fail(f"{label}: worker {r} launched {got}, not {want}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    if total["flash_attention_bwd"] != layers * sum(micro) or total[fused] != sum(updates):
        fail(f"{label}: the ranks' launches {total} do not add up")
    return total


def elastic_times(trainer, log) -> dict:
    """Median update ms per stage (rank 0's spans), the all-gather's host ms
    per update by width (copy out, gather, copy back), the reshards' ms, and
    each worker's peak GiB."""
    spans = [ev["dur"] for ev in trainer.tracer.events if ev.get("name") == "train.update"]
    per_stage: dict = {}
    for st, dur in zip(log.stages, spans):
        per_stage.setdefault(st, []).append(dur * 1e3)
    widths = [trainer.planner.plan_for(p).width
              for p, _ in zip(trainer.controller.plans(), log.steps)]
    gathers: dict = {}
    for w, t in zip([w for w in widths if w > 1], trainer.worker_stats[0]["allgather"]):
        gathers.setdefault(w, []).append(t)
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return {
        "update_ms": {st: med(xs) for st, xs in per_stage.items()},
        "allgather_ms": {w: {part: med([t[f"{part}_s"] for t in ts]) * 1e3
                             for part in ("copy_out", "collective", "copy_back")} for w, ts in gathers.items()},
        "reshard_ms": [x * 1e3 for x in trainer.worker_stats[0]["reshard_s"]],
        "peak_gib": [s["peak_bytes"] / 2**30 for s in trainer.worker_stats],
    }


def same_gradient_bits_twice(cfg, params) -> None:
    """One microbatch (4 x 513) through the elastic step's term twice: the
    gradient bits must agree before the budgets are compared (atomics would
    break bit-identity across widths)."""
    import torch

    from repro_torch.data import TokenDataset
    from repro_torch.distributed.step import _local_total
    from repro_torch.models import LanguageModel

    model = LanguageModel(cfg)
    tokens = torch.from_numpy(TokenDataset(cfg.vocab_size, 512, seed=0).batch(0, 4)["tokens"]).cuda()
    runs = [_local_total(model, params, {"tokens": tokens[None]}, 1, 0.0) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(runs[0]["grads"], runs[1]["grads"], strict=True))
    if not same or not torch.equal(runs[0]["loss"], runs[1]["loss"]):
        fail("elastic: one microbatch's gradient differs between two runs on the card")
    for w in params_leaves(params):
        w.requires_grad_(False)
    print("phase 26 elastic: one microbatch's gradient has the same bits twice "
          f"({sum(g.numel() for g in runs[0]['grads']):,} elements)", flush=True)


def params_leaves(params):
    from repro_torch.utils.tree import tree_leaves

    return tree_leaves(params)


def print_elastic(label: str, budget: int, log, wall: float, times: dict, smi: str) -> None:
    print(f"phase {label} budget {budget}: {len(log.steps)} updates in {wall:.1f} s | update ms by stage "
          + ", ".join(f"{st} {ms:.1f}" for st, ms in times["update_ms"].items())
          + " | all-gather host ms an update by width (copy out / barriers / copy back) "
          + ", ".join(f"W{w} {p['copy_out']:.1f} / {p['collective']:.1f} / {p['copy_back']:.1f}"
                      for w, p in times["allgather_ms"].items())
          + " | reshard ms " + ", ".join(f"{x:.1f}" for x in times["reshard_ms"])
          + " | worker peaks GiB " + ", ".join(f"{x:.2f}" for x in times["peak_gib"])
          + f" | {smi}", flush=True)


def elastic_exact(cfg, smi: str) -> dict:
    """Phase 26: exact sync at budgets 1, 2 and 4 on one card (bit-identical
    losses, stages, batch sizes, GNS and params; widths {1}, {1, 2},
    {1, 2, 4}; the ledger sync.py predicts; every worker's launches); a run
    killed at update 9 under budget 4 resumed under budget 2 (bit-identical);
    the launcher's --dp-elastic on the visible card."""
    import os
    import shutil
    import subprocess
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import LanguageModel
    from repro_torch.utils.tree import tree_leaves

    layers = cfg.num_layers
    params = LanguageModel(cfg).init(0, device="cuda")
    same_gradient_bits_twice(cfg, params)
    gc.collect()
    torch.cuda.empty_cache()

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params), tree_leaves(b.params), strict=True))

    torch.cuda.empty_cache()
    print(f"phase 26 elastic: the card {torch.cuda.mem_get_info()[0] / 2**30:.1f} GiB free at the start", flush=True)
    runs, out, total = {}, {}, {}
    for budget in (1, 2, 4):
        log, wall, tr, state = elastic_run(cfg, params, budget)
        runs[budget] = (log, state if budget == 1 else same(state, runs[1][1]))
        widths = sorted({k[1] for k in tr._steps})
        if widths != [1, 2, 4][:budget.bit_length()]:
            fail(f"elastic budget {budget}: widths {widths}")
        _, _, predicted = elastic_expected(tr, log)
        if tr.accountant.summary() != predicted:
            fail(f"elastic budget {budget}: ledger {tr.accountant.summary()} is not sync.py's {predicted}")
        launches = elastic_launch_check(f"elastic budget {budget}", tr, log, layers, "fused_psgd")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        times = elastic_times(tr, log)
        print_elastic("26 elastic", budget, log, wall, times, smi)
        out[budget] = {"wall_s": wall, "losses": log.losses, "widths": widths, "ledger": predicted,
                       "launches_by_rank": [s["launches"] for s in tr.worker_stats], **times}
        del state, tr
        gc.collect()
    log1, state1 = runs[1]
    if not all(math.isfinite(x) for x in log1.losses):
        fail(f"elastic: a loss is not finite: {log1.losses}")
    for budget in (2, 4):
        log, same_params = runs[budget]
        if (log.losses != log1.losses or log.stages != log1.stages or log.batch_sizes != log1.batch_sizes
                or json.dumps(log.noise_scales) != json.dumps(log1.noise_scales) or not same_params):
            fail(f"elastic: budget {budget} is not bit-identical to budget 1 (losses {log.losses} vs {log1.losses},"
                 f" GNS {log.noise_scales} vs {log1.noise_scales}, params equal {same_params})")

    # killed at 9 under budget 4 (saves at 4 and 8), resumed under budget 2
    directory = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        with CheckpointManager(directory, keep_last=1) as ckpt:
            klog, kwall, ktr, _ = elastic_run(cfg, params, 4, checkpointer=ckpt,
                                              save_every=ELASTIC_SAVE_EVERY, stop_after_updates=9)
        with CheckpointManager(directory, keep_last=1) as ckpt:
            rlog, rwall, rtr, rstate = elastic_run(cfg, params, 2, checkpointer=ckpt,
                                                   save_every=ELASTIC_SAVE_EVERY, resume=True)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    for label, tr, log, first in (("killed", ktr, klog, 0), ("resumed", rtr, rlog, 8)):
        for k, v in elastic_launch_check(f"elastic {label}", tr, log, layers, "fused_psgd", first).items():
            total[k] = total.get(k, 0) + v
    same_params = same(rstate, state1)
    if (klog.steps != list(range(1, 10)) or rlog.losses != log1.losses or rlog.stages != log1.stages
            or not same_params):
        fail(f"elastic resume: killed at 9 under budget 4, resumed under budget 2: losses {rlog.losses} vs "
             f"{log1.losses}, params equal {same_params}")
    print(f"phase 26 elastic: budgets 1, 2, 4 bit-identical (losses, stages, batches, GNS, params); killed at 9 "
          f"under budget 4 ({kwall:.1f} s, saves at 4, 8) and resumed under budget 2 ({rwall:.1f} s): "
          f"bit-identical | {smi}", flush=True)
    # phases 30-31 are held to budget 1's run (budgets 2 and 4 equal it): its log and a host copy of its params
    reference = (log1, [t.detach().cpu() for t in tree_leaves(state1.params)])
    del rstate, state1, runs, params
    gc.collect()
    torch.cuda.empty_cache()

    # the launcher on the visible card (width 1)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--dp-elastic", "--variant", "smoke",
                           "--b1", "4", "--c1", "16", "--rho", "2", "--seq", "64", "--steps-log", "100"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    comm = [ln for ln in proc.stderr.splitlines() if "comm:" in ln]
    if proc.returncode != 0 or not comm:
        fail(f"elastic launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    print(f"phase 26 elastic launcher: --dp-elastic --variant smoke exit 0 in {time.perf_counter() - t0:.1f} s "
          f"| {comm[-1].strip()}", flush=True)
    return {"budgets": out, "killed_wall_s": kwall, "resumed_wall_s": rwall, "launches": total}, reference


def elastic_local(cfg, smi: str) -> dict:
    """Phase 27: local SGD at budget 4 (momentum 0.9, local_interval 2,
    save_every 3): saves snap to [3, 6, 10, 12]; finite losses; the state
    collapsed at the end; fewer collectives than updates."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import LanguageModel
    from repro_torch.utils.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    free_gib = torch.cuda.mem_get_info()[0] / 2**30
    params = LanguageModel(cfg).init(0, device="cuda")
    shapes = [t.shape for t in tree_leaves(params)]
    directory = tempfile.mkdtemp(prefix="chip_smoke_local_")
    try:
        with CheckpointManager(directory, keep_last=1) as ckpt:
            log, wall, tr, state = elastic_run(cfg, params, 4, optimizer=("momentum", {"beta": 0.9}),
                                               eta=ETAS["momentum"], sync_mode="local", local_interval=2,
                                               copy_params=False, checkpointer=ckpt, save_every=3)
        saves = [ev["args"]["update"] for ev in tr.tracer.events if ev.get("name") == "train.save"]
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    acct = tr.accountant
    shapes_ok = [t.shape for t in tree_leaves(state.params)] == shapes
    if saves != [3, 6, 10, 12] or not all(math.isfinite(x) for x in log.losses) or tr._stacked or not shapes_ok:
        fail(f"elastic local SGD: saves {saves}, losses {log.losses}, still stacked {tr._stacked}, "
             f"shapes kept {shapes_ok}")
    if not acct.total("collectives") < acct.total("updates"):
        fail(f"elastic local SGD: {acct.total('collectives')} collectives for {acct.total('updates')} updates")
    launches = elastic_launch_check("elastic local SGD", tr, log, cfg.num_layers, "fused_momentum")
    times = elastic_times(tr, log)
    sync_ms = [sum(t[f"{p}_s"] for p in ("copy_out", "collective", "copy_back")) * 1e3
               for t in tr.worker_stats[0]["sync"]]
    print_elastic("27 local SGD", 4, log, wall, times, smi)
    print(f"phase 27 local SGD: the card {free_gib:.1f} GiB free at the start; saves at {saves}, "
          f"{acct.total('collectives')} collectives for "
          f"{acct.total('updates')} updates, averages' host ms " + ", ".join(f"{x:.0f}" for x in sync_ms)
          + " | losses " + " ".join(f"{x:.4f}" for x in log.losses) + f" | {smi}", flush=True)
    return {"wall_s": wall, "losses": log.losses, "saves": saves, "ledger": acct.summary(), "sync_ms": sync_ms,
            "free_gib_at_start": free_gib,
            "launches": launches, **times}


# -- rule-based storage sharding (phases 30-31) --------------------------------

SHARD_MEMORY_TOL = 0.02  # a worker's between-update memory_allocated against its shards' bytes
SHARD_PEAK_TOL = 0.10  # a worker's peak in a stage-2 update against the dry run's count of its step


def shard_peak_check(label: str, cfg, trainer, meta_mesh, smi: str, stage: int = 2, shape=None) -> dict:
    """Each worker's max_memory_allocated in the updates of ``stage`` (by
    default phase 7's stage 2: 4 microbatches of 4 x 513 tokens, one a
    rank; ``shape`` the update's rows) against the dry run's count of that
    rank's step on ``meta_mesh`` (the run's mesh on meta devices) at the
    same depth (``repro_torch.launch.dryrun.count_train``, the host slots'
    layout; NCCL's in-place send buffer comes to the same). Fails beyond
    SHARD_PEAK_TOL, and where what a worker holds before such an update is
    beyond SHARD_MEMORY_TOL of the count's arguments (its shards and its
    chunk)."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun

    shape = InputShape("stage2", 513, 16, "train") if shape is None else shape
    t0 = time.perf_counter()
    rows = []
    for r, stats in enumerate(trainer.worker_stats):
        stage2 = [(before, peak) for st, before, peak in stats["update_peak_bytes"] if st == stage]
        mem = dryrun.count_train(cfg, shape, meta_mesh, optimizer_name="psgd", rank=r)["memory"]
        card, counted = max(p for _, p in stage2), mem["peak_bytes_per_device"]
        rows.append({"rank": r, "card_bytes": card, "counted_bytes": counted, "rel": card / counted - 1,
                     "card_before_bytes": [b for b, _ in stage2], "card_peaks": [p for _, p in stage2],
                     "counted_argument_bytes": mem["argument_bytes_per_device"]})
    print(f"phase {label}: stage-{stage} update peaks by worker, card / dry run GiB "
          + ", ".join(f"{x['card_bytes'] / 2**30:.3f} / {x['counted_bytes'] / 2**30:.3f} ({100 * x['rel']:+.1f}%; "
                      f"before an update {min(x['card_before_bytes']) / 2**30:.3f}-"
                      f"{max(x['card_before_bytes']) / 2**30:.3f}, counted arguments "
                      f"{x['counted_argument_bytes'] / 2**30:.3f})" for x in rows)
          + f" (counted in {time.perf_counter() - t0:.1f} s on the host) | {smi}", flush=True)
    if any(abs(x["rel"]) > SHARD_PEAK_TOL for x in rows):
        fail(f"phase {label}: a worker's stage-2 peak is beyond {SHARD_PEAK_TOL:.0%} of the dry run's count: {rows}")
    if any(abs(b / x["counted_argument_bytes"] - 1) > SHARD_MEMORY_TOL for x in rows for b in x["card_before_bytes"]):
        fail(f"phase {label}: a worker held more than its arguments (shards, batch chunk) before a stage-2 update, "
             f"beyond {SHARD_MEMORY_TOL:.0%}: {rows}")
    return {"by_worker": rows}


def shard_times(trainer, log) -> dict:
    """Median ms per stage of the sharded step's parts on rank 0 (the shard
    gather, the partials' exchange: copy out / barriers / copy back, the
    optimizer on the shards), the updates' ms (rank 0's spans) and each
    worker's peak GiB."""
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    spans = [ev["dur"] * 1e3 for ev in trainer.tracer.events if ev.get("name") == "train.update"]
    rows = trainer.worker_stats[0]["sharded"]
    by_stage: dict = {}
    for st, span, t in zip(log.stages, spans, rows):
        by_stage.setdefault(st, []).append((span, t))
    out = {}
    for st, items in by_stage.items():
        ex = [t["exchange"] for _, t in items]
        out[st] = {"update_ms": med([s for s, _ in items]), "gather_ms": med([t["gather_s"] for _, t in items]) * 1e3,
                   "exchange_ms": {p: med([e[f"{p}_s"] for e in ex]) * 1e3
                                   for p in ("copy_out", "collective", "copy_back")},
                   "optimizer_ms": med([t["update_s"] for _, t in items]) * 1e3}
    return {"by_stage": out, "peak_gib": [s["peak_bytes"] / 2**30 for s in trainer.worker_stats],
            "exchange": trainer.worker_stats[0]["exchange"]}


def print_shard_times(label: str, times: dict, smi: str) -> None:
    print(f"phase {label}: by stage " + "; ".join(
        f"{st}: update {t['update_ms']:.1f} ms, gather {t['gather_ms']:.1f}, exchange "
        f"{t['exchange_ms']['copy_out']:.1f} / {t['exchange_ms']['collective']:.1f} / "
        f"{t['exchange_ms']['copy_back']:.1f} (copy out / barriers / copy back), optimizer {t['optimizer_ms']:.1f}"
        for st, t in times["by_stage"].items())
        + f" | exchange {times['exchange']} | worker peaks GiB " + ", ".join(f"{x:.2f}" for x in times["peak_gib"])
        + f" | {smi}", flush=True)


def same_as_reference(label: str, log, params, reference) -> None:
    """The run's losses, stages, batch sizes, GNS and final params against
    phase 26's budget-1 run, bit for bit."""
    import torch

    from repro_torch.utils.tree import tree_leaves

    ref_log, ref_params = reference
    same = all(torch.equal(a.detach().cpu(), b) for a, b in zip(tree_leaves(params), ref_params, strict=True))
    if (log.losses != ref_log.losses or log.stages != ref_log.stages or log.batch_sizes != ref_log.batch_sizes
            or json.dumps(log.noise_scales) != json.dumps(ref_log.noise_scales) or not same):
        fail(f"{label}: not bit-identical to phase 26's budget 1 (losses {log.losses} vs {ref_log.losses}, "
             f"params equal {same})")


def mesh_sharded(cfg, smi: str, reference, mesh=None, label: str = "30 mesh (2, 2)") -> dict:
    """Phase 30: SEBSTrainer on a (2, 2) host mesh of four workers sharing
    cuda:0 (or on ``mesh``: ``tools/mesh_check.py`` passes the production
    mesh of four cards), the state sharded by qwen2.5-3b's param_axes (pSGD,
    phase 7's schedule): losses and final params bit-identical to
    ``reference`` (phase 26's budget 1); every worker launched the fused
    pSGD once an update (on its shards) and the flash kernels for the
    microbatches it computed; every worker's memory_allocated between
    updates within SHARD_MEMORY_TOL of its shards' bytes as the specs count
    them; each worker's stage-2 peak within SHARD_PEAK_TOL of the dry
    run's count (``shard_peak_check``)."""
    import numpy as np
    import torch

    from repro_torch.core import SEBS, SEBSTrainer
    from repro_torch.data import DataPipeline, TokenDataset
    from repro_torch.distributed.reshard import state_shardings
    from repro_torch.distributed.sharded import tensor_leaves, tensor_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LanguageModel
    from repro_torch.obs import Tracer
    from repro_torch.optim import make_optimizer
    from repro_torch.train import TrainState

    gc.collect()
    torch.cuda.empty_cache()
    model = LanguageModel(cfg)
    axes = model.param_axes()
    mesh = make_host_mesh(data=2, model=2, devices=[torch.device("cuda", 0)] * 4) if mesh is None else mesh
    opt = make_optimizer("psgd", gamma=1e4)
    params = model.init(0, device="cuda")
    state = TrainState(params, opt.init(params), 0)
    shard_bytes = sum(int(np.prod(s.shard_shape)) * t.element_size() for s, t in
                      zip(tensor_shardings(state_shardings(state, mesh, axes), state), tensor_leaves(state)))
    whole_bytes = sum(t.numel() * t.element_size() for t in tensor_leaves(state))
    trainer = SEBSTrainer(model, opt, SEBS(b1=4, C1=16, rho=2.0, num_stages=3, eta=1.0),
                          DataPipeline(TokenDataset(cfg.vocab_size, 512, seed=0), mesh), mesh=mesh,
                          param_axes=axes, microbatch=4, tracer=Tracer(), deadline=ELASTIC_DEADLINE)
    t0 = time.perf_counter()
    state, log = trainer.run(state, log_every=1)
    wall = time.perf_counter() - t0
    same_as_reference(f"phase {label}", log, state.params, reference)
    total, micro = _mesh_launch_check(f"phase {label}", cfg, trainer, log, microbatch=4)
    for r, stats in enumerate(trainer.worker_stats):
        between = stats["between_bytes"]
        worst = max(abs(b - shard_bytes) / shard_bytes for b in between)
        if len(between) != len(log.steps) or worst > SHARD_MEMORY_TOL:
            fail(f"phase {label}: worker {r} held {between} bytes between updates, not its shards' "
                 f"{shard_bytes} (within {SHARD_MEMORY_TOL:.0%})")
    times = shard_times(trainer, log)
    meta_mesh = make_host_mesh(*mesh.shape.values(), devices=["meta"] * mesh.size)
    times["peaks"] = shard_peak_check(label, cfg, trainer, meta_mesh, smi)
    between = [s["between_bytes"] for s in trainer.worker_stats]
    print(f"phase {label} on {[str(d) for d in mesh.device_list]}: {len(log.steps)} updates in {wall:.1f} s, "
          f"bit-identical to the budget-1 run; each worker stores {shard_bytes / 1e9:.3f} GB of the state's {whole_bytes / 1e9:.3f} GB "
          f"(spec count), between updates " + ", ".join(f"{min(b) / 1e9:.3f}-{max(b) / 1e9:.3f}" for b in between)
          + f" GB by worker; launches by worker {[s['launches']['fused_psgd'] for s in trainer.worker_stats]} "
          f"fused pSGD, {micro} microbatches | {smi}", flush=True)
    print_shard_times(label, times, smi)
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"wall_s": wall, "losses": log.losses, "shard_bytes": shard_bytes, "state_bytes": whole_bytes,
            "between_bytes": between, "launches": total, "microbatches": micro, **times}


def elastic_sharded(cfg, smi: str, reference) -> dict:
    """Phase 31: ElasticTrainer(param_axes=...) at budget 4 (the replicas
    of each width store their shards of ``embed``, FSDP): losses and params
    bit-identical to phase 26's budget 4 (and so budget 1's)."""
    import torch

    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models import LanguageModel

    gc.collect()
    torch.cuda.empty_cache()
    model = LanguageModel(cfg)
    params = model.init(0, device="cuda")
    log, wall, tr, state = elastic_run(cfg, params, 4, copy_params=False, param_axes=model.param_axes())
    same_as_reference("phase 31 elastic sharded", log, state.params, reference)
    launches = elastic_launch_check("phase 31 elastic sharded", tr, log, cfg.num_layers, "fused_psgd")
    times = shard_times(tr, log)
    times["peaks"] = shard_peak_check("31 elastic sharded", cfg, tr, make_data_mesh(4, ["meta"] * 4), smi)
    print(f"phase 31 elastic sharded budget 4: {len(log.steps)} updates in {wall:.1f} s, bit-identical to phase 26 "
          f"| {smi}", flush=True)
    print_shard_times("31 elastic sharded", times, smi)
    del state, params, tr
    gc.collect()
    torch.cuda.empty_cache()
    return {"wall_s": wall, "losses": log.losses, "launches": launches, **times}


# -- MoE experts over the mesh's model groups (phases 34-36) -----------------

EP_TOL = 1e-4  # the card at f32: losses, and each leaf against its norm, against the one-process run


def _expert_parallel_run(arch: str, smi: str) -> dict:
    """SEBSTrainer on a (2, 2) mesh of four workers on cuda:0 (host slots)
    and the same schedule in one process, ``arch`` smoke at f32, pSGD: SEBS
    b1 4, C1 8, rho 2, 3 stages of 64-token rows (6 updates), microbatch 2
    (widths 2, 4, 4: at width 2 ranks 2-3, a model group without rows,
    replay).
    Losses within EP_TOL relative, every param within EP_TOL of its leaf's
    norm; whether the bits matched is printed; launches exact."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import SEBS, SEBSTrainer
    from repro_torch.data import DataPipeline, TokenDataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.train import TrainState
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(arch, "smoke").replace(compute_dtype="float32")
    model = LanguageModel(cfg)
    runs = {}
    for mesh in (None, make_host_mesh(2, 2, devices=[torch.device("cuda", 0)] * 4)):
        opt = make_optimizer("psgd", gamma=1e4)
        pipe = DataPipeline(TokenDataset(cfg.vocab_size, 64, seed=0), "cuda" if mesh is None else mesh)
        kw = {"mesh": mesh, "param_axes": model.param_axes(), "deadline": ELASTIC_DEADLINE} if mesh else {}
        trainer = SEBSTrainer(model, opt, SEBS(b1=4, C1=8, rho=2.0, num_stages=3, eta=0.5), pipe,
                              microbatch=2, **kw)
        params = model.init(0, device="cuda")
        t0 = time.perf_counter()
        state, log = trainer.run(TrainState(params, opt.init(params), 0), log_every=1)
        runs[mesh is not None] = (log, [t.detach().cpu() for t in tree_leaves(state.params)], trainer,
                                  time.perf_counter() - t0)
    (ref, ref_params, _, _), (log, params, trainer, wall) = runs[False], runs[True]
    if log.stages != ref.stages or log.batch_sizes != ref.batch_sizes or not all(map(math.isfinite, log.losses)):
        fail(f"phase 34 {arch}: ladder {log.batch_sizes} vs {ref.batch_sizes}, losses {log.losses}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(log.losses, ref.losses, strict=True))
    leaf_rel = max(float((a - b).abs().max()) / float(b.norm()) for a, b in zip(params, ref_params, strict=True))
    if loss_rel > EP_TOL or leaf_rel > EP_TOL:
        fail(f"phase 34 {arch}: losses {loss_rel:.3g} / params {leaf_rel:.3g} from the one-process run "
             f"(allowed {EP_TOL})")
    bits = log.losses == ref.losses and all(torch.equal(a, b) for a, b in zip(params, ref_params))
    launches, _ = _mesh_launch_check(f"phase 34 {arch}", cfg, trainer, log, microbatch=2)
    experts_ms = [t["experts_s"] * 1e3 for t in trainer.worker_stats[0]["sharded"]]
    print(f"phase 34 {arch} smoke f32 on (2, 2) x cuda:0: {len(log.steps)} updates in {wall:.1f} s, losses within "
          f"{loss_rel:.3g} relative, params within {leaf_rel:.3g} of their norms of the one-process run "
          f"[{EP_TOL}]; bit-identical: {bits}; rank 0's experts' all-to-alls {sum(experts_ms):.1f} ms in all "
          f"| {smi}", flush=True)
    return {"wall_s": wall, "losses": log.losses, "reference_losses": ref.losses, "loss_rel": loss_rel,
            "leaf_rel": leaf_rel, "bits": bits, "launches": launches, "experts_ms": experts_ms}


def _mesh_launch_check(label: str, cfg, trainer, log, microbatch: int) -> tuple:
    """A mesh run's launches: each worker the flash forward (twice under
    remat) and backward once a layer for each microbatch it computed, the
    fused pSGD once an update on its shards. Returns their sums over the
    workers and each worker's microbatches."""
    from repro_torch.core.stages import StageController
    from repro_torch.distributed.planner import ElasticMeshPlanner

    n = len(trainer.worker_stats)
    planner = ElasticMeshPlanner(device_budget=n, devices=["cpu"] * n)
    micro = [0] * n
    for plan, _ in zip(StageController(trainer.controller.schedule, microbatch=microbatch).plans(), log.steps):
        mp = planner.plan_for(plan)
        for r in range(mp.width):
            micro[r] += mp.local_accum
    total: dict = {}
    fwd = 2 if cfg.remat else 1
    for r, stats in enumerate(trainer.worker_stats):
        got = stats["launches"]
        want = {"flash_attention_fwd": fwd * cfg.num_layers * micro[r],
                "flash_attention_bwd": cfg.num_layers * micro[r], "fused_psgd": len(log.steps)}
        if any(got[k] != v for k, v in want.items()):
            fail(f"{label}: worker {r} launched {got}, not {want}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    return total, micro


def expert_parallel_smoke(smi: str) -> dict:
    """Phase 34: the experts over the model groups on the card, dbrx and arctic smoke."""
    return {arch: _expert_parallel_run(arch, smi) for arch in ("dbrx-132b", "arctic-480b")}


def dbrx_expert_parallel(smi: str) -> dict:
    """Phase 35: dbrx-132b at full width cut to 1 of its 40 layers on a
    (1, 2) mesh, two workers on cuda:0, each holding 8 of the 16 experts:
    one update of 4 rows of 513 tokens (one microbatch of 2 a worker; the
    stage-2 shape's two microbatches a worker count 45.8 GB each, and two
    do not fit one card), pSGD. The state (17.7 GB) is built from a seed on
    rank 0's card and stays with the workers: nothing crosses the host.
    Each worker's peak within SHARD_PEAK_TOL of the dry run's count of its
    rank; the experts' all-to-all ms."""
    import torch

    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import SEBS, SEBSTrainer
    from repro_torch.data import DataPipeline, TokenDataset
    from repro_torch.distributed import run_on_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LanguageModel
    from repro_torch.obs import Tracer
    from repro_torch.optim import make_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = moe_cut("dbrx-132b", 1)
    model = LanguageModel(cfg)
    mesh = make_host_mesh(1, 2, devices=[torch.device("cuda", 0)] * 2)
    opt = make_optimizer("psgd", gamma=1e4)
    trainer = SEBSTrainer(model, opt, SEBS(b1=4, C1=4, rho=2.0, num_stages=1, eta=0.7),
                          DataPipeline(TokenDataset(cfg.vocab_size, 512, seed=0), mesh), mesh=mesh,
                          param_axes=model.param_axes(), microbatch=2, tracer=Tracer(), deadline=ELASTIC_DEADLINE)
    t0 = time.perf_counter()
    # two workers of ~29 GiB each share the card: expandable segments keep their caches from fragmenting
    # (the workers read the setting when they start; this process's allocator has started already)
    old_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        _, log = run_on_mesh(trainer, None, init_seed=0, log_every=1)
    finally:
        if old_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = old_conf
    wall = time.perf_counter() - t0
    if len(log.steps) != 1 or not math.isfinite(log.losses[0]):
        fail(f"phase 35: {len(log.steps)} updates, losses {log.losses}")
    meta_mesh = make_host_mesh(1, 2, devices=["meta"] * 2)
    peaks = shard_peak_check("35 dbrx (1, 2)", cfg, trainer, meta_mesh, smi, stage=0,
                             shape=InputShape("update", 513, 4, "train"))
    stats = trainer.worker_stats[0]
    rows = stats["sharded"][0]
    span = [ev["dur"] * 1e3 for ev in trainer.tracer.events if ev.get("name") == "train.update"]
    ex = rows["exchange"]
    out = {"wall_s": wall, "placement_s": stats["reshard_s"][0], "loss": log.losses[0],
           "update_ms": span[0], "experts_ms": rows["experts_s"] * 1e3, "gather_ms": rows["gather_s"] * 1e3,
           "exchange_ms": {p: ex[f"{p}_s"] * 1e3 for p in ("copy_out", "collective", "copy_back")},
           "optimizer_ms": rows["update_s"] * 1e3,
           "launches": {k: sum(s["launches"][k] for s in trainer.worker_stats) for k in stats["launches"]},
           "peaks": peaks}
    print(f"phase 35 dbrx-132b 1 layer on (1, 2) x cuda:0: loss {log.losses[0]:.4f}, update {span[0]:.1f} ms "
          f"(rank 0: the experts' all-to-alls {out['experts_ms']:.1f} ms, the gathers {out['gather_ms']:.1f}, "
          f"collectives' copy out / barriers / copy back " + " / ".join(f"{v:.1f}" for v in out["exchange_ms"].values())
          + f", optimizer {out['optimizer_ms']:.1f}); the run {wall:.1f} s, of which the first placement "
          f"{out['placement_s']:.1f} s | {smi}", flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_serving(smi: str) -> dict:
    """Phase 36: the sharded serving forward (``distributed/mesh_serve``) on
    a (2, 2) mesh of four workers on cuda:0, qwen2.5-3b and dbrx-132b smoke
    at f32: 4 prompts of 12 tokens, one a worker, a prefill and 3 greedy
    decode steps, each layer gathered where it runs (dbrx's experts over the
    model groups). Held to the single-process engine's calls
    (``prefill``, ``decode_step``) on the same rows: qwen bit-identical,
    dbrx within EP_TOL of the logits' scale."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.mesh_serve import serve_on_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LanguageModel

    out = {}
    mesh = make_host_mesh(2, 2, devices=[torch.device("cuda", 0)] * 4)
    runs = {}
    for arch in ("qwen2.5-3b", "dbrx-132b"):
        model = LanguageModel(get_config(arch, "smoke").replace(compute_dtype="float32"))
        tokens = np.random.default_rng(36).integers(0, model.cfg.vocab_size, (4, 12)).astype(np.int32)
        runs[arch] = (model, model.init(0, device="cuda"), tokens)
    t0 = time.perf_counter()
    served = dict(zip(runs, serve_on_mesh(mesh, list(runs.values()), 4, deadline=ELASTIC_DEADLINE)))
    wall = time.perf_counter() - t0  # one spawn of the four workers serves both
    for arch, (model, params, tokens) in runs.items():
        got = served[arch]
        want = []
        with torch.no_grad():
            for r in range(4):
                cache = model.init_cache(1, 16, dtype=torch.float32, device="cuda")
                logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens[r:r + 1]).cuda()}, cache)
                steps = [logits]
                for t in range(3):
                    nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
                    logits, cache = model.decode_step(params, nxt, cache,
                                                      torch.full((1,), 12 + t, dtype=torch.int32, device="cuda"))
                    steps.append(logits)
                want.append([x.float().cpu() for x in steps])
        want = [torch.cat([w[i] for w in want]) for i in range(4)]
        bits = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, want))
        if (arch == "qwen2.5-3b" and not bits) or err > EP_TOL:
            fail(f"phase 36 {arch}: the sharded forward's logits differ from the engine's by {err:.3g} of their "
                 f"scale (bit-identical: {bits})")
        print(f"phase 36 {arch} smoke f32, sharded prefill + 3 decode steps on (2, 2) x cuda:0 ({wall:.1f} s both): "
              f"logits within {err:.3g} of their scale of the single-process engine's, bit-identical: {bits} "
              f"| {smi}", flush=True)
        out[arch] = {"wall_s": wall, "rel_err": err, "bits": bits}
    return out


# -- disaggregated prefill/decode serving (phases 28-29) ---------------------

DISAGG = {"slots": 8, "cache_len": 2048, "page_size": 16, "chunk": 256, "prefill_slots": 2}


@contextlib.contextmanager
def sanitizers_on():
    """REPRO_SANITIZE=1 inside the block, the variable as it was after it."""
    import os

    old = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_SANITIZE"]
        else:
            os.environ["REPRO_SANITIZE"] = old


def seam_checks(engine) -> dict:
    """Wraps the engine's export and import steps. Each exported block is
    held against the prefill pool's pages and state row at export, bit for
    bit, and kept as a snapshot; at its adoption (FIFO, as the transfers
    are) the block must still equal its snapshot, and the decode pool's
    pages at the remapped ids and its state row must equal the block. Each
    step's device ms comes from CUDA events around it. Returns the record,
    filled as the engine runs; its "restore" puts the steps back."""
    import collections

    import numpy as np
    import torch

    from repro_torch.utils.tree import tree_leaves, tree_map

    model = engine.model
    rec = {"export_ms": [], "import_ms": [], "bad": []}
    snapshots = collections.deque()
    export, import_ = engine.prefill.export, engine.decode.import_

    def timed_call(device, fn, *args):
        with torch.cuda.device(device):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
        return out, start.elapsed_time(end)

    def all_true(flags) -> bool:
        return bool(torch.stack(flags).all()) if flags else True

    def checked_export(cache, page_ids, slot):
        block, ms = timed_call(engine.prefill_device, export, cache, page_ids, slot)
        rec["export_ms"].append(ms)
        flags = []
        model._map_paged(lambda full, part: flags.append((full[page_ids] == part).all()),
                         lambda full, part: flags.append((full[slot:slot + 1] == part).all()), cache, block)
        if not all_true(flags):
            rec["bad"].append(f"export {len(rec['export_ms'])}: the block differs from the prefill pool")
        snapshots.append(tree_map(torch.clone, block))
        return block

    def checked_import(cache, block, page_ids, slot):
        out, ms = timed_call(engine.decode_device, import_, cache, block, page_ids, slot)
        rec["import_ms"].append(ms)
        ids = np.asarray(page_ids, np.int64)
        lanes = torch.from_numpy(np.flatnonzero(ids)).to(engine.decode_device)
        dst = torch.from_numpy(ids[ids != 0]).to(engine.decode_device)
        flags = [(a == b.to(a.device)).all() for a, b in zip(tree_leaves(block), tree_leaves(snapshots.popleft()))]
        model._map_paged(lambda full, part: flags.append((full[dst] == part[lanes]).all()),
                         lambda full, part: flags.append((full[slot:slot + 1] == part).all()), out, block)
        if not all_true(flags):
            rec["bad"].append(f"import {len(rec['import_ms'])}: the decode pool differs from the block, "
                              "or the block changed while it waited at the seam")
        return out

    def restore():
        engine.prefill.export, engine.decode.import_ = export, import_

    engine.prefill.export, engine.decode.import_ = checked_export, checked_import
    rec["restore"] = restore
    return rec


def counted_serve(engine, prompts, new_tokens: int) -> tuple:
    """Serve ``prompts`` (even ones greedy, odd ones t=0.8 top_k=50) with
    every launch counter zeroed just before ``run()`` and read just after,
    the prefill worker's tail ticks and first-token samples counted.
    Returns (results in submission order, request ids, wall s, launches,
    {"tail_ticks", "first_tokens"})."""
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gla import ops as gla_ops
    from repro_torch.kernels.paged_decode import ops as paged_ops

    counts = {"tail_ticks": 0, "first_tokens": 0}
    tick, sample_first = engine.prefill.tick, engine._sample_first

    def counted_tick():
        step = tick()

        def run(*args, **kwargs):
            counts["tail_ticks"] += 1
            return step(*args, **kwargs)

        return run

    def counted_first(req, logits):
        counts["first_tokens"] += 1
        return sample_first(req, logits)

    engine.prefill.tick, engine._sample_first = counted_tick, counted_first
    ids = [engine.submit(p, max_new_tokens=new_tokens, temperature=0.0 if i % 2 == 0 else 0.8,
                         top_k=0 if i % 2 == 0 else 50) for i, p in enumerate(prompts)]
    devices = {engine.prefill_device, engine.decode_device}
    for d in devices:
        torch.cuda.synchronize(d)
    for ops in (paged_ops, gla_ops, flash_ops):
        ops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run()
    for d in devices:
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    launches = {**paged_ops.LAUNCHES, **gla_ops.LAUNCHES, **flash_ops.LAUNCHES}
    engine.prefill.tick, engine._sample_first = tick, sample_first
    return [results[rid] for rid in ids], ids, wall, launches, counts


def serve_disagg(label: str, cfg, warmup, prompts, fresh_prompts, reference: list, reference_tick_ms: float,
                 reference_ttft_ms: float, devices=None) -> dict:
    """Phases 28-29: the disaggregated engine serving ``cfg`` at full width,
    both workers on cuda:0 (two pools, two caches, the export / move /
    import seam; ``devices``, a (prefill, decode) pair, puts them on two
    cards instead), on phase 4's traffic: 8 slots, cache 2048, pages of 16,
    256-token chunks, prefill ring 2. After the warm-up request ``warmup``
    (as the paged run before it had), a checked run on ``prompts`` under
    REPRO_SANITIZE=1 with the seam wrapped (seam_checks) and the counters
    zeroed just before and read just after: every request completes, 8
    transfers, the greedy streams equal ``reference`` (the paged engine's on
    the same weights and prompts) bit for bit, the blocks bit-exact across
    the seam, the launches those the stats predict (the paged decode once
    an attention layer a decode tick and a tail tick, the chunk prefill once
    an attention layer a chunk, the GLA forward once a Mamba2 layer a chunk,
    the sampler once a tick and a first token), the decode worker without a
    chunk step and the prefill worker with at most one a size and one tail
    tick at width 2, both workers on the same weight tensors. Then a timed
    run, sanitizers off and nothing wrapped, on ``fresh_prompts`` (phase 4's
    shape, new suffixes): tok/s, the median decode tick against the paged
    engine's, TTFT p50, the seam's bytes, export and import ms, both pools'
    peaks and the peak memory."""
    import numpy as np
    import torch

    from repro_torch.analysis import sanitize
    from repro_torch.models import LanguageModel
    from repro_torch.serve import DisaggregatedEngine
    from repro_torch.utils.tree import tree_leaves

    attn = sum(seg.repeat for seg in cfg.segments if seg.shared_attn) + sum(
        seg.repeat * sum(b.mixer in ("attn", "swa") for b in seg.body) for seg in cfg.segments)
    mamba = sum(seg.repeat * sum(b.mixer == "mamba2" for b in seg.body) for seg in cfg.segments)
    pair = tuple(devices or (torch.device("cuda", 0),) * 2)
    model = LanguageModel(cfg)
    params = model.init(seed=0, device=pair[0])
    for d in set(pair):
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    engine = DisaggregatedEngine(
        model, params, max_slots=DISAGG["slots"], page_size=DISAGG["page_size"], cache_len=DISAGG["cache_len"],
        prefill_chunks=(DISAGG["chunk"],), prefill_slots=DISAGG["prefill_slots"], seed=0,
        prefill_device=pair[0], decode_device=pair[1],
    )
    if (engine.prefill_device, engine.decode_device) != pair:
        fail(f"{label}: the workers are on {engine.prefill_device} and {engine.decode_device}, not {pair}")
    if not all(a is b and (b is c) == (pair[0] == pair[1]) for a, b, c in zip(
            tree_leaves(params), tree_leaves(engine.prefill.params), tree_leaves(engine.decode.params))):
        fail(f"{label}: the workers do not share the weight tensors on one card (or copy them to a second)")

    def expect_launches(stats, counts) -> dict:
        ticks = stats["ticks"] + counts["tail_ticks"]
        return {"paged_flash_decode": attn * ticks, "paged_chunk_prefill": attn * stats["prefill_chunks"],
                "fused_sample": ticks + counts["first_tokens"], "gla_fwd": mamba * stats["prefill_chunks"],
                "gla_bwd": 0, "flash_attention_fwd": 0, "flash_attention_bwd": 0}

    def check_launches(what, launches, stats, counts):
        for kname, n in expect_launches(stats, counts).items():
            if launches.get(kname, 0) != n:
                fail(f"{label} {what}: {kname} launched {launches.get(kname, 0)} times, not {n} "
                     f"(stats {dict((k, stats[k]) for k in ('ticks', 'prefill_chunks'))}, {counts})")

    new = 32
    try:
        with sanitizers_on():
            if not sanitize.enabled():
                fail(f"{label}: REPRO_SANITIZE=1 did not enable the sanitizers")
            engine.submit(warmup, max_new_tokens=4)
            engine.run()
            engine.reset_stats()
            seam = seam_checks(engine)
            streams, ids, checked_wall, launches, counts = counted_serve(engine, prompts, new)
            seam.pop("restore")()
    except sanitize.SanitizerError as e:
        fail(f"{label}: a sanitizer fired: {e}")
    stats = copy.deepcopy(engine.stats)
    for row in streams:
        if len(row) != len(prompts[0]) + new or row.min() < 0 or row.max() >= cfg.vocab_size:
            fail(f"{label}: bad stream {row[len(prompts[0]):].tolist()}")
    if stats["transfers"] != len(prompts):
        fail(f"{label}: {stats['transfers']} transfers, not {len(prompts)}")
    for i in range(0, len(prompts), 2):
        if not np.array_equal(streams[i], reference[i // 2]):
            fail(f"{label}: greedy request {i} differs from the paged engine's: "
                 f"{streams[i][len(prompts[0]):].tolist()} vs {reference[i // 2][len(prompts[0]):].tolist()}")
    if seam["bad"] or len(seam["export_ms"]) != len(prompts) or len(seam["import_ms"]) != len(prompts):
        fail(f"{label}: seam {seam['bad']}, {len(seam['export_ms'])} exports, {len(seam['import_ms'])} imports")
    check_launches("checked run", launches, stats, counts)
    if engine.decode._chunk_steps or engine.decode.prefill_chunks:
        fail(f"{label}: the decode worker built chunk steps {sorted(engine.decode._chunk_steps)}")
    if not set(engine.prefill._chunk_steps) <= {DISAGG["chunk"]} or not set(engine.prefill._decodes) <= {2}:
        fail(f"{label}: the prefill worker built chunk steps {sorted(engine.prefill._chunk_steps)} and ticks "
             f"{sorted(engine.prefill._decodes)}")
    for worker in (engine.prefill, engine.decode):
        worker.pool.check()

    # the timed run: the same shape of traffic, nothing wrapped, sanitizers off
    engine.reset_stats()
    for d in set(pair):
        torch.cuda.reset_peak_memory_stats(d)
    _, tids, wall, tlaunches, tcounts = counted_serve(engine, fresh_prompts, new)
    tstats, mem = copy.deepcopy(engine.stats), engine.memory_stats()
    check_launches("timed run", tlaunches, tstats, tcounts)
    peak = max(torch.cuda.max_memory_allocated(d) for d in set(pair))
    tick_ms = float(np.median(tstats["decode_tick_s"])) * 1e3
    ttft_ms = float(np.median([engine.scheduler.requests[rid].ttft_s for rid in tids])) * 1e3
    export_ms, import_ms = float(np.median(seam["export_ms"])), float(np.median(seam["import_ms"]))
    print(f"{label} disagg: {len(tids)} requests x {new} tokens in {wall:.3f} s | decode {tstats['decoded_tokens']} "
          f"tokens = {tstats['decoded_tokens'] / wall:.1f} tok/s | median decode tick {tick_ms:.2f} ms "
          f"(the paged engine's {reference_tick_ms:.2f}) | TTFT p50 {ttft_ms:.1f} ms (the paged engine's "
          f"{reference_ttft_ms:.1f}) | {tstats['transfers']} transfers, {tstats['pages_streamed']} pages "
          f"streamed, {tstats['pages_adopted']} adopted, seam {tstats['seam_bytes']} bytes | export "
          f"{export_ms:.3f} ms, import {import_ms:.3f} ms (median device ms of the checked run) | pools' peaks: "
          f"prefill {mem['prefill_pages_peak']}/{mem['prefill_pages_capacity']}, decode "
          f"{mem['pages_peak']}/{mem['pages_capacity']} | peak memory {peak / 2**30:.1f} GiB", flush=True)
    print(f"{label} disagg checked run (REPRO_SANITIZE=1, the seam checked): {checked_wall:.3f} s, no sanitizer "
          f"error; greedy streams equal the paged engine's; {len(seam['export_ms'])} blocks bit-exact across the "
          f"seam | launches {launches} = predicted ({stats['ticks']} decode ticks, {counts['tail_ticks']} tail "
          f"ticks, {stats['prefill_chunks']} chunks, {counts['first_tokens']} first tokens) | steps built: decode "
          f"{sorted(engine.decode._decodes)}, prefill chunk {sorted(engine.prefill._chunk_steps)}, tail "
          f"{sorted(engine.prefill._decodes)}", flush=True)
    out = {"wall_s": wall, "decoded_tokens": tstats["decoded_tokens"], "tok_s": tstats["decoded_tokens"] / wall,
           "median_decode_tick_ms": tick_ms, "reference_decode_tick_ms": reference_tick_ms,
           "ttft_p50_ms": ttft_ms, "reference_ttft_p50_ms": reference_ttft_ms, "transfers": tstats["transfers"],
           "pages_streamed": tstats["pages_streamed"], "pages_adopted": tstats["pages_adopted"],
           "seam_bytes": tstats["seam_bytes"], "export_ms": seam["export_ms"], "import_ms": seam["import_ms"],
           "memory": mem, "peak_gib": peak / 2**30, "checked_wall_s": checked_wall,
           "launches": {k: launches.get(k, 0) + tlaunches.get(k, 0) for k in set(launches) | set(tlaunches)},
           "checked": {"ticks": stats["ticks"], "prefill_chunks": stats["prefill_chunks"], **counts}}
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def disagg_small_input_agreement(arch: str, smoke=None) -> None:
    """Greedy tokens of the disaggregated engine on the card (kernels) equal
    the CPU path's (plain versions) on ``arch`` smoke (or ``smoke``) in
    float32, under REPRO_SANITIZE=1."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.serve import DisaggregatedEngine

    cfg = (smoke or get_config(arch, "smoke")).replace(compute_dtype="float32")
    model = LanguageModel(cfg)
    cpu_params = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 9)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 3 + i)]) for i in range(5)] + [prefix]
    streams = {}
    with sanitizers_on():
        for device in ("cpu", "cuda"):
            engine = DisaggregatedEngine(model, to_device(cpu_params, device), cache_len=64, max_slots=2,
                                         page_size=4, prefill_chunks=(4,), prefill_slots=2, seed=0, device=device)
            ids = [engine.submit(p, max_new_tokens=5) for p in prompts]
            out = engine.run()
            streams[device] = [out[i].tolist() for i in ids]
    if streams["cpu"] != streams["cuda"]:
        fail(f"{arch} disaggregated small-input greedy tokens differ: cpu {streams['cpu']} vs cuda {streams['cuda']}")



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

    phase_s: dict = {}  # wall seconds of each phase, in the order run
    t_phase = time.perf_counter()

    def phase_done(label: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[label] = now - t_phase
        t_phase = now

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
            # the GLA kernels' own lines name the kernel each register count is for
            if ("registers" in line or "spill" in line or "Performance Loss" in line
                    or (lib == "gla" and "Compiling entry" in line)):
                print(f"ptxas[{lib}]: {line.strip()}")
    hgmma = hgmma_counts()
    print("sass HGMMA per flash kernel: " + ", ".join(f"{n} {c}" for n, c in hgmma.items()), flush=True)
    for kname, count in hgmma.items():
        if "_tc_kernel" in kname and count == 0:
            fail(f"{kname} has no HGMMA in its SASS: the bf16 route is not on the tensor cores")
    for kname in FLASH_TC_KERNELS:
        if hgmma.get(kname, 0) == 0:
            fail(f"{kname} is missing or has no HGMMA in its SASS")
    gla_mma = gla_tensor_op_counts()
    print("sass HMMA/HGMMA per GLA kernel: " + ", ".join(f"{n} {c}" for n, c in gla_mma.items()), flush=True)
    for kname in GLA_TC_KERNELS:
        if gla_mma.get(kname, 0) == 0:
            fail(f"{kname} has no HMMA or HGMMA in its SASS: the bf16 GLA route is not on the tensor cores")
    paged_mma = paged_tensor_op_counts()
    print("sass HMMA/HGMMA per paged-attention kernel: " + ", ".join(f"{n} {c}" for n, c in paged_mma.items()),
          flush=True)
    for kname in PAGED_TC_KERNELS:
        if paged_mma.get(kname, 0) == 0:
            fail(f"{kname} has no HMMA or HGMMA in its SASS: the bf16 paged route is not on the tensor cores")

    phase_done("1-2 device, build")
    # 3. kernels against their plain versions
    cfg = get_config("qwen2.5-3b", "full")
    reduced = cfg.replace(segments=(SegmentSpec(body=cfg.segments[0].body, repeat=8),))
    records: dict = {}
    decode_serving = kernel_checks(records)
    flash_checks(records)
    fused_checks(records, {"fused_psgd": leaf_shapes(cfg), "fused_momentum": leaf_shapes(reduced),
                           "fused_adagrad_da": leaf_shapes(reduced)})
    gla_serving_shape = gla_checks(records)
    zamba2_kernel_checks(records)
    moe_kernel_checks(records)
    fwd_rec, bwd_rec = records["flash_attention_fwd"], records["flash_attention_bwd"]
    print(f"flash yardstick, ms a call (device ms in brackets): SDPA ({fwd_rec['library_backend']}) fwd "
          f"{fwd_rec['library_ms']:.4f} ({fwd_rec['library_device_ms']:.4f}), bwd {bwd_rec['library_ms']:.4f} "
          f"({bwd_rec['library_device_ms']:.4f}); default dispatch fwd {fwd_rec['library_ms_default']:.4f} "
          f"({fwd_rec['library_device_ms_default']:.4f}), bwd {bwd_rec['library_ms_default']:.4f} "
          f"({bwd_rec['library_device_ms_default']:.4f}) | kernels fwd {fwd_rec['ms']:.4f} "
          f"({fwd_rec['device_ms']:.4f}), bwd {bwd_rec['ms']:.4f} ({bwd_rec['device_ms']:.4f})"
          f" | f32 route, in units of its allowance: " + ", ".join(
              f"D {d[1:]} fwd {r['fwd_excess']:.3f} bwd {r['bwd_excess']:.3f}"
              for d, r in fwd_rec["f32_route"].items())
          + " | serving prefills (bf16), in units of the allowance: " + ", ".join(
              f"{n} {r['excess']:.3f} vs planted fault {r['fault_excess']:.1f}"
              for n, r in fwd_rec["serving_prefill"].items()), flush=True)
    print(f"paged, ms a call L2-cold (device ms in brackets): decode {records['paged_flash_decode']['ms']:.4f} "
          f"({records['paged_flash_decode']['device_ms']:.4f}), decode at the serving shape "
          f"{decode_serving['ms']:.4f} ({decode_serving['device_ms']:.4f}), prefill "
          f"{records['paged_chunk_prefill']['ms']:.4f} ({records['paged_chunk_prefill']['device_ms']:.4f}), "
          f"sampler " + ", ".join(f"{n} {r['ms']:.4f} ({r['device_ms']:.4f}, bound {r['bound'][0]:.5f}, "
                                  f"{r['splits']} splits a row)"
                                  for n, r in records["fused_sample"]["shapes"].items()), flush=True)
    chunk = records["gla_fwd_mamba2"]["serving_chunk"]
    print("zamba2's shapes, ms a call L2-cold (device ms in brackets; bound): " + ", ".join(
        f"{n} {records[n]['ms']:.4f} ({records[n]['device_ms']:.4f}; {records[n]['bound'][0]:.5f})"
        for n in ("flash_attention_fwd_d80", "flash_attention_bwd_d80", "paged_flash_decode_d80",
                  "paged_chunk_prefill_d80", "gla_fwd_mamba2", "gla_bwd_mamba2"))
          + f" | SDPA ({records['flash_attention_fwd_d80']['library_backend']}) D 80 fwd "
          f"{records['flash_attention_fwd_d80']['library_ms']:.4f}, bwd "
          f"{records['flash_attention_bwd_d80']['library_ms']:.4f} | bound from Mamba2's own operands: fwd "
          f"{records['gla_fwd_mamba2']['bound_own_operands'][0]:.5f}, bwd "
          f"{records['gla_bwd_mamba2']['bound_own_operands'][0]:.5f} | Mamba2 GLA fwd at the paged prefill "
          f"chunk (B 1, S 256) {chunk['ms']:.4f} ({chunk['device_ms']:.4f}; {chunk['bound'][0]:.5f})",
          flush=True)
    print("the MoE family's shapes, ms a call L2-cold (device ms in brackets; bound; plain): " + ", ".join(
        f"{n} {records[n]['ms']:.4f} ({records[n]['device_ms']:.4f}; {records[n]['bound'][0]:.5f}; "
        f"{records[n]['plain_ms']:.3f})"
        for n in ("flash_attention_fwd_g6", "flash_attention_bwd_g6", "flash_attention_fwd_g7",
                  "paged_flash_decode_g6", "paged_flash_decode_g7", "paged_chunk_prefill_g6",
                  "paged_chunk_prefill_g7", "fused_sample_v100352", "fused_sample_v32000"))
          + f" | SDPA ({records['flash_attention_fwd_g6']['library_backend']}) G 6 fwd "
          f"{records['flash_attention_fwd_g6']['library_ms']:.4f}, bwd {records['flash_attention_bwd_g6']['library_ms']:.4f}"
          f"; ({records['flash_attention_fwd_g7']['library_backend']}) G 7 fwd "
          f"{records['flash_attention_fwd_g7']['library_ms']:.4f} | fused pSGD over dbrx's expert tensors "
          f"{records['fused_psgd_dbrx']['ms']:.3f} ms ({records['fused_psgd_dbrx']['elements']} elements; bound "
          f"{records['fused_psgd_dbrx']['bound'][0]:.3f})", flush=True)
    print(f"gla, ms a call L2-cold (device ms in brackets): fwd {records['gla_fwd']['ms']:.4f} "
          f"({records['gla_fwd']['device_ms']:.4f}), bwd {records['gla_bwd']['ms']:.4f} "
          f"({records['gla_bwd']['device_ms']:.4f}), fwd at the serving shape {gla_serving_shape['ms']:.4f} "
          f"({gla_serving_shape['device_ms']:.4f})", flush=True)
    print("kernel checks: ok | tolerance readings, in units of the allowance (sound <= 1 < planted "
          "fault): " + ", ".join(f"{n} {r['excess']:.3f} vs {r['fault_excess']:.1f}"
                                 for n, r in records.items() if "excess" in r)
          + " | fused updates bit-equal over " + ", ".join(
              f"{n} {r['elements']} elements in {r['leaves']} leaves"
              for n, r in records.items() if "elements" in r), flush=True)

    phase_done("3 kernels")
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

    served = []  # each batch's prompts: phase 12 serves the measured one again

    def submit_batch():
        served.append([prompt() for _ in range(8)])
        return [
            engine.submit(p, max_new_tokens=32,
                          temperature=0.0 if i % 2 == 0 else 0.8, top_k=0 if i % 2 == 0 else 50)
            for i, p in enumerate(served[-1])
        ]

    # warm-up: one request publishes the shared prefix to the radix index
    warmup = prompt()
    engine.submit(warmup, max_new_tokens=4)
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
    # phase 28 serves the same requests through the disaggregated engine
    paged_greedy = [results[rid] for rid in ids[::2]]
    paged_ttft_ms = sorted(engine.scheduler.requests[rid].ttft_s for rid in ids)[len(ids) // 2] * 1e3
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
    profile = device_profile(engine.run, submit_batch)
    engine.pool.check()
    print(f"profile: device busy {profile['busy_ms']:.1f} ms of {profile['wall_ms']:.1f} ms wall, idle "
          f"{100 * profile['idle_share']:.1f}% | {profile['activities']} device activities | traced "
          f"run {profile['wall_ms'] / (wall * 1e3):.2f} x the untraced one | paged decode "
          f"{profile['paged_decode_ms']:.2f} ms, prefill {profile['paged_prefill_ms']:.2f} ms, sampler "
          f"{profile['sampler_ms']:.3f} ms over {profile['sampler_launches']} launches", flush=True)
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
    del engine, probe, results
    gc.collect()
    torch.cuda.empty_cache()

    phase_done("4-6 paged serving")
    # 12. dense serving at full width (the same weights), the static and continuous engines
    dense = serve_dense(cfg, model, params, served[0])
    del params
    gc.collect()
    torch.cuda.empty_cache()

    phase_done("12 dense serving")
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
    train_profile, untraced_ms, _ = trace_update("train", trainer, state, psgd, ETAS["psgd"])
    phase_done("7, 9 psgd training")
    # 32. the dry run and the roofline: phase 7's stage-2 update under each remat
    # policy on the card; the dry run's counts (of it, and of train_4k on meta
    # tensors) run in worker processes beside phases 7b-8 and are read after phase 8
    remat_started = remat_start(cfg, trainer, state, psgd, ETAS["psgd"])
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()

    phase_done("32 remat policies on the card")
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

    phase_done("7b momentum, adagrad_da")
    # 14. the adaptive optimizers, full width at 8 layers
    adaptive = adaptive_optimizers(reduced)

    phase_done("14 adaptive")
    # 13. kill and resume, full width at 4 layers
    resume = resume_full_width(cfg.replace(segments=(SegmentSpec(body=cfg.segments[0].body, repeat=4),)))

    phase_done("13 resume")
    # 8. card against CPU on a small input
    agreement = card_cpu_agreement("qwen2.5-3b")

    phase_done("8 card vs cpu")
    remat = remat_finish(remat_started, smi)
    phase_done("32 the dry run's counts (waited)")
    # 10-11. rwkv6-1.6b at full width: served, then trained, through the GLA kernels
    rwkv = get_config("rwkv6-1.6b", "full")
    rwkv_serving = serve_rwkv6(rwkv)
    phase_done("10 rwkv6 serving")
    rwkv_training = train_rwkv6(rwkv)
    phase_done("11 rwkv6 training")
    # 15-16. zamba2-2.7b at full width: served, then trained (Mamba2 through the GLA
    # kernels with the current token included, the shared attention at D 80)
    zamba2 = get_config("zamba2-2.7b", "full")
    zamba2_kept: dict = {}  # phase 29 serves phase 15's requests again
    zamba2_serving = serve_zamba2(zamba2, zamba2_kept)
    phase_done("15 zamba2 serving")
    zamba2_training = train_zamba2(zamba2)
    phase_done("16 zamba2 training")
    # 17. gemma2-9b training at full width, cut to 8 of its 42 layers
    gemma2 = get_config("gemma2-9b", "full")
    gemma2 = gemma2.replace(segments=(dataclasses.replace(gemma2.segments[0], repeat=4),))
    gemma2_training = train_gemma2(gemma2)
    phase_done("17 gemma2 training")
    # 18-20. the MoE family at full width, layers cut to fit one card
    dbrx_serving = serve_dbrx(moe_cut("dbrx-132b", MOE_LAYERS["dbrx_serving"]))
    phase_done("18 dbrx serving")
    dbrx_training = train_dbrx(moe_cut("dbrx-132b", MOE_LAYERS["dbrx_training"]))
    phase_done("19 dbrx training")
    arctic_serving = serve_arctic(moe_cut("arctic-480b", MOE_LAYERS["arctic_serving"]))
    phase_done("20 arctic serving")
    # 21-24. whisper-tiny: the kernels at its shapes, then served and trained
    # at full width (the whole model), then card against CPU on its smoke
    whisper_kernel_checks(records)
    phase_done("21 whisper kernels")
    whisper = get_config("whisper-tiny", "full")
    whisper_serving = serve_whisper(whisper)
    phase_done("22 whisper serving")
    whisper_training = train_whisper(whisper)
    phase_done("23 whisper training")
    whisper_agreement = whisper_card_cpu_agreement()
    phase_done("24 whisper card vs cpu")
    # 25. the paper's own experiments: Fig. 3, Fig. 2, adaptive SEBS, ResNet-20
    experiments = paper_experiments()
    phase_done("25 the paper's experiments")
    # 33. the paper's Fig. 1: time a sample against the batch, at smoke size and full width
    fig1 = fig1_phase(smi)
    phase_done("33 fig. 1")
    # 26-27. elastic multi-worker SEBS training: up to four workers share the card
    gc.collect()
    torch.cuda.empty_cache()
    elastic_cfg = elastic_cut(get_config("qwen2.5-3b", "full"))
    elastic, elastic_reference = elastic_exact(elastic_cfg, smi)
    phase_done("26 elastic exact sync")
    local_sgd = elastic_local(elastic_cfg, smi)
    phase_done("27 elastic local SGD")
    # 30-31. rule-based storage sharding: SEBSTrainer on a (2, 2) mesh of four workers on the card, and
    # ElasticTrainer with param_axes at budget 4, both held to phase 26's budget-1 run
    sharded = {"mesh": mesh_sharded(elastic_cfg, smi, elastic_reference)}
    phase_done("30 sharded mesh (2, 2)")
    sharded["elastic"] = elastic_sharded(elastic_cfg, smi, elastic_reference)
    del elastic_reference
    phase_done("31 elastic sharded")
    # 34-36. an MoE layer's experts over the mesh's model groups: the (2, 2) runs at smoke size held to the
    # one-process run, dbrx-132b at full width on (1, 2), and the sharded serving forward
    experts = {"smoke": expert_parallel_smoke(smi)}
    phase_done("34 experts over model groups, smoke")
    experts["dbrx"] = dbrx_expert_parallel(smi)
    phase_done("35 dbrx experts on (1, 2)")
    experts["serving"] = sharded_serving(smi)
    phase_done("36 sharded serving forward")
    # 28-29. disaggregated prefill/decode serving, both workers on the card,
    # on phase 4's and phase 15's weights and requests, under the sanitizers
    gc.collect()
    torch.cuda.empty_cache()
    disagg = {}
    for key, arch_cfg, kept, seed in (
            ("qwen2.5-3b", cfg, {"warmup": warmup, "prompts": served[0], "prefix": prefix, "greedy": paged_greedy,
                                 "tick_ms": decode_tick_ms, "ttft_ms": paged_ttft_ms}, 28),
            ("zamba2-2.7b", zamba2, {**zamba2_kept, "tick_ms": zamba2_serving["median_decode_tick_ms"]}, 29)):
        fresh_rng = torch.Generator().manual_seed(seed)
        fresh = [torch.cat([kept["prefix"], torch.randint(0, arch_cfg.vocab_size, (256,), generator=fresh_rng)])
                 .numpy() for _ in range(8)]
        disagg[key] = serve_disagg(f"phase {seed}", arch_cfg, kept["warmup"], kept["prompts"], fresh,
                                   kept["greedy"], kept["tick_ms"], kept["ttft_ms"])
        phase_done(f"{seed} {key} disaggregated serving")
    for arch, small in (("qwen2.5-3b", None), ("rwkv6-1.6b", None), ("zamba2-2.7b", zamba2_smoke())):
        disagg_small_input_agreement(arch, small)
    print("phase 29 disagg small input: greedy tokens of the disaggregated engine on the card equal the CPU "
          "path's on qwen2.5-3b, rwkv6-1.6b and zamba2-2.7b smoke (ssm_state 64), f32, under REPRO_SANITIZE=1",
          flush=True)
    phase_done("28-29 disagg small input")
    print("phase seconds: " + ", ".join(f"{n} {x:.1f}" for n, x in phase_s.items())
          + f" | total {sum(phase_s.values()):.1f}", flush=True)

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
    for kname in ("flash_attention_fwd", "flash_attention_bwd", "paged_flash_decode", "paged_chunk_prefill"):
        replaces[f"{kname}_d80"] = replaces[kname]
    for kname in ("gla_fwd", "gla_bwd"):
        replaces[f"{kname}_mamba2"] = replaces[kname]
    for kname in ("flash_attention_fwd_g6", "flash_attention_bwd_g6", "flash_attention_fwd_g7",
                  "paged_flash_decode_g6", "paged_flash_decode_g7", "paged_chunk_prefill_g6",
                  "paged_chunk_prefill_g7", "fused_sample_v100352", "fused_sample_v32000", "fused_psgd_dbrx"):
        replaces[kname] = replaces[kname.rsplit("_", 1)[0]]
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
    sources.update({f"{n}{suffix}": sources[n] for n in list(sources)
                    for suffix in ("_d80", "_mamba2", "_g6", "_g7", "_v100352", "_v32000", "_dbrx")})
    all_launches = {**launches, **train_launches}
    # the dense serving path (phase 12) runs the flash forward and the sampler too
    for kname in ("flash_attention_fwd", "fused_sample"):
        all_launches[kname] += dense["launches"][kname]
    # the GLA kernels run on both rwkv6 paths: serving (the forward) and training
    for kname in ("gla_fwd", "gla_bwd"):
        all_launches[kname] = rwkv_serving["launches"].get(kname, 0) + rwkv_training["launches"][kname]
    # zamba2's paths (phases 15-16) launch the D 80 attention kernels and GLA with the
    # current token included
    zamba2_paths = (zamba2_serving["launches"], zamba2_serving["static"]["launches"],
                    zamba2_training["launches"])
    for kname in ("flash_attention_fwd", "flash_attention_bwd", "paged_flash_decode", "paged_chunk_prefill"):
        all_launches[f"{kname}_d80"] = sum(run.get(kname, 0) for run in zamba2_paths)
    for kname in ("gla_fwd", "gla_bwd"):
        all_launches[f"{kname}_mamba2"] = sum(run.get(kname, 0) for run in zamba2_paths)
    # the MoE family's paths (phases 18-20): dbrx's G 6 and vocabulary of 100,352,
    # arctic's G 7 and 32,000
    dbrx_paths = (dbrx_serving["launches"], dbrx_serving["continuous"]["launches"],
                  dbrx_serving["static"]["launches"], dbrx_training["launches"])
    arctic_paths = (arctic_serving["launches"], arctic_serving["static"]["launches"])
    for suffix, paths in (("_g6", dbrx_paths), ("_g7", arctic_paths)):
        for kname in ("flash_attention_fwd", "flash_attention_bwd", "paged_flash_decode", "paged_chunk_prefill"):
            if kname + suffix in records:
                all_launches[kname + suffix] = sum(run.get(kname, 0) for run in paths)
    all_launches["fused_sample_v100352"] = sum(run.get("fused_sample", 0) for run in dbrx_paths)
    all_launches["fused_sample_v32000"] = sum(run.get("fused_sample", 0) for run in arctic_paths)
    all_launches["fused_psgd_dbrx"] = dbrx_training["launches"]["fused_psgd"]
    # whisper's paths (phases 22-23): the encoder's flash launches, counted
    # apart as the non-causal ones, and the decoder's, the causal rest
    for part in ("encoder", "decoder"):
        suffix = "_whisper_enc" if part == "encoder" else "_whisper_dec"
        all_launches["flash_attention_fwd" + suffix] = (whisper_serving[f"{part}_fwd"]
                                                        + whisper_training[f"{part}_fwd"])
        all_launches["flash_attention_bwd" + suffix] = whisper_training[f"{part}_bwd"]
    for kname in ("paged_flash_decode", "paged_chunk_prefill"):
        all_launches[kname + "_whisper"] = whisper_serving["launches"][kname]
    all_launches["fused_sample_v51865"] = (whisper_serving["launches"]["fused_sample"]
                                           + whisper_serving["continuous"]["launches"]["fused_sample"])
    for kname in ("fused_psgd", "fused_momentum", "fused_adagrad_da"):
        all_launches[kname + "_resnet"] = sum(m["launches"][kname] for m in experiments["fig3"].values())
    for kname, base in (("flash_attention_fwd_whisper_enc", "flash_attention_fwd"),
                        ("flash_attention_bwd_whisper_enc", "flash_attention_bwd"),
                        ("flash_attention_fwd_whisper_dec", "flash_attention_fwd"),
                        ("flash_attention_bwd_whisper_dec", "flash_attention_bwd"),
                        ("paged_flash_decode_whisper", "paged_flash_decode"),
                        ("paged_chunk_prefill_whisper", "paged_chunk_prefill"),
                        ("fused_sample_v51865", "fused_sample"), ("fused_psgd_resnet", "fused_psgd"),
                        ("fused_momentum_resnet", "fused_momentum"), ("fused_adagrad_da_resnet", "fused_adagrad_da")):
        replaces[kname], sources[kname] = replaces[base], sources[base]
    # phase 32's updates, two a remat policy (``launches`` are an update's)
    for kname in ("flash_attention_fwd", "flash_attention_bwd", "fused_psgd"):
        all_launches[kname] += sum(len(r["ms_runs"]) * r["launches"][kname] for r in remat["update"].values())
    # the elastic paths (phases 26-27): every worker's launches, added over ranks and runs
    for kname in ("flash_attention_fwd", "flash_attention_bwd", "fused_psgd"):
        all_launches[kname] += elastic["launches"][kname]
    for kname in ("flash_attention_fwd", "flash_attention_bwd", "fused_momentum"):
        all_launches[kname] += local_sgd["launches"][kname]
    # the sharded paths (phases 30-31): every worker's launches, added over ranks
    for kname in ("flash_attention_fwd", "flash_attention_bwd", "fused_psgd"):
        all_launches[kname] += sharded["mesh"]["launches"][kname] + sharded["elastic"]["launches"][kname]
    # the experts over the model groups (phases 34-35): every worker's launches; dbrx's attention at G 6
    for kname in ("flash_attention_fwd", "flash_attention_bwd", "fused_psgd"):
        all_launches[kname] += sum(run["launches"][kname] for run in experts["smoke"].values())
    all_launches["fused_psgd"] += experts["dbrx"]["launches"]["fused_psgd"]
    for kname in ("flash_attention_fwd", "flash_attention_bwd"):
        if kname + "_g6" in records:
            all_launches[kname + "_g6"] += experts["dbrx"]["launches"][kname]
    # Fig. 1 (phase 33), at smoke size and full width
    for kname in ("flash_attention_fwd", "flash_attention_bwd", "fused_momentum"):
        all_launches[kname] += sum(fig1[v]["launches"][kname] for v in ("smoke", "full"))
    # the disaggregated paths (phases 28-29): qwen2.5-3b's kernels and zamba2's D 80
    # attention, Mamba2's GLA and its sampler at V 32,000
    for kname in ("paged_flash_decode", "paged_chunk_prefill", "fused_sample"):
        all_launches[kname] += disagg["qwen2.5-3b"]["launches"][kname]
    zamba2_disagg = disagg["zamba2-2.7b"]["launches"]
    for kname in ("paged_flash_decode", "paged_chunk_prefill"):
        all_launches[f"{kname}_d80"] += zamba2_disagg[kname]
    all_launches["gla_fwd_mamba2"] += zamba2_disagg["gla_fwd"]
    all_launches["fused_sample_v32000"] += zamba2_disagg["fused_sample"]
    unlaunched = [kname for kname in records if all_launches.get(kname, 0) <= 0]
    if unlaunched:
        fail(f"kernels not launched on their main paths: {unlaunched}")
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
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        **record, "nvidia_smi": smi, "tolerance": {
            n: {key: r[key] for key in ("excess", "fault_excess")} for n, r in records.items() if "excess" in r
        }, "library_none": {n: LIBRARY_NONE if n.startswith("fused_") else LIBRARY_NONE_GLA
                            for n, r in records.items()
                            if n.startswith(("fused_", "gla_")) and r.get("library_ms") is None},
        "gla_tensor_ops": gla_mma,
        "paged_tensor_ops": paged_mma,
        "paged_device_ms": {n: records[n]["device_ms"] for n in ("paged_flash_decode", "paged_chunk_prefill",
                                                                  "fused_sample")},
        "fused_sample_shapes": records["fused_sample"]["shapes"],
        "paged_flash_decode_serving_shape": {"ms": decode_serving["ms"], "device_ms": decode_serving["device_ms"],
                                             "plain_ms": decode_serving["plain_ms"],
                                             "bound_ms": decode_serving["bound"][0],
                                             "bound_by": decode_serving["bound"][1]},
        "flash": {"hgmma": hgmma, **{n: {key: records[n][key] for key in (
            "device_ms", "library_backend", "library_ms_default", "library_device_ms",
            "library_device_ms_default", "f32_route", "serving_prefill") if key in records[n]}
            for n in ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_fwd_d80",
                      "flash_attention_bwd_d80", "flash_attention_fwd_g6", "flash_attention_bwd_g6",
                      "flash_attention_fwd_g7")}},
        "zamba2_device_ms": {n: records[n]["device_ms"] for n in (
            "flash_attention_fwd_d80", "flash_attention_bwd_d80", "paged_flash_decode_d80",
            "paged_chunk_prefill_d80", "gla_fwd_mamba2", "gla_bwd_mamba2")},
        "mamba2_bound_own_operands_ms": {n: records[n]["bound_own_operands"][0]
                                         for n in ("gla_fwd_mamba2", "gla_bwd_mamba2")},
        "gla_fwd_mamba2_serving_chunk": {"ms": chunk["ms"], "device_ms": chunk["device_ms"],
                                         "bound_ms": chunk["bound"][0], "bound_by": chunk["bound"][1]},
        "gla_device_ms": {"gla_fwd": records["gla_fwd"]["device_ms"], "gla_bwd": records["gla_bwd"]["device_ms"],
                          "gla_fwd_serving_shape": gla_serving_shape["device_ms"]},
        "gla_fwd_serving_shape": {"ms": gla_serving_shape["ms"], "plain_ms": gla_serving_shape["plain_ms"],
                                  "bound_ms": gla_serving_shape["bound"][0],
                                  "bound_by": gla_serving_shape["bound"][1]},
        "rwkv6": {"serving": rwkv_serving, "training": rwkv_training},
        "zamba2": {"serving": zamba2_serving, "training": zamba2_training},
        "gemma2": {"training": gemma2_training},
        "dbrx": {"serving": dbrx_serving, "training": dbrx_training}, "arctic": {"serving": arctic_serving},
        "moe_device_ms": {n: records[n]["device_ms"] for n in (
            "flash_attention_fwd_g6", "flash_attention_bwd_g6", "flash_attention_fwd_g7", "paged_flash_decode_g6",
            "paged_flash_decode_g7", "paged_chunk_prefill_g6", "paged_chunk_prefill_g7", "fused_sample_v100352",
            "fused_sample_v32000")},
        "whisper": {"serving": whisper_serving, "training": whisper_training, "card_vs_cpu": whisper_agreement,
                    "device_ms": {n: records[n].get("device_ms") for n in records if "whisper" in n},
                    "f32_route": records["flash_attention_fwd_whisper_enc"]["f32_route"],
                    "library": {n: {key: records[n][key] for key in (
                        "library_backend", "library_ms_default", "library_device_ms", "library_device_ms_default")}
                        for n in records if n.startswith("flash_attention") and "whisper" in n}},
        "experiments": experiments, "fig1": fig1, "elastic": {"exact": elastic, "local_sgd": local_sgd},
        "sharded": sharded, "experts": experts,
        "remat": remat,
        "disagg": disagg,
        "dense_serving": dense, "resume": resume, "adaptive": adaptive, "phase_s": phase_s,
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
