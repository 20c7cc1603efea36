"""Measurement scaffolding shared by the scripts that check and time the
port's kernels on a GPU (``chip_smoke.py``, ``tools/gla_bench.py``,
``tools/paged_bench.py``, ``tools/sample_bench.py``, ``tools/trace_check.py``):
the card's name and power limit, L2-cold event timing, device time from a
torch.profiler trace, the tensor-core instructions in a built library's
SASS, the attention forwards' tolerance, paged K/V pools, the sampler's rows
and the work they need, and the clock stamps of a measurement build.

torch and the port (``repro_torch``) are imported inside the functions, so
a script may first put the tree it measures on ``sys.path``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

L2_BYTES = 50 * 2**20
# Idle seconds on each side of a traced run, inside the profiler's window.
TRACE_PAD_S = 0.05
# Attention outputs are bf16: the kernel and the plain version each round an
# f32 result to bf16, so they may differ by one bf16 ulp, at most 2**-7 of
# the value; ATTN_ATOL covers values near 0.
ATTN_RTOL = 2.0**-7
ATTN_ATOL = 1e-4


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def copies_for(size: int) -> int:
    """Copies of inputs of ``size`` bytes that together exceed L2 twice over."""
    return max(2, -(-2 * L2_BYTES // size))


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


def device_trace(run, tmp_dir: Path, prepare=None, attempts: int = 3) -> dict:
    """``run()`` under torch.profiler, tracing the device only (kernels,
    copies, memsets): the run's wall ms, the device's busy ms (the union of
    its activity intervals) and idle share, the number of activities, and
    ``by_kernel``: name -> (ms, count), largest first. The trace passes
    through ``tmp_dir`` and is deleted.

    The profiler keeps only the device records inside its capture window,
    and a run of a few milliseconds traced without a margin loses some or
    all of them now and then, with no error (``tools/trace_check.py`` on an
    H100 at 700 W, torch 2.11: of 180 such traces 2 came back empty and 3
    short; with the padding, none of 180). So the window is padded with
    TRACE_PAD_S of idle time on each side, outside the wall time measured;
    and a trace that still holds no device record is taken again, at most
    ``attempts`` times in all, calling ``prepare()`` (if given) before each,
    as a run that consumes its inputs (an engine's queue) needs. After that
    it raises."""
    trace = _traced(run, tmp_dir, prepare, attempts)
    if trace is None:
        raise RuntimeError(f"the traced run recorded no device activity in {attempts} attempts")
    return trace


def _traced(run, tmp_dir: Path, prepare=None, attempts: int = 3):
    """:func:`device_trace`'s attempts; None when every trace came back empty."""
    for attempt in range(1, attempts + 1):
        if prepare is not None:
            prepare()
        trace = _trace_once(run, tmp_dir)
        if trace is not None:
            return trace
        print(f"cardbench: traced run {attempt} of {attempts} recorded no device activity", file=sys.stderr,
              flush=True)
    return None


def _trace_once(run, tmp_dir: Path, pad_s: float = TRACE_PAD_S):
    """One traced ``run()`` (:func:`device_trace`), ``pad_s`` of idle time
    on each side, or None when the trace holds no device record."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(pad_s)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    path = tmp_dir / "profile.tmp.json"  # too large to keep
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    device = [ev for ev in events if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        return None
    busy, end = 0.0, float("-inf")
    for s, e in sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in device):
        if e > end:
            busy += e - max(s, end)
            end = e
    by_kernel: dict = {}
    for ev in device:
        ms, n = by_kernel.get(ev["name"], (0.0, 0))
        by_kernel[ev["name"]] = (ms + ev["dur"] / 1e3, n + 1)
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
            "activities": len(device), "by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1][0]))}


#: the one entry of device_ms's kernel table when its times come from CUDA events
EVENTS_ONLY = "(CUDA events: the profiler recorded no device activity)"


def device_ms(fn, arg_sets, iters: int, tmp_dir: Path):
    """(device busy ms a call, {kernel: device ms a call}) of ``fn(*args)``:
    its kernels alone, without the host's gaps between calls, from one traced
    run of ``iters`` calls rotating over ``arg_sets``. When every traced run
    comes back empty (on one machine three traces of a few 5 µs launches in
    a row did), the time is CUDA events' over the same calls, host gaps
    included, under the single name :data:`EVENTS_ONLY`."""
    for args in arg_sets[:2]:
        fn(*args)

    def run():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    trace = _traced(run, tmp_dir)
    if trace is None:
        ms = timed(fn, arg_sets, iters)
        print(f"cardbench: {ms:.4f} ms a call from CUDA events instead", file=sys.stderr, flush=True)
        return ms, {EVENTS_ONLY: ms}
    return trace["busy_ms"] / iters, {name: ms / iters for name, (ms, _) in trace["by_kernel"].items()}


def excess(out, expect) -> float:
    """Largest |out - expect| in units of its allowance, ATTN_ATOL +
    ATTN_RTOL * |expect|: at most 1 passes."""
    err = (out.float() - expect.float()).abs()
    return (err / (ATTN_ATOL + ATTN_RTOL * expect.float().abs())).max().item()


def sass_counts(lib: str, name_of=lambda mangled: mangled) -> dict:
    """For each kernel of the built library ``lib`` (cuobjdump -sass):
    name -> (tensor-core instructions, HMMA for mma.sync and HGMMA for
    wgmma; all instructions). ``name_of(mangled name)`` names a kernel, or
    gives None to skip it."""
    from repro_torch.kernels import _cuda

    tool = Path(_cuda.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_cuda.library_path(lib))],
                          capture_output=True, text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = name_of(line.split("Function :")[1].strip())
            if current:
                counts[current] = [0, 0]
        elif current and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            counts[current][0] += bool(re.search(r"\bH(G)?MMA\b", line))
            counts[current][1] += 1
    return {name: tuple(c) for name, c in sorted(counts.items())}


def build_report(lib: str) -> dict:
    """Build ``lib``; print ptxas' registers and spills of each of its
    kernels and the tensor-core instructions in each kernel's SASS. Returns
    the SASS counts (:func:`sass_counts`)."""
    from repro_torch.kernels import _cuda

    _cuda.build([lib])
    for line in _cuda.BUILD_LOGS.get(lib, "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas[{lib}]: {line.strip()}")
    counts = sass_counts(lib)
    for name, (tensor_ops, size) in counts.items():
        print(f"sass[{lib}]: {tensor_ops:4d} HMMA/HGMMA of {size:6d} instructions  {name}")
    return counts


def paged_pool(gen, *, pages, ps, hkv, d, lengths, share_first_page=False, prefix_pages=0, width=2048):
    """bf16 K/V pools of ``pages`` pages with scratch page 0 poisoned (1e4),
    and tables ``width`` positions wide: slot b holds lengths[b] tokens in pages
    of its own, except that with ``share_first_page`` slot 1's first page is
    slot 0's (aliased copy-on-write), and every later slot's first
    ``prefix_pages`` pages are slot 0's (a shared prefix)."""
    import torch

    k = torch.randn((pages, ps, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((pages, ps, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    k[0] = 1e4
    v[0] = 1e4
    table = torch.zeros((len(lengths), width // ps), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(lengths):
        n_pages = -(-n // ps)
        table[b, :n_pages] = torch.arange(nxt, nxt + n_pages, dtype=torch.int32)
        nxt += n_pages
    if share_first_page:
        table[1, 0] = table[0, 0]
    table[1:, :prefix_pages] = table[0, :prefix_pages]
    return k, v, table.cuda()


def sampler_rows(gen, batch: int, vocab: int, top_k=None):
    """Sampler inputs on the card (logits, gumbel noise, temperature,
    top_k), chip_smoke.py phase 3's: 8 rows greedy (two), t = 0.8 with top_k
    0, 1, 50 (three, one of them with its 50th largest value five times) and
    V + 7; any other batch t = 0.8 and top_k 50. ``top_k`` replaces the 50s."""
    import torch

    k = 50 if top_k is None else top_k
    logits = torch.randn((batch, vocab), generator=gen, device="cuda") * 3
    if batch == 8:
        top = torch.randperm(vocab, generator=gen, device="cuda")[:60]
        logits[5, top[:49]] = 20 + torch.arange(49, device="cuda", dtype=torch.float32)
        logits[5, top[49:54]] = 19.5  # the 50th largest, five times
        temperature = torch.tensor([0, 0, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8], device="cuda")
        top_k = torch.tensor([0, k, 0, 1, k, k, 0, vocab + 7], dtype=torch.int32, device="cuda")
    else:
        temperature = torch.full((batch,), 0.8, device="cuda")
        top_k = torch.full((batch,), k, dtype=torch.int32, device="cuda")
    noise = -torch.log(-torch.log(torch.rand((batch, vocab), generator=gen, device="cuda").clamp_min(1e-38)))
    return logits, noise, temperature, top_k


def sampler_work(logits, temperature, top_k):
    """(bytes, operations) that sampling these rows needs at least: every
    logit read once (f32), temperature, top_k and the tokens; the noise of
    every logit of a row that keeps them all (t > 0, top_k <= 0 or >= V)
    and of the kept logits of a top-k row (those at or above its k-th
    largest); one compare a logit, and a division, an addition and a
    compare for each logit scored."""
    b, v = logits.shape
    keep_all = (temperature > 0) & ((top_k <= 0) | (top_k >= v))
    top_rows = (temperature > 0) & ~keep_all
    kth = logits.sort(dim=1, descending=True).values.gather(1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
    scored = v * int(keep_all.sum()) + int((logits >= kth).sum(dim=1)[top_rows].sum())
    return 4 * b * v + 4 * scored + nbytes(temperature, top_k) + 4 * b, b * v + 3 * scored


def read_stamps(lib: str, fn: str, count: int) -> list:
    """The ``count`` clock64 cycle counts that C function ``fn`` of a
    measurement build of ``lib`` copies out."""
    import ctypes

    from repro_torch.kernels import _cuda

    read = getattr(_cuda._lib(lib), fn)
    read.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    read.restype = ctypes.c_int
    raw = (ctypes.c_longlong * count)()
    if read(raw) != 0:
        raise RuntimeError(f"{fn}: could not read the clock stamps")
    return list(raw)
