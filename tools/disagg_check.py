"""chip_smoke.py's phases 28-29 alone: the disaggregated engine on the card.

    python3 tools/disagg_check.py              # both workers on cuda:0
    python3 tools/disagg_check.py --two-cards  # prefill on cuda:0, decode on cuda:1

Builds the kernels, serves phase 4's traffic (qwen2.5-3b full width) and
phase 15's (zamba2-2.7b full width) through the paged engine for the
reference greedy streams, median decode tick and TTFT, then runs
``chip_smoke.serve_disagg`` on the same weights and requests (its gates:
greedy streams equal, blocks bit-exact across the seam, launches as the
stats predict, no sanitizer error) and the smoke configs card against CPU.
With ``--two-cards`` the workers sit on two cards (the block moves by a
peer copy) and the launcher's ``--engine disagg`` serves phase 4's traffic
on the visible cards. Any failed check raises.
"""
import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _path in (ROOT, ROOT / "src", ROOT / "tools"):
    sys.path.insert(0, str(_path))


def reference(cfg, seed: int, warm_is_prefix: bool) -> dict:
    """Phase 4's (``seed`` 2, a whole prompt as the warm-up) or phase 15's
    (``seed`` 9, the prefix as the warm-up) traffic through the paged engine
    on cuda:0: the warm-up, the prompts, their greedy streams, the median
    decode tick and TTFT p50."""
    import torch

    from repro_torch.models import LanguageModel
    from repro_torch.serve import PagedContinuousBatchingEngine

    model = LanguageModel(cfg)
    params = model.init(seed=0, device="cuda")
    engine = PagedContinuousBatchingEngine(model, params, max_slots=8, page_size=16, cache_len=2048,
                                           prefill_chunks=(256,), seed=0)
    rng = torch.Generator().manual_seed(seed)
    prefix = torch.randint(0, cfg.vocab_size, (256,), generator=rng)

    def prompt():
        return torch.cat([prefix, torch.randint(0, cfg.vocab_size, (256,), generator=rng)]).numpy()

    warm = prefix.numpy() if warm_is_prefix else prompt()
    engine.submit(warm, max_new_tokens=4)
    engine.run()
    engine.reset_stats()
    prompts = [prompt() for _ in range(8)]
    ids = [engine.submit(p, max_new_tokens=32, temperature=0.0 if i % 2 == 0 else 0.8,
                         top_k=0 if i % 2 == 0 else 50) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    st = engine.stats
    tick = sorted(st["decode_tick_s"])[len(st["decode_tick_s"]) // 2] * 1e3
    ttft = sorted(engine.scheduler.requests[r].ttft_s for r in ids)[len(ids) // 2] * 1e3
    print(f"paged reference {cfg.name}: {st['decoded_tokens'] / wall:.1f} tok/s, tick {tick:.2f} ms, "
          f"ttft {ttft:.1f} ms, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    kept = {"warmup": warm, "prompts": prompts, "prefix": prefix, "greedy": [res[r] for r in ids[::2]],
            "tick_ms": tick, "ttft_ms": ttft}
    del engine, params, res
    gc.collect()
    torch.cuda.empty_cache()
    return kept


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda

    def fail(msg):
        raise RuntimeError(msg)

    cs.fail = fail
    two = "--two-cards" in sys.argv
    print(cs.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    _cuda.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pair = (torch.device("cuda", 0), torch.device("cuda", 1)) if two else None
    print(f"device count {torch.cuda.device_count()}, pair {pair}", flush=True)
    for cfg, seed, warm_is_prefix, label in ((get_config("qwen2.5-3b", "full"), 2, False, 28),
                                             (get_config("zamba2-2.7b", "full"), 9, True, 29)):
        t = time.perf_counter()
        kept = reference(cfg, seed, warm_is_prefix)
        fresh_rng = torch.Generator().manual_seed(label)
        fresh = [torch.cat([kept["prefix"], torch.randint(0, cfg.vocab_size, (256,), generator=fresh_rng)]).numpy()
                 for _ in range(8)]
        out = cs.serve_disagg(f"phase {label}", cfg, kept["warmup"], kept["prompts"], fresh, kept["greedy"],
                              kept["tick_ms"], kept["ttft_ms"], devices=pair)
        print(f"phase {label}: {time.perf_counter() - t:.1f} s; export ms {out['export_ms']}; import ms "
              f"{out['import_ms']}", flush=True)
    t = time.perf_counter()
    for arch, small in (("qwen2.5-3b", None), ("rwkv6-1.6b", None), ("zamba2-2.7b", cs.zamba2_smoke())):
        cs.disagg_small_input_agreement(arch, small)
    print(f"small inputs ok in {time.perf_counter() - t:.1f} s", flush=True)
    if two:
        from repro_torch.launch import serve as launcher

        t = time.perf_counter()
        res = launcher.main(["--engine", "disagg", "--variant", "full", "--slots", "8", "--requests", "8",
                             "--prompt-len", "512", "--shared-prefix", "256", "--new-tokens", "32",
                             "--cache-len", "2048", "--chunk", "256"])
        print(f"launcher --engine disagg on two cards: {len(res)} requests in {time.perf_counter() - t:.1f} s",
              flush=True)
    print("DISAGG ALONE OK")


if __name__ == "__main__":
    main()
