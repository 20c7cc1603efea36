"""chip_smoke.py's phases 30-31, 34-36, 37, 38 and 39 alone, and the sharded mesh across cards.

    python3 tools/mesh_check.py               # phases 30-31 on one card
    python3 tools/mesh_check.py --experts     # phases 34-36 on one card
    python3 tools/mesh_check.py --tensor-parallel  # phases 36-37 and the G 8 kernel shape on one card
    python3 tools/mesh_check.py --tensor-parallel --arch dbrx-132b  # phase 38 (the MoE family) on one card
    python3 tools/mesh_check.py --tensor-parallel --arch rwkv6-1.6b  # phase 39 (rwkv6, zamba2) on one card
    python3 tools/mesh_check.py --four-cards  # a machine with four cards
    python3 tools/mesh_check.py --four-cards --arch arctic-480b --layers 1

``--experts``: builds the kernels, then ``chip_smoke.expert_parallel_smoke``
(dbrx and arctic smoke on a (2, 2) mesh of four workers on cuda:0, the
experts over the model groups, held to the one-process run),
``chip_smoke.dbrx_expert_parallel`` (dbrx-132b full width at 1 layer on
(1, 2), each worker's peak against the dry run's count) and
``chip_smoke.sharded_serving`` (the sharded prefill and decode against the
single-process engine).

``--tensor-parallel``: builds the kernels, holds the flash kernels at a
tensor-parallel rank's shape (G 8: B 4, S 513, 8/1 heads) to their plain
versions (``chip_smoke.tp_kernel_checks``), then phase 37: qwen smoke on
(1, 2) with ``tp_reduce_scatter`` held to the one-process run, qwen2.5-3b
at full width on (1, 2) (two updates here, one in chip_smoke; each
worker's peak against the dry run's count), and ``chip_smoke.sharded_serving``
(phases 36 and 37(c): ``serve_on_mesh`` without and with
``tensor_parallel``, the ``tp_reduce_scatter`` twin bit-equal). With an
MoE ``--arch`` (dbrx-132b or arctic-480b) it runs phase 38 instead, after
the same kernel checks (G 6 at a rank's 24/4 heads too):
``chip_smoke.moe_tensor_parallel`` (dbrx and arctic smoke on (2, 2) with
tensor parallelism held to the one-process run, each ``tp_reduce_scatter``
twin bit-equal; dbrx-132b at 1 full-width layer on (1, 2), two updates,
each worker's peak against the dry run's count) and
``chip_smoke.sharded_serving`` (38(c) among its runs). With a recurrent
``--arch`` (rwkv6-1.6b or zamba2-2.7b: both run either way) it runs phase
39: the GLA kernels at a rank's 16 of rwkv6's 32 heads and 40 of Mamba2's
80, the flash kernels at zamba2's shared block's 16/16 heads of 80
(``chip_smoke.recurrent_tp_kernel_checks``), then
``chip_smoke.recurrent_tensor_parallel`` (rwkv6 and zamba2 smoke on (2, 2)
held to their one-process runs, each ``tp_reduce_scatter`` twin
bit-equal; rwkv6-1.6b at 2 full-width layers and zamba2-2.7b at 1 of 9
repeats on (1, 2), two updates each, each worker's peak against the dry
run's count) and ``chip_smoke.sharded_serving`` (39(c) among its runs).

``--four-cards --arch A`` with an MoE arch: a (1, 4) mesh over the four
cards, each holding E/4 experts whole (no gather of them), A at full width
cut to ``--layers`` layers, one update of 4 rows of 513 tokens (one a
card), pSGD. The dry run counts each card's peak first; the run happens
only where every count is under 80 GB, and each card's peak is then held
to its count (10%), with the update's ms and the experts' all-to-all ms.
The state is built from a seed on rank 0's card and stays on the cards
(``run_on_mesh(..., init_seed=0)``).

One card: builds the kernels, runs phase 26's reference (ElasticTrainer at
budget 1, qwen2.5-3b full width cut to 1 layer (``ELASTIC_LAYERS``), pSGD on phase 7's
schedule: SEBS b1 4, C1 16, rho 2, 3 stages, 513-token rows, microbatch
4), then ``chip_smoke.mesh_sharded`` (SEBSTrainer on a (2, 2) mesh of four
workers sharing cuda:0, host slots) and ``chip_smoke.elastic_sharded``
(ElasticTrainer with param_axes at budget 4), each held to the reference
bit for bit, with the launch, storage and peak gates of phases 30-31.

Four cards (one worker a card, so the layer gathers and the gradient's
slices go through NCCL, the slices as one ``all_to_all_single`` a leaf):
the (2, 2) production mesh (what the launcher's ``--mesh single`` builds)
over the four cards at all 36 of qwen2.5-3b's layers, against a one-card
ElasticTrainer at budget 1 on cuda:0 in the same call (losses and params
bit-identical; each card's storage between updates as the specs count it,
its stage-2 peak as the dry run counts it); then at 2 layers the (2, 2)
mesh on cuda:0 x 4 (host slots) and over the four cards (NCCL), both held
to a 2-layer budget-1 run, with the exchange's ms of each side by side;
and the launcher's ``--mesh single`` at smoke size on the four cards.
Every number printed carries the card's name and power limit. Any failed
check raises.
"""
import argparse
import gc
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _path in (ROOT, ROOT / "src", ROOT / "tools"):
    sys.path.insert(0, str(_path))


def reference(cs, cfg, device="cuda:0"):
    """ElasticTrainer at budget 1 on cuda:0: (its log, a host copy of its
    params). The caller's state lies on ``device``: at 36 layers on another
    card, since the worker's copy of the 24.7 GB state and its three
    gradient-sized tree terms leave no room on cuda:0 for a second state."""
    import torch

    from repro_torch.models import LanguageModel
    from repro_torch.utils.tree import tree_leaves

    params = LanguageModel(cfg).init(0, device=device)
    log, wall, _, state = cs.elastic_run(cfg, params, 1, copy_params=False)
    kept = (log, [t.detach().cpu() for t in tree_leaves(state.params)])
    print(f"reference budget 1 at {cfg.num_layers} layers: {len(log.steps)} updates in {wall:.1f} s, losses "
          + " ".join(f"{x:.4f}" for x in log.losses), flush=True)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return kept


# seconds the four-card MoE run may take (a first run that passed arctic's 55 GB state through the host did
# not end within 600 s; the state is now built on rank 0's card)
FOUR_CARD_EXPERTS_DEADLINE = 1800.0


def four_card_experts(cs, arch: str, layers: int, smi: str) -> None:
    """``arch`` at full width cut to ``layers`` on a (1, 4) mesh over the four
    cards (NCCL), counted first; see the module's docstring."""
    import numpy as np
    import torch

    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import SEBS, SEBSTrainer
    from repro_torch.data import DataPipeline, TokenDataset
    from repro_torch.distributed import run_on_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.models import LanguageModel
    from repro_torch.obs import Tracer
    from repro_torch.optim import make_optimizer

    if torch.cuda.device_count() < 4:
        cs.fail(f"--four-cards needs four cards, {torch.cuda.device_count()} visible")
    cfg = cs.moe_cut(arch, layers)
    shape = InputShape("update", 513, 4, "train")
    meta_mesh = make_host_mesh(1, 4, devices=["meta"] * 4)
    t = time.perf_counter()
    counts = [dryrun.count_train(cfg, shape, meta_mesh, optimizer_name="psgd", rank=r)["memory"]
              ["peak_bytes_per_device"] for r in range(4)]
    print(f"{arch} at {layers} layer(s) on (1, 4): the dry run counts each card's peak "
          + ", ".join(f"{c / 1e9:.2f}" for c in counts) + f" GB ({time.perf_counter() - t:.1f} s on the host)",
          flush=True)
    if max(counts) >= 80e9:
        print(f"not run: a card's count is {max(counts) / 1e9:.2f} GB, over 80 GB", flush=True)
        return
    grid = np.empty((4,), object)
    grid[:] = [torch.device("cuda", i) for i in range(4)]
    mesh = Mesh(grid.reshape(1, 4), ("data", "model"))
    model = LanguageModel(cfg)
    opt = make_optimizer("psgd", gamma=1e4)
    trainer = SEBSTrainer(model, opt, SEBS(b1=4, C1=4, rho=2.0, num_stages=1, eta=0.7),
                          DataPipeline(TokenDataset(cfg.vocab_size, 512, seed=0), mesh), mesh=mesh,
                          param_axes=model.param_axes(), microbatch=1, tracer=Tracer(),
                          deadline=FOUR_CARD_EXPERTS_DEADLINE)
    t = time.perf_counter()
    # the state built from a seed on rank 0's card and kept on the workers: nothing crosses the host
    _, log = run_on_mesh(trainer, None, init_seed=0, log_every=1)
    wall = time.perf_counter() - t
    cs.shard_peak_check(f"{arch} (1, 4) over 4 cards", cfg, trainer, meta_mesh, smi, stage=0, shape=shape)
    span = [ev["dur"] * 1e3 for ev in trainer.tracer.events if ev.get("name") == "train.update"]
    rows = trainer.worker_stats[0]["sharded"][0]
    print(f"{arch} {layers} layer(s) on (1, 4) over 4 cards (NCCL): loss {log.losses[0]:.4f}, update {span[0]:.1f} "
          f"ms, experts' all-to-alls {rows['experts_s'] * 1e3:.1f} ms and gathers {rows['gather_s'] * 1e3:.1f} ms "
          f"of host time on rank 0 (enqueue times: NCCL runs on its own stream), {wall:.1f} s in all | {smi}",
          flush=True)


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    def fail(msg):
        raise RuntimeError(msg)

    cs.fail = fail
    ap = argparse.ArgumentParser()
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--experts", action="store_true")
    ap.add_argument("--tensor-parallel", action="store_true")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--layers", type=int, default=1)
    args = ap.parse_args()
    four = args.four_cards
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    t0 = time.perf_counter()
    _cuda.build()
    print(f"build {time.perf_counter() - t0:.1f} s; {torch.cuda.device_count()} cards", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tensor_parallel:
        records: dict = {}
        recurrent = get_config(args.arch, "full").family in ("ssm", "hybrid")
        if recurrent:
            cs.recurrent_tp_kernel_checks(records)
            for name in ("gla_fwd_tp", "gla_bwd_tp", "gla_fwd_mamba2tp", "gla_bwd_mamba2tp"):
                r = records[name]
                print(f"{name}: {r['ms']:.4f} ms (device {r['device_ms']:.4f}; bound {r['bound'][0]:.5f} by "
                      f"{r['bound'][1]}; plain {r['plain_ms']:.3f}); max abs err {r['max_abs_err']:.3g}, "
                      f"excess {r['excess']:.3g}, planted fault {r['fault_excess']:.3g} | {smi}", flush=True)
        else:
            cs.tp_kernel_checks(records)
        for name in (("flash_attention_fwd_d80tp", "flash_attention_bwd_d80tp") if recurrent else
                     ("flash_attention_fwd_g8", "flash_attention_bwd_g8", "flash_attention_fwd_g6tp",
                      "flash_attention_bwd_g6tp")):
            r = records[name]
            print(f"{name}: {r['ms']:.4f} ms (device {r['device_ms']:.4f}; bound {r['bound'][0]:.5f}; plain "
                  f"{r['plain_ms']:.3f}; SDPA {r['library_ms']:.4f} (device {r['library_device_ms']:.4f}), "
                  f"default dispatch {r['library_ms_default']:.4f} (device {r['library_device_ms_default']:.4f})); "
                  f"max abs err {r['max_abs_err']:.3g} | {smi}", flush=True)
        t1 = time.perf_counter()
        if recurrent:
            cs.recurrent_tensor_parallel(smi, updates=2)
            print(f"phase 39(a, b): {time.perf_counter() - t1:.1f} s", flush=True)
        elif get_config(args.arch, "full").num_experts:
            cs.moe_tensor_parallel(smi, updates=2)
            print(f"phase 38(a, b): {time.perf_counter() - t1:.1f} s", flush=True)
        else:
            cs._tp_smoke_run(smi)
            cs._tp_full_width_update(smi, updates=2)
            print(f"phase 37(a, b): {time.perf_counter() - t1:.1f} s", flush=True)
        cs.sharded_serving(smi)
        return
    if args.experts:
        cs.expert_parallel_smoke(smi)
        cs.dbrx_expert_parallel(smi)
        cs.sharded_serving(smi)
        return
    if four and get_config(args.arch, "full").num_experts:
        four_card_experts(cs, args.arch, args.layers, smi)
        return
    cut = cs.elastic_cut(get_config("qwen2.5-3b", "full"))
    if not four:
        ref = reference(cs, cut)
        cs.mesh_sharded(cut, smi, ref)
        cs.elastic_sharded(cut, smi, ref)
        return
    if torch.cuda.device_count() < 4:
        fail(f"--four-cards needs four cards, {torch.cuda.device_count()} visible")
    full = get_config("qwen2.5-3b", "full")
    mesh = make_production_mesh()
    if tuple(mesh.shape.values()) != (2, 2):
        fail(f"the production mesh of four cards is {mesh.shape}, not (2, 2)")
    t = time.perf_counter()
    ref = reference(cs, full, device="cuda:1")
    nccl = cs.mesh_sharded(full, smi, ref, mesh, label="mesh (2, 2) over 4 cards, 36 layers")
    print(f"36 layers: {time.perf_counter() - t:.1f} s; exchange {nccl['exchange']}", flush=True)
    del ref
    t = time.perf_counter()
    ref = reference(cs, cut)
    host = cs.mesh_sharded(cut, smi, ref, make_host_mesh(2, 2, devices=[torch.device("cuda", 0)] * 4),
                           label=f"mesh (2, 2) on cuda:0 x 4, {cut.num_layers} layers")
    cards = cs.mesh_sharded(cut, smi, ref, mesh, label=f"mesh (2, 2) over 4 cards, {cut.num_layers} layers")
    print(f"{cut.num_layers} layers: {time.perf_counter() - t:.1f} s", flush=True)
    for st in sorted(host["by_stage"]):
        h, c = host["by_stage"][st], cards["by_stage"][st]
        print(f"exchange at {cut.num_layers} layers, stage {st}: host slots ({host['exchange']}) "
              f"{sum(h['exchange_ms'].values()):.1f} ms (copy out / barriers / copy back "
              f"{h['exchange_ms']['copy_out']:.1f} / {h['exchange_ms']['collective']:.1f} / "
              f"{h['exchange_ms']['copy_back']:.1f}), NCCL ({cards['exchange']}) "
              f"{sum(c['exchange_ms'].values()):.1f} ms; gather {h['gather_ms']:.1f} vs {c['gather_ms']:.1f} ms; "
              f"update {h['update_ms']:.1f} vs {c['update_ms']:.1f} ms | {smi}", flush=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--mesh", "single", "--variant", "smoke",
                           "--b1", "4", "--c1", "16", "--rho", "2", "--seq", "64", "--steps-log", "100"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stderr.splitlines() if "mesh" in ln or "update" in ln]
    if proc.returncode != 0 or not lines:
        fail(f"launcher --mesh single exited {proc.returncode}: {proc.stderr[-2000:]}")
    print(f"launcher --mesh single (smoke) exit 0 in {time.perf_counter() - t:.1f} s | "
          + " | ".join(ln.strip() for ln in lines[:2]) + f" | {smi}", flush=True)


if __name__ == "__main__":
    main()
