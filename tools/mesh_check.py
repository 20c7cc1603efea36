"""chip_smoke.py's phases 30-31 alone, and the sharded mesh across cards.

    python3 tools/mesh_check.py               # phases 30-31 on one card
    python3 tools/mesh_check.py --four-cards  # a machine with four cards

One card: builds the kernels, runs phase 26's reference (ElasticTrainer at
budget 1, qwen2.5-3b full width cut to 2 layers, pSGD on phase 7's
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


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    def fail(msg):
        raise RuntimeError(msg)

    cs.fail = fail
    four = "--four-cards" in sys.argv
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    t0 = time.perf_counter()
    _cuda.build()
    print(f"build {time.perf_counter() - t0:.1f} s; {torch.cuda.device_count()} cards", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
