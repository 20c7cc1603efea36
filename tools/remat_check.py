"""chip_smoke.py's phase 32 alone: the dry run and the remat policies.

    python3 tools/remat_check.py

Builds the kernels and runs ``chip_smoke.remat_start`` and ``remat_finish``: (a) qwen2.5-3b
train_4k counted on meta tensors on the (16, 16) mesh (per-rank bytes,
FLOPs, collective bytes and the roofline's three terms, timed on the host)
and (b) one update of phase 7's stage 2 (qwen2.5-3b
at full width, 4 microbatches of 4 x 513 tokens, pSGD, under each remat
policy from the same seed-0 params: losses and params bit-identical, the
flash launches, each peak against the dry run's for the same step on the
(1, 1) mesh, each update's ms beside the roofline's terms). The state is
seed 0's, not phase 7's trained one; the step and its shapes are phase 7's.
Every number printed carries the card's name and power limit. Any failed
check raises.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _path in (ROOT, ROOT / "src", ROOT / "tools"):
    sys.path.insert(0, str(_path))


class _Pipeline:
    """What ``remat_update`` reads of a trainer: its data pipeline."""

    def __init__(self, pipeline):
        self.pipeline = pipeline


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline, TokenDataset
    from repro_torch.kernels import _cuda
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.train import build_train_step, init_train_state

    def fail(msg):
        raise RuntimeError(msg)

    cs.fail = fail
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _cuda.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = get_config("qwen2.5-3b", "full")
    psgd = make_optimizer("psgd", gamma=1e4)
    t0 = time.perf_counter()
    state = init_train_state(LanguageModel(cfg), psgd, seed=0, device="cuda")
    trainer = _Pipeline(DataPipeline(TokenDataset(cfg.vocab_size, 512, seed=0), device="cuda"))
    # one untimed update warms the step, as phase 9 does in chip_smoke.py
    warm = {k: v.reshape((4, 4) + tuple(v.shape[1:])) for k, v in trainer.pipeline.next_batch(16).items()}
    build_train_step(LanguageModel(cfg), psgd, accum_steps=4)(state, warm, cs.ETAS["psgd"], 2)
    cs.remat_finish(cs.remat_start(cfg, trainer, state, psgd, cs.ETAS["psgd"]), smi)
    print(f"phase 32: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
