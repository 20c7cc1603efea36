"""Fig. 3 reproduction (a CPU-scaled analog in the JAX package, run here on
the card): the paper's ResNet-20-style net with GroupNorm on synthetic
CIFAR-shaped data, comparing at the SAME computation complexity:

- classical stagewise SGD / mSGD / AdaGrad (LR ÷ ρ at stage boundaries),
- SEBS / mSEBS / AdaSEBS (batch × ρ, constant LR),
- DB-SGD (Yu & Jin 2019: ×1.02 per epoch),
- LARS large-batch-from-scratch (You et al. 2017).

Reports train loss and held-out accuracy against computation (samples) and
against parameter updates (the paper's left and right panels). The
settings, methods and records are those of the JAX package's
``benchmarks/fig3_stagewise.py``; pSGD (γ finite), momentum and AdaGrad-DA
update through the fused kernels (one launch over the model's leaves per
update on the card). The weights start from the JAX package's random
stream (``vision.init``), the batches are its batches.

    python -m repro_torch.experiments.fig3_stagewise [--device cpu] [--out DIR]
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core import DBSGD, EpochStagewise, StageController, WarmupConstant
from repro_torch.data import ImageClassDataset
from repro_torch.data.synthetic import key as prng_key
from repro_torch.data.synthetic import split, unstack
from repro_torch.experiments._records import Record, cli, print_csv, write_json
from repro_torch.models import vision
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_leaves

# budget: "epoch" = dataset size; boundaries at epochs 5, 8 of 10 (the
# paper's 80/120-of-160 pattern, scaled)
DATASET = ImageClassDataset(n=4_000, image_size=16, noise=1.2, seed=0)
EPOCHS = 10
BOUNDARIES = (5, 8)
B1 = 32
RHO = 4
CFG = vision.VisionConfig(width=8, blocks_per_stage=2, image_size=16)


def _loss_fn(params, batch):
    logits = vision.apply(params, batch["image"], CFG)
    return -torch.log_softmax(logits, dim=-1).gather(-1, batch["label"][:, None]).mean()


@torch.no_grad()
def _test_acc(params, batch) -> float:
    logits = vision.apply(params, batch["image"], CFG)
    return float((logits.argmax(-1) == batch["label"]).float().mean())


def _updates(schedule, optimizer_name: str, opt_kwargs: dict, seed: int = 0, device="cuda"):
    """One method's run, update by update: yields ``(plan, loss, params)``
    after each update (``loss`` that of the update's batch before it,
    ``params`` updated in place)."""
    opt = make_optimizer(optimizer_name, **opt_kwargs)
    params = vision.init(seed, CFG, device)
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    state = opt.init(params)
    key = prng_key(100 + seed)
    for plan in StageController(schedule, mode="reshape").plans():
        key, sub = unstack(split(key))
        batch = DATASET.train_batch(sub, plan.batch_size, device)
        loss = _loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        opt.update(list(grads), state, params, lr=plan.lr, stage=plan.stage)
        yield plan, loss.detach(), params


def _train(schedule, optimizer_name: str, opt_kwargs: dict, seed: int = 0, device="cuda"):
    """One method's run. Returns {"log": every 10th update's samples,
    update count, loss and batch; "updates"; "test_acc": over 4 test
    batches of 512}."""
    log = {"samples": [], "updates": [], "loss": [], "batch": []}
    updates = 0
    for plan, loss, params in _updates(schedule, optimizer_name, opt_kwargs, seed, device):
        updates += 1
        if updates % 10 == 0:
            log["samples"].append(plan.samples_after)
            log["updates"].append(updates)
            log["loss"].append(float(loss))
            log["batch"].append(plan.batch_size)
    accs = [_test_acc(params, DATASET.test_batch(prng_key(7 + i), 512, device)) for i in range(4)]
    return {"log": log, "updates": updates, "test_acc": float(np.mean(accs))}


def methods():
    n = DATASET.n
    common = dict(epoch_size=n, boundaries_epochs=BOUNDARIES, total_epochs=EPOCHS)
    eta_sgd, eta_m, eta_ada = 0.15, 0.05, 0.08
    return {
        "sgd_classical": (
            EpochStagewise(b1=B1, eta1=eta_sgd, rho=RHO, mode="classical", **common),
            "psgd", {"gamma": float("inf")},
        ),
        "sebs": (
            EpochStagewise(b1=B1, eta1=eta_sgd, rho=RHO, mode="sebs", **common),
            "psgd", {"gamma": 1e4},
        ),
        "msgd_classical": (
            EpochStagewise(b1=B1, eta1=eta_m, rho=RHO, mode="classical", **common),
            "momentum", {"beta": 0.9},
        ),
        "msebs": (
            EpochStagewise(b1=B1, eta1=eta_m, rho=RHO, mode="sebs", **common),
            "momentum", {"beta": 0.9, "reset_on_stage": True},
        ),
        "adagrad_classical": (
            EpochStagewise(b1=B1, eta1=eta_ada, rho=RHO, mode="classical", **common),
            "adagrad", {},
        ),
        "adasebs": (
            EpochStagewise(b1=B1, eta1=eta_ada, rho=RHO, mode="sebs", **common),
            "adagrad_da", {"delta": 1.0, "nu": 1.0},
        ),
        "dbsgd": (
            DBSGD(b1=B1, eta=eta_sgd, epoch_size=n, total_epochs=EPOCHS, scale=1.02),
            "psgd", {"gamma": float("inf")},
        ),
        "lars_large_batch": (
            WarmupConstant(b=B1 * 16, eta=2.0, warmup_samples=5 * n // 10, total=EPOCHS * n),
            "lars", {"scaling": 0.01, "weight_decay": 1e-4},
        ),
    }


def batch_path(schedule) -> List[int]:
    """The batch size of every update the schedule plans."""
    return [plan.batch_size for plan in StageController(schedule, mode="reshape").plans()]


def run(out_dir: str = "chiprun_out/experiments", device="cuda") -> List[Record]:
    results, records = {}, []
    for name, (schedule, opt_name, opt_kwargs) in methods().items():
        res = _train(schedule, opt_name, opt_kwargs, device=device)
        results[name] = res
        derived = (f"updates={res['updates']} test_acc={res['test_acc']:.4f} "
                   f"final_loss={res['log']['loss'][-1]:.4f}")
        ctx = {"optimizer": opt_name, "b1": B1, "rho": RHO, "epochs": EPOCHS}
        records.append(Record(f"fig3_{name}_updates", res["updates"], "count", direction="exact",
                              derived=derived, context=ctx))
        records.append(Record(f"fig3_{name}_test_acc", res["test_acc"], "ratio", direction="higher",
                              derived=derived, context=ctx))
        records.append(Record(f"fig3_{name}_final_loss", res["log"]["loss"][-1], "nats", direction="lower",
                              derived=derived, context=ctx))
    write_json(out_dir, "fig3_stagewise.json", results)
    return records


if __name__ == "__main__":
    args = cli(__doc__.splitlines()[0])
    print_csv(run(args.out, args.device))
