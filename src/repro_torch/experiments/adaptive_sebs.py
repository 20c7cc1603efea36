"""Beyond-paper experiment: loss-keyed AdaptiveSEBS against fixed-ρ SEBS
and classical stagewise, on the paper's quadratic (Eq. 11), with the
settings and records of the JAX package's ``benchmarks/adaptive_sebs.py``.

AdaptiveSEBS operationalizes Eq. 8 (bₛ ∝ 1/εₛ) with the MEASURED loss: it
needs no a-priori ρ or stage budgets, yet should land in the same
(final-error, update-count) regime as hand-tuned SEBS. pSGD updates through
the fused kernel; the batches' rows are the JAX package's.

    python -m repro_torch.experiments.adaptive_sebs [--device cpu] [--out DIR]
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core import SEBS, AdaptiveSEBS, ClassicalStagewise, StageController
from repro_torch.data import QuadraticProblem
from repro_torch.data.synthetic import key as prng_key
from repro_torch.data.synthetic import split, unstack
from repro_torch.experiments._records import Record, cli, print_csv, write_json
from repro_torch.optim import make_optimizer


def _run(schedule, qp, w0, seed=0, device="cuda"):
    """(final w, updates, controller) of one pSGD run under ``schedule``."""
    opt = make_optimizer("psgd", gamma=1e4)
    ctl = StageController(schedule, mode="reshape")
    w = {"w": torch.tensor(np.asarray(w0, np.float32), device=device)}  # a copy: updated in place
    state = opt.init(w)
    key = prng_key(seed)
    data = torch.from_numpy(qp.data).to(device)
    f_star = float(qp.full_loss(torch.from_numpy(qp.w_star).to(device)))
    updates = 0
    for plan in ctl.plans():
        key, sub = unstack(split(key))
        xi = data[torch.from_numpy(qp.sample_indices(sub, plan.batch_size).astype(np.int64)).to(device)]
        g = {"w": qp.grad(w["w"], xi)}
        w, state = opt.update(g, state, w, lr=plan.lr, stage=plan.stage)
        updates += 1
        if hasattr(schedule, "observe"):
            schedule.observe(plan.samples_after, float(qp.full_loss(w["w"])) - f_star)
    return w["w"], updates, ctl


def problem():
    """The problem and start of the JAX file: n 5,000, d 50, ‖w₀ − w*‖ ≈ 4."""
    qp = QuadraticProblem(n=5000, d=50, seed=0)
    rng = np.random.default_rng(1)
    w0 = qp.w_star + 4.0 * rng.standard_normal(qp.d).astype(np.float32) / np.sqrt(qp.d)
    return qp, w0


def schedules(qp):
    eta = 1.0 / (2 * qp.L)
    total = 28_000
    return {
        "classical": ClassicalStagewise(b=8, C1=4000, rho=4.0, num_stages=3, eta1=eta),
        "sebs_rho4": SEBS(b1=8, C1=4000, rho=4.0, num_stages=3, eta=eta),
        "adaptive_sebs": AdaptiveSEBS(b1=8, eta=eta, total=total, rho_max=8.0,
                                      min_stage_samples=1500, smooth=0.7),
    }


def run(out_dir: str = "chiprun_out/experiments", device="cuda") -> List[Record]:
    qp, w0 = problem()
    f_star = float(qp.full_loss(torch.from_numpy(qp.w_star)))
    records: List[Record] = []
    results = {}
    for name, sched in schedules(qp).items():
        w, updates, _ = _run(sched, qp, w0, device=device)
        err = float(qp.full_loss(w.cpu())) - f_star
        growth = getattr(sched, "history", None)
        results[name] = {"updates": updates, "final_err": err,
                         "stages": [h for h in growth] if growth else None}
        derived = (f"updates={updates} final_err={err:.4f}"
                   + (f" batch_path={[h['batch'] for h in growth]}" if growth else ""))
        ctx = {"batch_path": [h["batch"] for h in growth]} if growth else {}
        records.append(Record(f"adaptive_{name}_updates", updates, "count", direction="exact",
                              derived=derived, context=ctx))
        records.append(Record(f"adaptive_{name}_final_err", err, "loss_gap", direction="lower",
                              derived=derived, context=ctx))
    write_json(out_dir, "adaptive_sebs.json", results)
    return records


if __name__ == "__main__":
    args = cli(__doc__.splitlines()[0])
    print_csv(run(args.out, args.device))
