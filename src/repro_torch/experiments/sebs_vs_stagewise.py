"""SEBS against classical stagewise SGD, head to head (paper Fig. 3, Eq.
11), as the JAX package's ``examples/sebs_vs_stagewise.py``: both schedules
on the paper's synthetic quadratic at the SAME computation complexity,
printing loss against compute and against updates, the two panels of the
paper's figure, as a table; the traces go to ``--out``.

    python -m repro_torch.experiments.sebs_vs_stagewise [--device cpu] [--out DIR]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import SEBS, ClassicalStagewise, StageController
from repro_torch.data.synthetic import key as prng_key
from repro_torch.data.synthetic import split, unstack
from repro_torch.experiments._records import cli, write_json
from repro_torch.experiments.adaptive_sebs import problem
from repro_torch.optim import make_optimizer


def run_schedule(schedule, qp, w0, gamma=1e4, seed=0, device="cuda"):
    """[(samples, updates, F(w))] after every update of a pSGD run."""
    opt = make_optimizer("psgd", gamma=gamma)
    ctl = StageController(schedule, mode="reshape")
    w = {"w": torch.tensor(np.asarray(w0, np.float32), device=device)}  # a copy: updated in place
    state = opt.init(w)
    key = prng_key(seed)
    data = torch.from_numpy(qp.data).to(device)
    trace, updates = [], 0
    for plan in ctl.plans():
        key, sub = unstack(split(key))
        xi = data[torch.from_numpy(qp.sample_indices(sub, plan.batch_size).astype(np.int64)).to(device)]
        w, state = opt.update({"w": qp.grad(w["w"], xi)}, state, w, lr=plan.lr, stage=plan.stage)
        updates += 1
        trace.append((plan.samples_after, updates, float(qp.full_loss(w["w"]))))
    return trace


def main(out_dir: str = "chiprun_out/experiments", device="cuda"):
    qp, w0 = problem()
    eta = 1.0 / (2 * qp.L)
    c1, rho, stages = 4000, 4.0, 3
    sebs = run_schedule(SEBS(b1=8, C1=c1, rho=rho, num_stages=stages, eta=eta), qp, w0, device=device)
    classical = run_schedule(ClassicalStagewise(b=8, C1=c1, rho=rho, num_stages=stages, eta1=eta), qp, w0,
                             device=device)
    f_star = float(qp.full_loss(torch.from_numpy(qp.w_star)))
    print(f"{'':14}{'samples':>10} {'updates':>8} {'F(w)-F*':>12}")
    for name, trace in [("SEBS", sebs), ("classical", classical)]:
        s, u, loss = trace[-1]
        print(f"{name:14}{s:>10} {u:>8} {loss - f_star:>12.5f}")
    print(f"\nSame compute ({sebs[-1][0]} samples each); SEBS used "
          f"{sebs[-1][1]} updates vs classical {classical[-1][1]} "
          f"({100 * (1 - sebs[-1][1] / classical[-1][1]):.0f}% fewer parameter "
          f"updates = fewer gradient all-reduces in data-parallel training).")
    write_json(out_dir, "sebs_vs_stagewise.json", {"sebs": sebs, "classical": classical, "f_star": f_star})
    return sebs, classical


if __name__ == "__main__":
    args = cli(__doc__.splitlines()[0])
    main(args.out, args.device)
