"""Fig. 2 reproduction: the optimal batch size against the initialization
gap, with the settings and records of the JAX package's
``benchmarks/fig2_optimal_batch.py``.

Vanilla SGD (paper Eq. 3) on the synthetic quadratic (Eq. 11) with FIXED
computation complexity C = n = 10⁴. For each initialization distance
x = ‖w₁ − w*‖ and each batch size b, run M = C/b steps and score
E‖ŵ − w*‖ with ŵ uniform over the iterates {w₂..w_{M+1}} (the mean over
iterates). The paper's Eq. 5 predicts b* ∝ 1/x and that a larger LR
supports a larger b*.

The random stream is the JAX package's: for each (x, b) the key
``fold_in(key(0), hash((x, b)) % 2**31)``, split into the repeats, each
split into a direction (a normal) and one key a step, whose
``randint(key, (b,), 0, n)`` picks the step's rows. Plain tensor
arithmetic, as the JAX package's ``scan``/``vmap`` (no kernel): the steps
of one batch size run as one loop over every (rate, gap, repeat) row at
once.

    python -m repro_torch.experiments.fig2_optimal_batch [--device cpu] [--out DIR]
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.data import QuadraticProblem
from repro_torch.data.synthetic import fold_in, key, normal, randint, split
from repro_torch.experiments._records import Record, cli, print_csv, write_json

BATCHES = [1, 2, 4, 8, 16, 32, 64, 128, 256]
XS = [10, 20, 30, 40, 50, 60, 70, 80, 100]
LRS = (0.005, 0.01)
REPEATS = 20


def streams(xs: Sequence[int], b: int, steps: int, d: int, n: int, repeats: int = REPEATS):
    """The JAX package's draws for batch size ``b``: unit directions (X, R,
    d) f32 and every step's rows (steps, X, R, b) int64."""
    root = key(0)
    k = fold_in(root, np.asarray([hash((x, b)) % 2**31 for x in xs], dtype=np.uint32))
    reps = split(k, repeats)                     # (X, R)
    kdir, kbatch = (tuple(w[..., i] for w in split(reps, 2)) for i in (0, 1))
    direction = normal(kdir, (d,))               # (X, R, d)
    direction = direction / np.linalg.norm(direction, axis=-1, keepdims=True).astype(np.float32)
    idx = randint(split(kbatch, steps), (b,), 0, n)  # (X, R, M, b)
    return direction, np.ascontiguousarray(np.moveaxis(idx, 2, 0)).astype(np.int64)


def scores(qp: QuadraticProblem, xs: Sequence[int], lrs: Sequence[float], b: int, steps: int,
           device="cuda", repeats: int = REPEATS) -> torch.Tensor:
    """(L, X) mean over repeats of the mean over iterates of ‖w_m − w*‖."""
    direction, idx = streams(xs, b, steps, qp.d, qp.n, repeats)
    data = torch.from_numpy(qp.data).to(device)
    diag = torch.from_numpy(qp.diag).to(device)
    w_star = torch.from_numpy(qp.w_star).to(device)
    gap = torch.tensor(xs, dtype=torch.float32, device=device)[:, None, None]
    w0 = w_star + gap * torch.from_numpy(direction).to(device)        # (X, R, d)
    lr = torch.tensor(lrs, dtype=torch.float32, device=device)[:, None, None, None]
    w = w0[None].repeat(len(lrs), 1, 1, 1)                            # (L, X, R, d)
    acc = torch.zeros(w.shape[:-1], dtype=torch.float32, device=device)
    rows = torch.from_numpy(idx).to(device)                           # (M, X, R, b)
    for m in range(steps):
        xi = data[rows[m]]                                            # (X, R, b, d)
        g = torch.mean((w[:, :, :, None, :] - xi[None]) * diag, dim=3)
        w = w - lr * g
        acc = acc + torch.linalg.vector_norm(w - w_star, dim=-1)
    return (acc / steps).mean(dim=-1)


def optimal_batches(qp: QuadraticProblem, xs=XS, batches=BATCHES, lrs=LRS, device="cuda",
                    repeats: int = REPEATS):
    """({lr: {x: b*}}, {lr: {x: {b: score}}}) at computation C = n."""
    table = {lr: {x: {} for x in xs} for lr in lrs}
    for b in batches:
        s = scores(qp, xs, lrs, b, qp.n // b, device, repeats).cpu().numpy()
        for i, lr in enumerate(lrs):
            for j, x in enumerate(xs):
                table[lr][x][b] = float(s[i, j])
    best = {lr: {x: min(row, key=row.get) for x, row in per_x.items()} for lr, per_x in table.items()}
    return best, table


def correlation(optimal: Dict[int, int]) -> float:
    """corr(log x, log b*) (Eq. 5 predicts near -1; NaN for a constant b*)."""
    xs = np.array(sorted(optimal))
    bs = np.array([optimal[x] for x in xs], float)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.corrcoef(np.log(xs), np.log(bs))[0, 1])


def run(out_dir: str = "chiprun_out/experiments", device="cuda", xs=XS, batches=BATCHES) -> List[Record]:
    qp = QuadraticProblem(n=10_000, d=100)
    best, _ = optimal_batches(qp, xs, batches, LRS, device)
    records: List[Record] = []
    for lr, optimal in best.items():
        corr = correlation(optimal)
        degenerate = not np.isfinite(corr)
        records.append(Record(
            f"fig2_optimal_batch_lr{lr}_corr", 0.0 if degenerate else corr, "corr",
            direction="info" if degenerate else "lower",
            derived=(f"b*(x)={optimal}; corr(log b*, log x)="
                     + ("undefined (constant b*)" if degenerate else f"{corr:.3f}")),
            context={"optimal_batch": {str(k): v for k, v in optimal.items()}, "lr": lr,
                     "degenerate": degenerate},
        ))
    write_json(out_dir, "fig2_optimal_batch.json", {str(k): v for k, v in best.items()})
    return records


if __name__ == "__main__":
    args = cli(__doc__.splitlines()[0])
    print_csv(run(args.out, args.device))
