"""The worker processes' harness, shared by the mesh trainer
(``trainer.py``) and the sharded serving forward (``mesh_serve.py``): the
numerics settings a worker takes from its caller, the host slots' size,
and a spawned set of workers' end (a failing worker's traceback into the
run's directory; the wait that stops the rest and raises with it)."""
from __future__ import annotations

import os
import time
import traceback
from multiprocessing import connection
from typing import Optional

import torch

from repro_torch.train.state import TrainState
from repro_torch.utils.tree import tree_leaves


def caller_settings() -> dict:
    """The numerics settings a worker must share with its caller."""
    return {"num_threads": torch.get_num_threads(), "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_precision": torch.get_float32_matmul_precision(),
            "deterministic": torch.are_deterministic_algorithms_enabled()}


def apply_settings(s: dict) -> None:
    torch.set_num_threads(s["num_threads"])
    torch.backends.cuda.matmul.allow_tf32 = s["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = s["cudnn_tf32"]
    torch.set_float32_matmul_precision(s["matmul_precision"])
    torch.use_deterministic_algorithms(s["deterministic"])


def slot_bytes(state: TrainState) -> int:
    """Bytes of a host slot: the largest tensor of the state, or of its f32
    gradient."""
    return max(64, *(t.numel() * max(t.element_size(), 4)
                     for t in tree_leaves([state.params, state.opt_state]) if isinstance(t, torch.Tensor)))


def fail_worker(workdir: str, rank: int) -> None:
    """A worker's end on an error: its traceback into the run's directory
    (``join_workers`` raises with the first), then exit non-zero."""
    path = os.path.join(workdir, f"error_{rank}.txt")
    with open(path + ".tmp", "w") as f:
        # when, to find the first failure across the workers' processes
        f.write(f"{time.time():.9f}\n{traceback.format_exc()}")  # repro-lint: disable=R103 -- orders worker failures, never reaches state
    os.replace(path + ".tmp", path)  # whole, or not there: the parent may stop this worker at any time
    os._exit(1)


def stop_workers(procs) -> None:
    """Terminate ``procs`` (then kill what is left after 10 s)."""
    for p in procs:
        p.terminate()
    for p in procs:
        p.join(10)
        if p.exitcode is None:
            p.kill()
            p.join()


def join_workers(procs, workdir: str, deadline: Optional[float]) -> None:
    """Wait for every worker. When one exits non-zero, or ``deadline``
    seconds pass (or the wait itself is interrupted), terminate the rest;
    raise with the first failing worker's traceback."""
    t_end = None if deadline is None else time.monotonic() + deadline  # repro-lint: disable=R103 -- a deadline
    alive, failed = list(procs), False
    try:
        while alive and not failed:
            wait = 1.0 if t_end is None else max(0.0, min(1.0, t_end - time.monotonic()))  # repro-lint: disable=R103 -- a deadline
            connection.wait([p.sentinel for p in alive], wait)
            for p in list(alive):
                if p.exitcode is not None:
                    alive.remove(p)
                    failed = failed or p.exitcode != 0
            if t_end is not None and time.monotonic() >= t_end and alive:  # repro-lint: disable=R103 -- a deadline
                break
    finally:
        stop_workers([p for p in procs if p.exitcode is None])
    if not failed and not alive:
        return
    errors = []
    for name in os.listdir(workdir):
        if name.startswith("error_") and name.endswith(".txt"):
            with open(os.path.join(workdir, name)) as f:
                when, _, text = f.read().partition("\n")
            errors.append((float(when), name[len("error_"):-len(".txt")], text))
    errors.sort()
    if errors:
        _, first, text = errors[0]
        others = [rank for _, rank, _ in errors[1:]]
        detail = f"worker rank {first} failed:\n{text}"
        if others:
            detail += f"(ranks {', '.join(others)} failed after it)"
    else:
        codes = {p.name: p.exitcode for p in procs}
        detail = f"the workers left no traceback here (exit codes {codes}; see their standard error)"
    if not failed:
        raise TimeoutError(f"the elastic run did not finish within {deadline} s; its workers were terminated. "
                           + (detail if errors else ""))
    raise RuntimeError(f"an elastic worker failed; the others were terminated. {detail}")
