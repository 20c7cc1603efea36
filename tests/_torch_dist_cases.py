"""What the elastic trainer's CPU tests share: the JAX tests' settings
(qwen2.5-3b smoke in float32, seq 8, microbatch 4, SEBS b1 4, C1 16, rho 2,
3 stages; momentum 0.9, eta 0.05, clip 1.0), the port's trainers on CPU
workers, the JAX package's elastic trainer at budget 4 in a subprocess with
four host devices, and datasets that plant a failure in one worker.

This module imports no JAX at import time: a worker process unpickles the
datasets from it.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 600.0  # seconds a test's elastic run may take in all
SCHEDULE = dict(b1=4, C1=16, rho=2.0, num_stages=3, eta=0.05)


def port_cfg():
    from repro_torch.configs import get_config

    return get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")


def port_trainer(budget, params=None, *, sync_mode="exact", optimizer=("momentum", {"beta": 0.9}),
                 grad_clip=1.0, dataset=None, seed=0, **kw):
    """(ElasticTrainer on ``budget`` CPU workers, its state): seed-0 weights
    of the port, or ``params`` (a port tree, copied)."""
    import torch

    from repro_torch.core import SEBS
    from repro_torch.data import DataPipeline, TokenDataset
    from repro_torch.distributed import ElasticTrainer
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.train.state import TrainState
    from repro_torch.utils.tree import tree_map

    cfg = port_cfg()
    model = LanguageModel(cfg)
    opt = make_optimizer(optimizer[0], **optimizer[1])
    ds = dataset if dataset is not None else TokenDataset(cfg.vocab_size, 8, 0)
    tr = ElasticTrainer(model, opt, SEBS(**SCHEDULE), DataPipeline(ds, "cpu"), microbatch=4, grad_clip=grad_clip,
                        sync_mode=sync_mode, device_budget=budget, devices=[torch.device("cpu")] * budget,
                        deadline=kw.pop("deadline", DEADLINE), **kw)
    params = model.init(seed, device="cpu") if params is None else tree_map(lambda t: t.clone(), params)
    return tr, TrainState(params, opt.init(params), 0)


def param_bytes(state):
    from repro_torch.utils.tree import tree_leaves

    return [t.detach().numpy().tobytes() for t in tree_leaves(state.params)]


_JAX_BUDGET4 = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys, tempfile
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp
    from repro.checkpoint import CheckpointManager
    from repro.configs import get_config
    from repro.core import SEBS
    from repro.data import DataPipeline, TokenDataset
    from repro.distributed import ElasticTrainer
    from repro.models import build_model
    from repro.optim import make_optimizer
    from repro.train.state import TrainState

    cfg = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    model = build_model(cfg)

    def make(sync_mode, **kw):
        opt = make_optimizer("momentum", beta=0.9)
        tr = ElasticTrainer(model, opt, SEBS(b1=4, C1=16, rho=2.0, num_stages=3, eta=0.05),
                            DataPipeline(TokenDataset(vocab_size=cfg.vocab_size, seq_len=8, seed=0)),
                            microbatch=4, grad_clip=1.0, sync_mode=sync_mode, device_budget=4, **kw)
        params, _ = model.init(jax.random.key(0))
        return tr, TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))

    out = {}
    tr, st = make("exact")
    st, log = tr.run(st, log_every=1)
    out["exact"] = {"log": log.as_dict(), "summary": tr.accountant.summary()}
    tr, st = make("local", local_interval=2)
    with tempfile.TemporaryDirectory() as td:
        with CheckpointManager(td, keep_last=10) as ck:
            st, log = tr.run(st, log_every=1, checkpointer=ck, save_every=3)
        saves = sorted(int(d.split("_")[1]) for d in os.listdir(td) if d.startswith("step_"))
    out["local"] = {"log": log.as_dict(), "summary": tr.accountant.summary(), "saves": saves}
    print("JAX_BUDGET4 " + json.dumps(out))
    """
)


class JaxBudget4:
    """The JAX package's ElasticTrainer at budget 4, exact and local sync
    (local_interval 2, save_every 3), in a subprocess started at once; its
    logs, ledgers and saves are read when first asked for."""

    def __init__(self):
        self._proc = subprocess.Popen([sys.executable, "-c", _JAX_BUDGET4], cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
        self._out = None

    def result(self, timeout: float = DEADLINE) -> dict:
        if self._out is None:
            try:
                out, err = self._proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                raise
            lines = [ln for ln in out.splitlines() if ln.startswith("JAX_BUDGET4 ")]
            assert self._proc.returncode == 0 and lines, out + err
            self._out = json.loads(lines[-1][len("JAX_BUDGET4 "):])
        return self._out

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()


class FailingDataset:
    """The token stream, but rank ``rank``'s worker fails at sample offset
    ``at``: it raises, or (``hang``) sleeps until it is terminated."""

    def __init__(self, vocab_size, seq_len, rank, at, hang=False):
        from repro_torch.data import TokenDataset

        self.ds = TokenDataset(vocab_size, seq_len, 0)
        self.rank, self.at, self.hang = rank, at, hang

    def batch(self, offset, batch_size):
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_rank() == self.rank and offset >= self.at:
            if self.hang:
                time.sleep(3600)
            raise RuntimeError(f"planted failure in worker {self.rank} at sample offset {offset}")
        return self.ds.batch(offset, batch_size)


def finite(xs) -> bool:
    return bool(np.all(np.isfinite(xs)))
