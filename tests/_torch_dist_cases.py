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


def gather_worker(rank, world, workdir, shape):
    """One of ``world`` CPU workers: its shards of qwen2.5-3b smoke's pSGD
    state on a ``shape`` host mesh, gathered back whole (``gather_params``
    on every rank, ``move_state`` onto rank 0); writes ``ok_<rank>`` when
    every leaf has the bits of the state it was cut from."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.reshard import reshard_state, state_shardings
    from repro_torch.distributed.sharded import gather_params, move_state, tensor_leaves, tensor_shardings
    from repro_torch.distributed.staging import HostExchange, StagingTimes
    from repro_torch.launch.mesh import make_data_mesh, make_host_mesh, prefix_groups
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.train.state import TrainState
    from repro_torch.utils.tree import tree_leaves

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "store"), rank=rank,
                            world_size=world)
    try:
        model = LanguageModel(port_cfg())
        params = model.init(0, device="cpu")
        opt = make_optimizer("psgd")
        state = TrainState(params, opt.init(params), 5)
        mesh = make_host_mesh(*shape, devices=["cpu"] * world)
        exchange = HostExchange(workdir, rank, world, 1 << 22)
        xmesh = make_data_mesh(world, ["cpu"] * world, prefix_groups(world), exchange)
        mine = reshard_state(state, mesh, model.param_axes(), rank)
        layout = tensor_shardings(state_shardings(state, mesh, model.param_axes()), state)
        n_params = len(tree_leaves(params))
        full = gather_params(mine.params, layout[:n_params], rank, xmesh, StagingTimes())
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(full), tree_leaves(params), strict=True))
        whole = tensor_shardings(state_shardings(state, make_data_mesh(1, ["cpu"]), None), state)
        back = move_state(mine, state, layout, whole, rank, xmesh, StagingTimes())
        if rank == 0:
            same = same and back.step == 5 and all(
                torch.equal(a, b) for a, b in zip(tensor_leaves(back), tensor_leaves(state), strict=True))
        else:
            same = same and back is None
        sharded = sum(not s.replicated for s in layout)
        if same and sharded:
            open(os.path.join(workdir, f"ok_{rank}"), "w").write(str(sharded))
    finally:
        dist.destroy_process_group()


def exchange_worker(rank, world, workdir, backend, on_cuda):
    """One of ``world`` workers (on cuda:<rank> where ``on_cuda``): the
    shards of qwen2.5-3b smoke's pSGD state on a (world // 2, 2) host mesh
    gathered whole, a partial sum of seeded terms exchanged and tree-summed,
    and the state moved onto rank 0, once through the shared host slots and
    once through ``DeviceExchange`` over ``backend``; writes ``ok_<rank>``
    when both give the same bits."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.nccl import DeviceExchange
    from repro_torch.distributed.reshard import reshard_state, state_shardings
    from repro_torch.distributed.sharded import gather_params, move_state, tensor_leaves, tensor_shardings
    from repro_torch.distributed.staging import HostExchange, StagingTimes
    from repro_torch.distributed.step import _combine_across
    from repro_torch.launch.mesh import make_data_mesh, make_host_mesh, prefix_groups
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.train.state import TrainState
    from repro_torch.utils.tree import tree_leaves

    torch.set_num_threads(1)
    device = torch.device("cuda", rank) if on_cuda else torch.device("cpu")
    if on_cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "store"), rank=rank,
                            world_size=world)
    try:
        model = LanguageModel(port_cfg())
        params = model.init(0, device=device)
        state = TrainState(params, make_optimizer("psgd").init(params), 7)
        mesh = make_host_mesh(world // 2, 2, devices=[device] * world)
        layout = tensor_shardings(state_shardings(state, mesh, model.param_axes()), state)
        whole = tensor_shardings(state_shardings(state, make_data_mesh(1, [device]), None), state)
        n = len(tree_leaves(params))
        gen = torch.Generator().manual_seed(rank)
        grads = [torch.randn(t.shape, generator=gen).to(device) for t in tree_leaves(params)]
        groups = prefix_groups(world)
        results = []
        for exchange in (HostExchange(workdir, rank, world, 1 << 22), DeviceExchange(rank, world, device, backend)):
            xmesh = make_data_mesh(world, [device] * world, groups, exchange)
            mine = reshard_state(state, mesh, model.param_axes(), rank)
            full = tree_leaves(gather_params(mine.params, layout[:n], rank, xmesh, StagingTimes()))
            total = {"grads": [g.clone() for g in grads], "loss": torch.tensor(1.0 + rank, device=device),
                     "aux": torch.tensor(0.0, device=device), "sq": torch.tensor(2.0 * rank, device=device)}
            summed = _combine_across(total, xmesh, StagingTimes())
            back = move_state(mine, state, layout, whole, rank, xmesh, StagingTimes())
            results.append((full, summed["grads"] + [summed["loss"], summed["sq"]],
                            tensor_leaves(back) if back is not None else []))
        (f1, s1, b1), (f2, s2, b2) = results
        same = (all(torch.equal(a, b) for a, b in zip(f1, f2, strict=True))
                and all(torch.equal(a, b) for a, b in zip(f1, tree_leaves(params), strict=True))
                and all(torch.equal(a, b) for a, b in zip(s1, s2, strict=True))
                and all(torch.equal(a, b) for a, b in zip(b1, b2, strict=True)) and len(b1) == len(b2))
        if same:
            open(os.path.join(workdir, f"ok_{rank}"), "w").write("ok")
    finally:
        dist.destroy_process_group()
