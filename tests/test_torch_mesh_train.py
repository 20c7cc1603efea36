"""Rule-based storage sharding in training, on CPU workers (gloo, one
intra-op thread each; qwen2.5-3b smoke in float32, the JAX tests' SEBS
schedule, momentum 0.9, clip 1.0: ``_torch_dist_cases.py``).

- ``SEBSTrainer(mesh=make_host_mesh(...), param_axes=...)`` at (1, 1),
  (2, 1), (1, 2), (2, 2) and (2, 1, 2) gives ``ElasticTrainer``'s budget-1
  losses, stages, GNS and params bit for bit;
- ``ElasticTrainer(param_axes=...)`` at budgets 1, 2 and 4 gives its
  unsharded run's bit for bit;
- the shards of every leaf, gathered by four workers over the host slots on
  (1, 4) (qwen's 2 kv heads fall back to ``head_dim`` there) and on (2, 2),
  rebuild it bit for bit, on every worker and on rank 0 alone;
- the device exchange (NCCL's code, over gloo here) keeps the host slots'
  bits for the gather, the partials' exchange and the move to rank 0;
- LARS and LAMB on (2, 2) stay within 1e-6 of the unsharded run (their
  trust ratios combine per-shard sums of squares);
- a sharded elastic run's checkpoints (budget 4) equal an unsharded run's
  array for array, byte for byte, with the same meta, and JAX's trainer
  resumes one;
- the launcher's ``--mesh single --device cpu``.
"""
import json
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_dist_cases import (  # noqa: E402
    SCHEDULE,
    exchange_worker,
    gather_worker,
    param_bytes,
    port_cfg,
    port_trainer,
)

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import SEBS as JSEBS  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.data import TokenDataset as JTokenDataset  # noqa: E402
from repro.distributed import ElasticTrainer as JElasticTrainer  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import SEBS, SEBSTrainer  # noqa: E402
from repro_torch.data import DataPipeline, TokenDataset  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

CFG = port_cfg()
AXES = LanguageModel(CFG).param_axes()
DEADLINE = 300.0
_CACHE: dict = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _reference(optimizer=("momentum", {"beta": 0.9})):
    """ElasticTrainer at budget 1: (log, final params)."""
    key = optimizer[0]
    if key not in _CACHE:
        tr, st = port_trainer(1, optimizer=optimizer)
        st, log = tr.run(st, log_every=1)
        _CACHE[key] = (log, st.params)
    return _CACHE[key]


def _mesh_run(shape, optimizer=("momentum", {"beta": 0.9}), **run_kw):
    model = LanguageModel(CFG)
    opt = make_optimizer(optimizer[0], **optimizer[1])
    mesh = make_host_mesh(*shape[-2:], pod=shape[0] if len(shape) == 3 else None,
                          devices=["cpu"] * int(np.prod(shape)))
    trainer = SEBSTrainer(model, opt, SEBS(**SCHEDULE), DataPipeline(TokenDataset(CFG.vocab_size, 8, 0), mesh),
                          mesh=mesh, param_axes=AXES, microbatch=4, grad_clip=1.0, deadline=DEADLINE)
    params = model.init(0, device="cpu")
    state, log = trainer.run(TrainState(params, opt.init(params), 0), log_every=1, **run_kw)
    return trainer, state, log


def _same_log(log, ref):
    return (log.losses == ref.losses and log.stages == ref.stages and log.batch_sizes == ref.batch_sizes
            and json.dumps(log.noise_scales) == json.dumps(ref.noise_scales))


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2), (2, 1, 2)])
def test_sebs_trainer_on_a_mesh_equals_elastic_budget_1(shape):
    ref_log, ref_params = _reference()
    trainer, state, log = _mesh_run(shape)
    assert _same_log(log, ref_log), (log.losses, ref_log.losses)
    assert param_bytes(state) == param_bytes(TrainState(ref_params, {}, 0))
    assert state.step == 12 and state.opt_state["stage"] == 2
    assert len(trainer.worker_stats) == int(np.prod(shape))
    assert log.comm_bytes == [0] * len(log.steps)  # the single-process trainer's log


@pytest.mark.parametrize("budget", [1, 2, 4])
def test_elastic_param_axes_equals_unsharded(budget):
    ref_log, ref_params = _reference()
    tr, st = port_trainer(budget, param_axes=AXES)
    st, log = tr.run(st, log_every=1)
    assert _same_log(log, ref_log)
    assert param_bytes(st) == param_bytes(TrainState(ref_params, {}, 0))
    widths = sorted({k[1] for k in tr._steps})
    assert widths == [1, 2, 4][:budget.bit_length()]
    if budget > 1:
        assert all(s["sharded"] for s in tr.worker_stats[:budget])


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_shard_gather_rebuilds_every_leaf(shape, tmp_path):
    torch.multiprocessing.spawn(gather_worker, args=(4, str(tmp_path), shape), nprocs=4, join=True)
    counts = {(tmp_path / f"ok_{r}").read_text() for r in range(4)}
    assert len(counts) == 1 and int(counts.pop()) > 0


def test_device_exchange_keeps_the_host_slots_bits(tmp_path):
    """The device exchange's code (NCCL on the card) over gloo on four CPU
    workers: the gather, the partials' exchange and the move to rank 0
    give the host slots' bits."""
    torch.multiprocessing.spawn(exchange_worker, args=(4, str(tmp_path), "gloo", False), nprocs=4, join=True)
    assert all((tmp_path / f"ok_{r}").exists() for r in range(4))


def _rel_norms(params, ref):
    return [float((a - b).norm() / b.norm()) for a, b in zip(tree_leaves(params), tree_leaves(ref), strict=True)]


@pytest.mark.parametrize("name", ["lars", "lamb"])
def test_trust_ratios_within_1e6_of_unsharded(name):
    """The losses within 1e-6, and each leaf within 1e-6 of its norm: over
    the run for LARS; after the first update for LAMB, whose later updates
    of the attention's k bias (a gradient that is rounding noise alone: a
    bias added to every key moves no softmax) normalize that noise to unit
    steps, so any difference in the other leaves reaches it whole."""
    ref_log, ref_params = _reference((name, {}))
    _, state, log = _mesh_run((2, 2), (name, {}))
    np.testing.assert_allclose(log.losses, ref_log.losses, rtol=1e-6)
    assert log.stages == ref_log.stages
    if name == "lamb":
        tr, ref_state = port_trainer(1, optimizer=(name, {}))
        ref_state, _ = tr.run(ref_state, log_every=1, stop_after_updates=1)
        ref_params = ref_state.params
        _, state, _ = _mesh_run((2, 2), (name, {}), stop_after_updates=1)
    assert max(_rel_norms(state.params, ref_params)) <= 1e-6


def _arrays(directory, step):
    with np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as data:
        return {k: (data[k].dtype.str, data[k].tobytes()) for k in data.files}


def _meta(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)


def test_sharded_checkpoints_equal_unsharded_and_resume_in_jax(tmp_path):
    jcfg = jax_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    jmodel = build_model(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")
    full_dir, sharded_dir = tmp_path / "full", tmp_path / "sharded"
    tr, st = port_trainer(4, params)
    with CheckpointManager(str(full_dir), keep_last=10) as ckpt:
        _, full_log = tr.run(st, log_every=1, checkpointer=ckpt, save_every=3)
    tr, st = port_trainer(4, params, param_axes=AXES)
    with CheckpointManager(str(sharded_dir), keep_last=10) as ckpt:
        _, log = tr.run(st, log_every=1, checkpointer=ckpt, save_every=3, stop_after_updates=9)
    assert log.losses == full_log.losses[:9]
    for step in (3, 6, 9):
        assert _arrays(sharded_dir, step) == _arrays(full_dir, step), step
        assert _meta(sharded_dir, step) == _meta(full_dir, step), step
    jopt = jax_make_optimizer("momentum", beta=0.9)
    jtr = JElasticTrainer(jmodel, jopt, JSEBS(**SCHEDULE), JPipeline(JTokenDataset(CFG.vocab_size, 8, 0)),
                          microbatch=4, grad_clip=1.0, device_budget=1)
    jst = JTrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    with JCheckpointManager(str(sharded_dir)) as ckpt:
        _, jlog = jtr.run(jst, log_every=1, checkpointer=ckpt, save_every=3, resume=True)
    assert jlog.losses[:9] == log.losses  # restored from the sharded run's meta
    np.testing.assert_allclose(jlog.losses, full_log.losses, rtol=1e-5)


def test_launcher_mesh_on_the_cpu():
    from repro_torch.launch.train import main

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "log.json")
        log = main(["--device", "cpu", "--mesh", "single", "--b1", "4", "--c1", "16", "--rho", "2", "--seq", "8",
                    "--steps-log", "1", "--log-json", path])
        with open(path) as f:
            assert json.load(f)["losses"] == log.losses
    assert len(log.losses) == 12 and all(np.isfinite(log.losses))
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--mesh", "single", "--dp-elastic"])
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--mesh", "multi"])
