"""Elastic kill-equivalence on the port, and elastic checkpoints across the
packages, on the CPU (the JAX tests' settings, ``_torch_dist_cases.py``).

- A run killed at update k under device budget W and resumed under W', for
  (k, W, W') in (3, 2, 4), (9, 2, 4), (9, 4, 2), gives the uninterrupted
  run's losses, stages and final params bit for bit: k = 3 dies in the
  narrow stage, k = 9 in the widest, its checkpoint written at width > 1.
- A checkpoint written by JAX's ``ElasticTrainer`` (budget 1) resumes in the
  port's, and one the port wrote at width 2 resumes in JAX's: the meta keys
  ``accountant``, ``data_width`` and ``sync_mode``, the restored ledgers
  equal, the losses that follow within 1e-5 of JAX's uninterrupted run.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_dist_cases import SCHEDULE, param_bytes, port_cfg, port_trainer  # noqa: E402

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

CFG = port_cfg()
JCFG = jax_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
JAX_RTOL = 1e-5
_CACHE: dict = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _reference():
    if "port" not in _CACHE:
        tr, st = port_trainer(1)
        st, log = tr.run(st, log_every=1)
        _CACHE["port"] = (param_bytes(st), log)
    return _CACHE["port"]


@pytest.mark.parametrize("k,w_kill,w_resume", [(3, 2, 4), (9, 2, 4), (9, 4, 2)])
def test_elastic_resume_across_widths(k, w_kill, w_resume, tmp_path):
    ref_params, ref_log = _reference()
    tr, st = port_trainer(w_kill)
    with CheckpointManager(str(tmp_path), keep_last=2) as ckpt:
        tr.run(st, log_every=1, checkpointer=ckpt, save_every=2, stop_after_updates=k)
    tr2, st2 = port_trainer(w_resume)
    with CheckpointManager(str(tmp_path), keep_last=2) as ckpt:
        final, log = tr2.run(st2, log_every=1, checkpointer=ckpt, save_every=2, resume=True)
    assert log.losses == ref_log.losses, (k, w_kill, w_resume)  # float equality is the contract
    assert log.stages == ref_log.stages and log.batch_sizes == ref_log.batch_sizes
    assert param_bytes(final) == ref_params, (k, w_kill, w_resume)
    assert log.comm_bytes[-1] > 0 and log.sync_events[-1] > 0


# -- across the packages --------------------------------------------------------------


def _jax_trainer(steps=None):
    jmodel, jopt = build_model(JCFG), jax_make_optimizer("momentum", beta=0.9)
    tr = JElasticTrainer(jmodel, jopt, JSEBS(**SCHEDULE), JPipeline(JTokenDataset(CFG.vocab_size, 8, 0)),
                         microbatch=4, grad_clip=1.0, device_budget=1)
    if steps is not None:
        tr._steps = steps  # reuse the compiled steps of the reference run
    jparams, _ = jmodel.init(jax.random.key(0))
    return tr, JTrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))


def _jax_reference():
    """JAX's uninterrupted run at budget 1: (log, ledger, compiled steps)."""
    if "jax" not in _CACHE:
        tr, st = _jax_trainer()
        _, log = tr.run(st, log_every=1)
        _CACHE["jax"] = (log, tr.accountant.summary(), tr._steps)
    return _CACHE["jax"]


def _jax_params():
    jparams, _ = build_model(JCFG).init(jax.random.key(0))
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _meta(directory, step):
    return json.loads((directory / f"step_{step:08d}" / "meta.json").read_text())


def test_jax_elastic_checkpoint_resumes_in_the_port(tmp_path):
    ref_log, ref_ledger, steps = _jax_reference()
    tr, st = _jax_trainer(steps)
    with JCheckpointManager(str(tmp_path)) as ckpt:
        tr.run(st, log_every=1, checkpointer=ckpt, save_every=3, stop_after_updates=5)
    meta = _meta(tmp_path, 3)
    assert meta["data_width"] == 1 and meta["sync_mode"] == "exact"
    assert meta["accountant"]["per_stage"]["0"]["updates"] == 3
    ptr, pst = port_trainer(1, _jax_params())
    with CheckpointManager(str(tmp_path)) as ckpt:
        _, log = ptr.run(pst, log_every=1, checkpointer=ckpt, save_every=3, resume=True)
    assert log.losses[:3] == ref_log.losses[:3]  # restored from JAX's meta
    assert log.stages == ref_log.stages and log.batch_sizes == ref_log.batch_sizes
    np.testing.assert_allclose(log.losses, ref_log.losses, rtol=JAX_RTOL)
    # the ledger restored from JAX's meta, and the updates after it, are JAX's
    assert ptr.accountant.summary() == ref_ledger
    assert _meta(tmp_path, 12)["accountant"] == {"per_stage": ref_ledger}


def test_port_elastic_checkpoint_resumes_in_jax(tmp_path):
    ref_log, _, steps = _jax_reference()
    ptr, pst = port_trainer(2, _jax_params())
    with CheckpointManager(str(tmp_path)) as ckpt:
        _, plog = ptr.run(pst, log_every=1, checkpointer=ckpt, save_every=3, stop_after_updates=9)
    meta = _meta(tmp_path, 9)
    assert meta["data_width"] == 2 and meta["sync_mode"] == "exact"
    assert meta["accountant"] == ptr.accountant.state() and meta["accountant"]["per_stage"]["2"]["bytes"] > 0
    tr, st = _jax_trainer(steps)
    with JCheckpointManager(str(tmp_path)) as ckpt:
        _, log = tr.run(st, log_every=1, checkpointer=ckpt, save_every=3, resume=True)
    assert log.losses[:9] == plog.losses  # restored from the port's meta
    assert log.comm_bytes[:9] == plog.comm_bytes and log.sync_events[:9] == plog.sync_events
    assert log.stages == ref_log.stages and log.batch_sizes == ref_log.batch_sizes
    np.testing.assert_allclose(log.losses, ref_log.losses, rtol=JAX_RTOL)
    # JAX restored the port's ledger and added its three width-1 updates of stage 2
    expect = ptr.accountant.summary()
    expect["2"]["updates"] += 3
    assert tr.accountant.summary() == expect
