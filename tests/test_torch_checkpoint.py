"""The port's checkpoint and resume against the JAX package's, on the CPU.

- ``repro_torch.checkpoint`` on its own: round trips (bfloat16, integers),
  retention, torn writes ignored, recovery of a displaced swap, an empty
  directory, bit-exact optimizer state, a copy taken before ``save``
  returns (the optimizers update in place), writer errors at ``wait()``.
- Kill-equivalence on the port (qwen2.5-3b smoke, f32): a run killed after
  update k and resumed in a fresh trainer gives bit-identical losses,
  stages and final params for SEBS and AdaptiveSEBS; an empty directory is
  a cold start; a resume past the stop limit runs no update.
- Across the packages (pSGD and AdamW): a checkpoint written by JAX's
  trainer resumes in the port, one written by the port loads through
  ``repro.checkpoint.load_checkpoint`` into JAX's ``TrainState`` with the
  same leaves, and JAX's trainer resumes from it; the losses of both
  resumed runs stay within 1e-4 relative of JAX's uninterrupted run.

The JAX runs are shared (``_JAX_REF``), and resumed JAX trainers reuse the
compiled steps of the first one.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _propcheck import given, settings, strategies as st  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import SEBS as JSEBS  # noqa: E402
from repro.core import SEBSTrainer as JTrainer  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.data import TokenDataset as JTokenDataset  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
    train_state_from_tree,
    train_state_tree,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SEBS, AdaptiveSEBS, GradientNoiseScale, SEBSTrainer, TrainLog  # noqa: E402
from repro_torch.data import DataPipeline, TokenDataset  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train.state import TrainState, init_train_state  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

RTOL = 1e-4  # cross-package losses (f32, the same formulas summed in other orders)
CFG = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
JCFG = jax_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, where torch's default of one thread a core oversubscribes
    the host."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _leaf_bytes(tree):
    return [np.asarray(x.float() if isinstance(x, torch.Tensor) else x).tobytes()
            for x in jax.tree.leaves(tree)]


# -- the checkpoint module ---------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3, dtype=torch.bfloat16)},
            "step": np.int32(17), "layers": [torch.zeros(2), torch.ones(2)]}
    save_checkpoint(str(tmp_path), 17, tree, meta={"samples": 1234})
    assert latest_step(str(tmp_path)) == 17
    restored, meta = load_checkpoint(str(tmp_path), 17)
    assert meta["samples"] == 1234 and meta["step"] == 17
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["b"], tree["params"]["b"])
    np.testing.assert_array_equal(restored["params"]["w"], tree["params"]["w"].numpy())
    np.testing.assert_array_equal(restored["layers"]["1"], np.ones(2, np.float32))
    assert restored["step"].dtype == np.int32 and int(restored["step"]) == 17


def test_checkpoint_roundtrip_optimizer_state_bitexact(tmp_path):
    """A full train state in the JAX layout (bf16 params, param-shaped
    optimizer slots, int counters) round-trips bit for bit."""
    model = LanguageModel(CFG.replace(param_dtype="bfloat16"))
    opt = make_optimizer("adamw")
    state = init_train_state(model, opt, seed=3, device="cpu")
    for leaf in tree_leaves(state.opt_state["m"]):
        leaf.normal_()
    state.opt_state["count"] = 41
    tree = {"train_state": TrainState(bridge.params_to_numpy(state.params, CFG),
                                      bridge.opt_state_to_numpy(state.opt_state, CFG), np.int32(41))}
    save_checkpoint(str(tmp_path), 41, tree)
    restored, meta = load_checkpoint(str(tmp_path), 41)
    saved = restored["train_state"]
    assert set(saved) == {".params", ".opt_state", ".step"}
    assert saved[".params"]["embed"]["table"].dtype == torch.bfloat16
    got = TrainState(bridge.params_from_numpy(saved[".params"], CFG, "cpu"),
                     bridge.opt_state_from_numpy(saved[".opt_state"], CFG, "cpu"), int(saved[".step"]))
    assert got.opt_state["count"] == 41 and got.opt_state["stage"] == 0
    for key in ("params", "m"):
        same = tree_map(lambda a, b: a.dtype == b.dtype and torch.equal(a, b),
                        state.params if key == "params" else state.opt_state["m"],
                        got.params if key == "params" else got.opt_state["m"])
        assert all(tree_leaves(same)), key


def test_checkpoint_manager_retention_and_async(tmp_path):
    tree = {"w": torch.arange(3.0)}
    with CheckpointManager(str(tmp_path), keep_last=2) as mgr:
        for step in (1, 2, 3, 4):
            mgr.save(step, tree, meta={"update": step})
        mgr.wait()
        assert mgr.latest_step() == 4
        dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
        assert dirs == ["step_00000003", "step_00000004"]
        assert mgr.restore_latest()[1]["update"] == 4


def test_checkpoint_manager_ignores_torn_writes(tmp_path):
    with CheckpointManager(str(tmp_path), keep_last=3) as mgr:
        mgr.save(5, {"w": torch.arange(3.0)})
        mgr.wait()
        torn = tmp_path / "step_00000009.tmp"
        torn.mkdir()
        (torn / "arrays.npz").write_bytes(b"partial garbage")
        assert mgr.latest_step() == 5
        assert mgr.restore()[1]["step"] == 5


def test_checkpoint_recovers_checkpoint_displaced_by_killed_swap(tmp_path):
    save_checkpoint(str(tmp_path), 7, {"w": torch.arange(3.0)}, meta={"update": 7})
    os.rename(tmp_path / "step_00000007", tmp_path / "step_00000007.old")
    assert latest_step(str(tmp_path)) == 7
    restored, meta = load_checkpoint(str(tmp_path), 7)
    assert meta["update"] == 7
    np.testing.assert_array_equal(restored["w"], np.arange(3.0, dtype=np.float32))


def test_checkpoint_manager_restore_latest_empty_dir(tmp_path):
    with CheckpointManager(str(tmp_path / "fresh")) as mgr:
        assert mgr.restore_latest() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore()


@pytest.mark.parametrize("tree_of", ["tensors", "train_state_tree"])
def test_save_copies_before_returning(tree_of, tmp_path):
    """The optimizers update in place, and on the CPU ``.numpy()`` aliases a
    tensor: save (the live tensors, or the trainer's tree in the JAX
    layout), update, then wait for the writer; the checkpoint holds the
    state from before the update."""
    model = LanguageModel(CFG)
    opt = make_optimizer("momentum")
    state = init_train_state(model, opt, seed=0, device="cpu")
    params, us = tree_leaves(state.params), tree_leaves(state.opt_state["u"])
    before = [t.clone() for t in params]
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(1, {"params": params, "u": us} if tree_of == "tensors" else train_state_tree(state, CFG))
        opt.update([torch.ones_like(t) for t in params], state.opt_state, state.params, lr=0.5, stage=0)
        mgr.wait()
        tree, _ = mgr.restore(1)
    assert not torch.equal(before[0], params[0]) and us[0].any()  # the update moved them
    if tree_of == "tensors":
        got_params, got_us = [tree["params"][str(i)] for i in range(len(params))], tree["u"].values()
    else:
        got = train_state_from_tree(tree, state, CFG)
        got_params, got_us = tree_leaves(got.params), tree_leaves(got.opt_state["u"])
    for a, b in zip(before, got_params, strict=True):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())
    assert not any(np.asarray(u).any() for u in got_us)


def test_writer_errors_surface_at_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(2)}, meta={"bad": object()})  # not JSON
    with pytest.raises(TypeError):
        mgr.wait()
    mgr.close()


# -- kill-equivalence on the port ------------------------------------------------


class _EchoDataset:
    """Every position repeats the row's start token, keyed by sample offset:
    learnable fast, so AdaptiveSEBS's trigger fires within a short run."""

    def __init__(self, vocab_size, seq_len, seed=0):
        self.vocab_size, self.seq_len, self.seed = vocab_size, seq_len, seed

    def batch(self, offset, batch_size):
        start = [np.random.default_rng([self.seed, offset + i]).integers(self.vocab_size)
                 for i in range(batch_size)]
        return {"tokens": np.repeat(np.asarray(start, np.int32)[:, None], self.seq_len + 1, axis=1)}


def _sebs_schedule():
    return SEBS(b1=4, C1=24, rho=2.0, num_stages=2, eta=0.05)  # 6 + 6 updates


def _adaptive_schedule():
    return AdaptiveSEBS(b1=4, eta=0.02, total=320, rho_max=4.0, min_stage_samples=64, smooth=0.5)


def _trainer(make_schedule):
    ds_cls = _EchoDataset if make_schedule is _adaptive_schedule else TokenDataset
    model = LanguageModel(CFG)
    opt = make_optimizer("momentum", beta=0.9)
    trainer = SEBSTrainer(model, opt, make_schedule(), DataPipeline(ds_cls(CFG.vocab_size, 8, 0), "cpu"),
                          microbatch=4, mode="accumulate", accum_mode="psum_each", grad_clip=1.0)
    return trainer, init_train_state(model, opt, seed=0, device="cpu")


def _param_bytes(state):
    return [t.detach().numpy().tobytes() for t in tree_leaves(state.params)]


_REF_CACHE: dict = {}


def _reference_run(make_schedule):
    if make_schedule not in _REF_CACHE:
        trainer, state = _trainer(make_schedule)
        state, log = trainer.run(state, log_every=1)
        _REF_CACHE[make_schedule] = (_param_bytes(state), log)
    return _REF_CACHE[make_schedule]


def _kill_and_resume(make_schedule, k, ckpt_dir, save_every=2):
    trainer, state = _trainer(make_schedule)
    with CheckpointManager(ckpt_dir, keep_last=2) as ckpt:
        trainer.run(state, log_every=1, checkpointer=ckpt, save_every=save_every, stop_after_updates=k)
    trainer2, state2 = _trainer(make_schedule)
    with CheckpointManager(ckpt_dir, keep_last=2) as ckpt2:
        final, log = trainer2.run(state2, log_every=1, checkpointer=ckpt2, save_every=save_every, resume=True)
    return _param_bytes(final), log


@given(k=st.integers(1, 11))
@settings(max_examples=3, deadline=None)
def test_kill_equivalence_sebs(k, tmp_path_factory):
    ref_params, ref_log = _reference_run(_sebs_schedule)
    params, log = _kill_and_resume(_sebs_schedule, k, str(tmp_path_factory.mktemp(f"k{k}")))
    assert log.losses == ref_log.losses  # float equality is the contract
    assert log.stages == ref_log.stages and log.batch_sizes == ref_log.batch_sizes
    assert params == ref_params


def test_kill_equivalence_adaptive_sebs(tmp_path):
    ref_params, ref_log = _reference_run(_adaptive_schedule)
    assert max(ref_log.batch_sizes) > 4  # the schedule grew
    params, log = _kill_and_resume(_adaptive_schedule, 20, str(tmp_path), save_every=3)
    assert log.losses == ref_log.losses
    assert log.stages == ref_log.stages and log.batch_sizes == ref_log.batch_sizes
    assert params == ref_params


def test_resume_with_empty_dir_is_cold_start(tmp_path):
    ref_params, ref_log = _reference_run(_sebs_schedule)
    trainer, state = _trainer(_sebs_schedule)
    with CheckpointManager(str(tmp_path / "empty")) as ckpt:
        final, log = trainer.run(state, log_every=1, checkpointer=ckpt, resume=True)
        assert ckpt.latest_step() == 12  # a completed run leaves a final checkpoint
    assert log.losses == ref_log.losses and _param_bytes(final) == ref_params


def test_resume_past_stop_limit_runs_no_extra_update(tmp_path):
    trainer, state = _trainer(_sebs_schedule)
    with CheckpointManager(str(tmp_path)) as ckpt:
        trainer.run(state, log_every=1, checkpointer=ckpt, save_every=2, stop_after_updates=5)
    trainer2, state2 = _trainer(_sebs_schedule)
    with CheckpointManager(str(tmp_path)) as ckpt2:
        _, log = trainer2.run(state2, log_every=1, checkpointer=ckpt2, save_every=2, resume=True,
                              stop_after_updates=3)
        assert ckpt2.latest_step() == 4  # nothing new written
    assert log.steps[-1] == 4 and trainer2.pipeline.samples_consumed == 16


# -- across the packages -----------------------------------------------------------

# name: (hyperparameters, learning rate); AdamW at a usual Adam rate: at
# pSGD's 0.05 its near-sign updates of near-zero gradients turn f32
# rounding into differences of 1e-3 within eight updates in either package
OPTIMIZERS = {"psgd": ({"gamma": 1e4}, 0.05), "adamw": ({}, 1e-3)}
_JAX_REF: dict = {}


def _sched(pkg, name):
    return pkg(b1=4, C1=16, rho=2.0, num_stages=2, eta=OPTIMIZERS[name][1])  # 4 + 4 updates


def _jax_trainer(name, steps=None):
    jmodel, jopt = build_model(JCFG), jax_make_optimizer(name, **OPTIMIZERS[name][0])
    trainer = JTrainer(jmodel, jopt, _sched(JSEBS, name), JPipeline(JTokenDataset(CFG.vocab_size, 8, 0)),
                       microbatch=4, mode="accumulate", accum_mode="psum_each")
    if steps is not None:
        trainer._steps = steps  # reuse the compiled steps of the reference run
    params, _ = jmodel.init(jax.random.key(0))
    return trainer, JTrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))


def _port_trainer(name):
    model, opt = LanguageModel(CFG), make_optimizer(name, **OPTIMIZERS[name][0])
    jparams, _ = build_model(JCFG).init(jax.random.key(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")
    trainer = SEBSTrainer(model, opt, _sched(SEBS, name), DataPipeline(TokenDataset(CFG.vocab_size, 8, 0), "cpu"),
                          microbatch=4, mode="accumulate", accum_mode="psum_each")
    return trainer, TrainState(params, opt.init(params), 0)


def _jax_reference(name):
    """JAX's uninterrupted run: (final state, log, compiled steps)."""
    if name not in _JAX_REF:
        trainer, state = _jax_trainer(name)
        state, log = trainer.run(state, log_every=1)
        _JAX_REF[name] = (state, log, trainer._steps)
    return _JAX_REF[name]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_jax_checkpoint_resumes_in_the_port(name, tmp_path):
    _, ref_log, steps = _jax_reference(name)
    trainer, state = _jax_trainer(name, steps)
    with JCheckpointManager(str(tmp_path)) as ckpt:
        trainer.run(state, log_every=1, checkpointer=ckpt, save_every=3, stop_after_updates=5)
    ptrainer, pstate = _port_trainer(name)
    with CheckpointManager(str(tmp_path)) as ckpt:
        _, log = ptrainer.run(pstate, log_every=1, checkpointer=ckpt, save_every=3, resume=True)
    assert log.losses[:3] == ref_log.losses[:3]  # restored from JAX's meta
    assert log.stages == ref_log.stages and log.batch_sizes == ref_log.batch_sizes
    np.testing.assert_allclose(log.losses, ref_log.losses, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_port_checkpoint_loads_into_jax_and_resumes_there(name, tmp_path):
    ref_state, ref_log, steps = _jax_reference(name)
    ptrainer, pstate = _port_trainer(name)
    with CheckpointManager(str(tmp_path)) as ckpt:
        pstate, _ = ptrainer.run(pstate, log_every=1, checkpointer=ckpt, save_every=3, stop_after_updates=5)
    # the port's checkpoint at update 3 loads onto JAX's TrainState target
    trainer, state = _jax_trainer(name, steps)
    tree, meta = jax_load_checkpoint(str(tmp_path), 3, {"train_state": state})
    assert meta["update"] == 3 and set(meta) >= {"pipeline", "gns", "host_rng", "log"}
    loaded = tree["train_state"]
    assert int(loaded.step) == 3 and int(loaded.opt_state["stage"]) == 0
    assert jax.tree.structure(loaded) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(state)):
        assert np.asarray(a).shape == np.asarray(b).shape and np.asarray(a).dtype == np.asarray(b).dtype
    # the port's final state (update 5) is what it saves: the same leaves
    with CheckpointManager(str(tmp_path / "final")) as ckpt:
        ptrainer._save(ckpt, 5, pstate, TrainLog(), GradientNoiseScale())
    tree5, _ = jax_load_checkpoint(str(tmp_path / "final"), 5, {"train_state": state})
    expect = JTrainState(bridge.params_to_numpy(pstate.params, CFG),
                         bridge.opt_state_to_numpy(pstate.opt_state, CFG), np.int32(5))
    assert _leaf_bytes(tree5["train_state"]) == _leaf_bytes(expect)
    # JAX's trainer resumes from the port's directory
    with JCheckpointManager(str(tmp_path)) as ckpt:
        _, log = trainer.run(state, log_every=1, checkpointer=ckpt, save_every=3, resume=True)
    assert log.stages == ref_log.stages and log.batch_sizes == ref_log.batch_sizes
    np.testing.assert_allclose(log.losses, ref_log.losses, rtol=RTOL)


def test_train_launcher_resumes_to_the_uninterrupted_log(tmp_path):
    """``--ckpt-every 2 --stop-after 3``, then ``--resume``: the resumed
    run's ``--log-json`` is the uninterrupted run's."""
    import json

    from repro_torch.launch import train as launcher

    base = ["--device", "cpu", "--seq", "32", "--b1", "2", "--c1", "4", "--rho", "2", "--stages", "2",
            "--steps-log", "1"]
    ckpt = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    launcher.main(base + ["--log-json", str(tmp_path / "ref.json")])
    launcher.main(base + ckpt + ["--stop-after", "3"])
    launcher.main(base + ckpt + ["--resume", "--log-json", str(tmp_path / "resumed.json")])
    ref, resumed = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("ref", "resumed"))
    np.testing.assert_equal(resumed, ref)
    assert ref["steps"] == [1, 2, 3, 4]
    with pytest.raises(SystemExit):
        launcher.main(base + ["--resume"])  # --resume requires --ckpt-dir
    with pytest.raises(SystemExit):
        launcher.main(base + ckpt + ["--stop-after", "0"])
