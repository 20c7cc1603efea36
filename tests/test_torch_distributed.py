"""The port's elastic data-parallel training (``src/repro_torch/distributed/``)
against the JAX package's, on the CPU.

- The planner, the sync scheduler, the byte models and the accountant's JSON
  round trip give JAX's outputs for the same inputs; ``span_tree_sum`` is
  bitwise the width-1 tree under chunking and equal to JAX's on the same
  float32 terms; ``float_state_bytes`` equals JAX's; the fewer-syncs table
  (``experiments/table_comm.py``) gives the JAX file's records.
- ``ElasticTrainer`` (qwen2.5-3b smoke, f32; momentum 0.9, eta 0.05, clip
  1.0; JAX's weights through ``bridge.py``) at budgets 1, 2 and 4 on CPU
  workers: bitwise equal losses, stages, GNS and params; within 1e-5 of
  JAX's ``ElasticTrainer`` at budget 1 (in process); within 1e-4 of the
  port's ``SEBSTrainer``; ``comm_bytes`` and ``sync_events`` equal to JAX's
  trainer at budget 4 (a subprocess with four host devices, started when the
  module loads).
- Local SGD at budget 4: saves at [3, 6, 10, 12] and the ledger of JAX's
  trainer; with local_interval 1 and plain SGD within 1e-6 of exact sync.

Each run spawns its workers, one intra-op thread each.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_dist_cases import SCHEDULE, JaxBudget4, finite, param_bytes, port_cfg, port_trainer  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import SEBS as JSEBS  # noqa: E402
from repro.core.stages import StageController as JStageController  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.data import TokenDataset as JTokenDataset  # noqa: E402
from repro.distributed import CommAccountant as JCommAccountant  # noqa: E402
from repro.distributed import ElasticMeshPlanner as JPlanner  # noqa: E402
from repro.distributed import ElasticTrainer as JElasticTrainer  # noqa: E402
from repro.distributed import SyncScheduler as JSyncScheduler  # noqa: E402
from repro.distributed import allgather_bytes_per_device as jax_allgather  # noqa: E402
from repro.distributed import allreduce_bytes_per_device as jax_allreduce  # noqa: E402
from repro.distributed import float_state_bytes as jax_float_state_bytes  # noqa: E402
from repro.distributed import span_tree_sum as jax_span_tree_sum  # noqa: E402
from repro.distributed import sync_cost as jax_sync_cost  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import SEBS, SEBSTrainer, StageController  # noqa: E402
from repro_torch.data import DataPipeline, TokenDataset  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    CommAccountant,
    ElasticMeshPlanner,
    SyncScheduler,
    allgather_bytes_per_device,
    allreduce_bytes_per_device,
    float_state_bytes,
    span_tree_sum,
    sync_cost,
)
from repro_torch.launch.mesh import make_data_mesh  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train.state import TrainState, init_train_state  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

CFG = port_cfg()
JCFG = jax_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
JAX_RTOL = 1e-5   # the port against JAX's elastic trainer: the same tree, f32 formulas in other orders
SEBS_RTOL = 1e-4  # against the single-process trainer's serial sum


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, which the workers take from the caller: oneDNN's
    sums differ with the thread count, and the suite runs files side by side."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_budget4():
    runs = JaxBudget4()
    yield runs
    runs.close()


# -- the planner, the scheduler, the byte models, the accountant ---------------------


def _ladder(num_stages):
    return [p for p in StageController(SEBS(b1=4, C1=64, rho=2.0, num_stages=num_stages, eta=0.1),
                                       microbatch=4).stage_ladder()]


@pytest.mark.parametrize("budget,devices", [(1, 8), (2, 8), (4, 8), (8, 8), (64, 4), (None, 3)])
def test_planner_matches_jax(budget, devices):
    mine = ElasticMeshPlanner(device_budget=budget, devices=["cpu"] * devices)
    ref = JPlanner(device_budget=budget, devices=list(range(devices)))
    assert mine.device_budget == ref.device_budget
    for n in range(1, 70):
        assert mine.width_for(n) == ref.width_for(n), n
    jladder = JStageController(JSEBS(b1=4, C1=64, rho=2.0, num_stages=5, eta=0.1), microbatch=4).stage_ladder()
    for p, jp in zip(_ladder(5), jladder, strict=True):
        mp, jmp = mine.plan_for(p), ref.plan_for(jp)
        assert (mp.stage, mp.width, mp.local_accum, mp.global_accum) == (jmp.stage, jmp.width, jmp.local_accum,
                                                                          jmp.global_accum)
    with pytest.raises(ValueError):
        ElasticMeshPlanner(device_budget=0, devices=["cpu"])


def test_data_mesh_bounds():
    mesh = make_data_mesh(2, ["cpu"] * 4)
    assert mesh.width == 2 and mesh.group is None and mesh.exchange is None
    for width in (0, 5):
        with pytest.raises(ValueError):
            make_data_mesh(width, ["cpu"] * 4)


def test_sync_scheduler_and_byte_models_match_jax():
    for mode, interval, growth in (("exact", 4, 1.0), ("local", 2, 2.0), ("local", 3, 1.5), ("local", 1, 1.0)):
        mine, ref = SyncScheduler(mode, interval, growth), JSyncScheduler(mode, interval, growth)
        for stage in range(6):
            assert mine.interval(stage) == ref.interval(stage)
            for update in range(40):
                for last in range(0, update + 1, 3):
                    assert mine.due(update, last, stage) == ref.due(update, last, stage)
    for bad in (dict(mode="bogus"), dict(mode="local", local_interval=0)):
        with pytest.raises(ValueError):
            SyncScheduler(**bad)
    for payload in (0, 1, 7, 100, 10_504_192, 3_086_008_320):
        for width in (1, 2, 3, 4, 8, 16):
            assert allgather_bytes_per_device(payload, width) == jax_allgather(payload, width)
            assert allreduce_bytes_per_device(payload, width) == jax_allreduce(payload, width)
            for mode in ("exact", "local"):
                assert sync_cost(mode, width, grad_bytes=payload, state_bytes=2 * payload + 1) == jax_sync_cost(
                    mode, width, grad_bytes=payload, state_bytes=2 * payload + 1)


def test_accountant_roundtrip_matches_jax():
    mine, ref = CommAccountant(), JCommAccountant()
    for acct in (mine, ref):
        acct.record_update(0, collectives=0)
        acct.record_update(1, collectives=1, bytes_moved=64)
        acct.record_update(1)
        acct.record_reshard(1, bytes_moved=32)
        acct.record_reshard(2)
    clone = CommAccountant()
    clone.restore(json.loads(json.dumps(mine.state())))  # stage keys survive str()
    jclone = JCommAccountant()
    jclone.restore(json.loads(json.dumps(mine.state())))  # JAX reads the port's meta
    for a in (mine, clone, jclone):
        assert a.summary() == ref.summary() and a.state() == ref.state()
        assert (a.total_bytes, a.total_sync_events, a.total("updates")) == (96, 1, 3)


# -- the canonical tree -------------------------------------------------------------


@pytest.mark.parametrize("n,width", [(4, 2), (8, 4), (12, 4), (6, 2), (16, 8)])
def test_span_tree_sum_width_invariant_and_jax_equal(n, width):
    rng = np.random.default_rng(n * 100 + width)
    terms = rng.standard_normal((n, 5)).astype(np.float32) * np.float32(1e3)
    t = [torch.from_numpy(x) for x in terms]
    full = span_tree_sum(lambda i: t[i], n)
    chunk = n // width
    partials = [span_tree_sum(lambda i, d=d: t[d * chunk + i], chunk) for d in range(width)]
    combined = span_tree_sum(lambda d: partials[d], width)
    assert combined.numpy().tobytes() == full.numpy().tobytes()
    ref = jax_span_tree_sum(lambda i: jnp.asarray(terms[i]), n)
    assert full.numpy().tobytes() == np.asarray(ref).tobytes()
    serial = terms[0].copy()
    for x in terms[1:]:
        serial = serial + x
    np.testing.assert_allclose(full.numpy(), serial, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("opt_name,hp", [("psgd", {"gamma": 1e4}), ("momentum", {"beta": 0.9}),
                                         ("adagrad_da", {}), ("adamw", {})])
def test_float_state_bytes_match_jax(opt_name, hp):
    model, opt = LanguageModel(CFG), make_optimizer(opt_name, **hp)
    state = init_train_state(model, opt, seed=0, device="cpu")
    jmodel, jopt = build_model(JCFG), jax_make_optimizer(opt_name, **hp)
    jparams, _ = jmodel.init(jax.random.key(0))
    jstate = JTrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    assert float_state_bytes(state) == jax_float_state_bytes(jstate)
    from repro.utils.tree import tree_size as jax_tree_size

    from repro_torch.utils.tree import tree_size

    assert tree_size(state.params) == jax_tree_size(jparams)


def test_table_comm_records_equal_jax(tmp_path):
    from benchmarks import table_comm as jax_table

    from repro_torch.experiments import table_comm

    mine = table_comm.run(str(tmp_path / "port"), device="cpu")
    ref = jax_table.run(str(tmp_path / "jax"))
    assert [r.as_dict() for r in mine] == [r.as_dict() for r in ref]
    assert json.loads((tmp_path / "port" / "table_comm.json").read_text()) == json.loads(
        (tmp_path / "jax" / "table_comm.json").read_text())
    saving = {r.name: r.value for r in mine}["table_comm_sebs_sync_saving_vs_classical"]
    assert saving > 0


# -- the trainer at budgets 1, 2 and 4 ------------------------------------------------

_RUNS: dict = {}


def _jax_params():
    jparams, _ = build_model(JCFG).init(jax.random.key(0))
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _run(budget, **kw):
    key = (budget, repr(sorted(kw.items())))
    if key not in _RUNS:
        tr, st = port_trainer(budget, _jax_params(), **kw)
        st, log = tr.run(st, log_every=1)
        _RUNS[key] = (param_bytes(st), log, tr)
    return _RUNS[key]


def _jax_budget1():
    if "jax" not in _RUNS:
        jmodel, jopt = build_model(JCFG), jax_make_optimizer("momentum", beta=0.9)
        tr = JElasticTrainer(jmodel, jopt, JSEBS(**SCHEDULE), JPipeline(JTokenDataset(CFG.vocab_size, 8, 0)),
                             microbatch=4, grad_clip=1.0, device_budget=1)
        jparams, _ = jmodel.init(jax.random.key(0))
        _, log = tr.run(JTrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32)), log_every=1)
        _RUNS["jax"] = (log, tr)
    return _RUNS["jax"]


def test_exact_sync_bitwise_across_budgets():
    p1, l1, t1 = _run(1)
    assert l1.batch_sizes == [4] * 4 + [8] * 4 + [16] * 4 and l1.stages == [0] * 4 + [1] * 4 + [2] * 4
    assert sorted({k[1] for k in t1._steps}) == [1] and l1.comm_bytes[-1] == 0
    for budget in (2, 4):
        p, log, tr = _run(budget)
        assert log.losses == l1.losses, budget  # float equality is the contract
        assert log.stages == l1.stages and log.batch_sizes == l1.batch_sizes
        np.testing.assert_array_equal(log.noise_scales, l1.noise_scales)
        assert p == p1, budget
        assert sorted({k[1] for k in tr._steps}) == [1, 2, 4][: budget.bit_length()]
        assert log.comm_bytes == sorted(log.comm_bytes) and log.comm_bytes[-1] > 0
        stats = tr.worker_stats
        assert [s["rank"] for s in stats] == list(range(budget))
        # rank 0 all-gathers at every update of stages 1 and 2; the last rank
        # from the stage it joins at
        assert len(stats[0]["allgather"]) == 8 and len(stats[-1]["allgather"]) == (8 if budget == 2 else 4)


def test_exact_sync_matches_jax_elastic_trainer_and_sebs_trainer():
    _, l1, _ = _run(1)
    jlog, jtr = _jax_budget1()
    assert l1.stages == jlog.stages and l1.batch_sizes == jlog.batch_sizes
    np.testing.assert_allclose(l1.losses, jlog.losses, rtol=JAX_RTOL)
    # the single-process trainer sums serially: another order, so 1e-4
    model, opt = LanguageModel(CFG), make_optimizer("momentum", beta=0.9)
    base = SEBSTrainer(model, opt, SEBS(**SCHEDULE), DataPipeline(TokenDataset(CFG.vocab_size, 8, 0), "cpu"),
                       microbatch=4, mode="accumulate", accum_mode="psum_each", grad_clip=1.0)
    params = _jax_params()
    _, blog = base.run(TrainState(params, opt.init(params), 0), log_every=1)
    np.testing.assert_allclose(l1.losses, blog.losses, rtol=SEBS_RTOL)


def test_comm_ledger_equals_jax(jax_budget4):
    ref = jax_budget4.result()["exact"]
    _, l4, t4 = _run(4)
    assert l4.comm_bytes == ref["log"]["comm_bytes"] and l4.sync_events == ref["log"]["sync_events"]
    assert t4.accountant.summary() == ref["summary"]
    np.testing.assert_allclose(l4.losses, ref["log"]["losses"], rtol=JAX_RTOL)
    _, l2, t2 = _run(2)
    jlog, jtr = _jax_budget1()
    assert t2.accountant.summary()["0"] == jtr.accountant.summary()["0"]  # width 1 moves nothing in either


# -- local SGD ------------------------------------------------------------------------


def test_local_sgd_saves_snap_and_ledger_equals_jax(jax_budget4, tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    tr, st = port_trainer(4, _jax_params(), sync_mode="local", local_interval=2)
    with CheckpointManager(str(tmp_path), keep_last=10) as ck:
        st, log = tr.run(st, log_every=1, checkpointer=ck, save_every=3)
    saves = sorted(int(d.split("_")[1]) for d in (p.name for p in tmp_path.iterdir()) if d.startswith("step_"))
    ref = jax_budget4.result()["local"]
    # the update-9 save (stage 2, mid-drift) snapped to the average at 10; the
    # final state at 12 reached disk though 12 is not a multiple of 3
    assert saves == ref["saves"] == [3, 6, 10, 12]
    assert finite(log.losses)
    np.testing.assert_allclose(log.losses, ref["log"]["losses"], rtol=JAX_RTOL)
    assert tr.accountant.summary() == ref["summary"]
    assert log.comm_bytes == ref["log"]["comm_bytes"] and log.sync_events == ref["log"]["sync_events"]
    assert tr.accountant.total("collectives") < tr.accountant.total("updates")
    assert tr._stacked is False  # finalize collapsed the replicas
    assert [t.shape for t in tree_leaves(st.params)] == [t.shape for t in tree_leaves(_jax_params())]
    # the GNS is starved while replicas drift (and stage 0, at accum 1, feeds it nothing)
    assert np.all(np.isnan(log.noise_scales)) and np.all(np.isnan(ref["log"]["noise_scales"]))


def test_local_sgd_every_update_is_exact_sync_with_plain_sgd():
    """With an average after every update and plain SGD (no clip), the mean
    of the replicas' updates is the update with the mean gradient, up to
    rounding."""
    sgd = ("sgd", {})
    p_exact, l_exact, _ = _run(4, optimizer=sgd, grad_clip=0.0)
    p_local, l_local, t_local = _run(4, optimizer=sgd, grad_clip=0.0, sync_mode="local", local_interval=1)
    np.testing.assert_allclose(l_local.losses, l_exact.losses, rtol=1e-6)
    for a, b in zip(p_local, p_exact, strict=True):
        np.testing.assert_allclose(np.frombuffer(a, np.float32), np.frombuffer(b, np.float32), rtol=1e-6, atol=1e-6)
    assert t_local.accountant.total("sync_events") == 8  # every update of stages 1 and 2


def test_param_axes_names_the_sharding_slice():
    """``param_axes`` are taken now (the sharding slice): exact sync shards
    the replicas' storage by the rules (``tests/test_torch_mesh_train.py``
    runs it), local SGD keeps whole replicas, as the JAX trainer does."""
    axes = LanguageModel(CFG).param_axes()
    tr, _ = port_trainer(2, param_axes=axes)
    assert tr._sharded and tr.param_axes == axes
    tr, _ = port_trainer(2, param_axes=axes, sync_mode="local")
    assert not tr._sharded
