"""Several mesh runs in one spawn of the workers
(``repro_torch/distributed/trainer.py``'s ``run_together`` and
``run_all_on_mesh``), on the CPU: each run gives the bits it gives alone.

One spawn of four gloo workers on (2, 2) runs qwen2.5-3b smoke (storage
sharded, the state passed in), dbrx-132b smoke (its experts over the model
groups) and qwen2.5-3b smoke with tensor parallelism (its state built from a
seed on rank 0); each run's losses, noise-scale log and final params are
bit-identical to the same run made alone, and each keeps its own worker
statistics. Runs on different workers are refused.

~40 s on one worker (four spawns of four gloo workers).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SEBS, SEBSTrainer  # noqa: E402
from repro_torch.data import DataPipeline, TokenDataset  # noqa: E402
from repro_torch.distributed import run_all_on_mesh, run_on_mesh  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import TrainState  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

CASES = [("qwen2.5-3b", False, False), ("dbrx-132b", False, False), ("qwen2.5-3b", True, True)]


def _run(arch: str, tp: bool, seeded: bool, mesh):
    """(trainer, state or None, run keywords) of one case."""
    cfg = get_config(arch, "smoke").replace(compute_dtype="float32")
    model = LanguageModel(cfg)
    opt = make_optimizer("momentum", beta=0.9)
    trainer = SEBSTrainer(model, opt, SEBS(b1=4, C1=8, rho=2.0, num_stages=2, eta=0.5),
                          DataPipeline(TokenDataset(cfg.vocab_size, 8, 0), mesh), mesh=mesh,
                          param_axes=model.param_axes(), microbatch=2, deadline=300.0, tensor_parallel=tp)
    if seeded:
        return trainer, None, {"init_seed": 0, "log_every": 1}
    params = model.init(0, device="cpu")
    return trainer, TrainState(params, opt.init(params), 0), {"log_every": 1}


@pytest.fixture(scope="module")
def runs():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
        together = [_run(*case, mesh) for case in CASES]
        got = run_all_on_mesh(together)
        alone = [_run(*case, mesh) for case in CASES]
        want = [run_on_mesh(trainer, state, **kw) for trainer, state, kw in alone]
    finally:
        torch.set_num_threads(old)
    return together, got, alone, want


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{a}{'-tp' if tp else ''}" for a, tp, _ in CASES])
def test_each_run_gives_its_bits_alone(runs, case):
    together, got, alone, want = runs
    (state, log), (ref_state, ref) = got[case], want[case]
    assert log.losses == ref.losses and len(log.losses) == 4
    assert log.stages == ref.stages and log.batch_sizes == ref.batch_sizes
    assert repr(log.noise_scales) == repr(ref.noise_scales)
    if CASES[case][2]:  # the state stayed with the workers
        assert all(t.device.type == "meta" for t in tree_leaves(state.params))
    else:
        for a, b in zip(tree_leaves(state.params), tree_leaves(ref_state.params), strict=True):
            assert torch.equal(a, b)
    stats, ref_stats = together[case][0].worker_stats, alone[case][0].worker_stats
    assert len(stats) == 4
    for a, b in zip(stats, ref_stats, strict=True):
        assert a["steps"] == b["steps"] and len(a["sharded"]) == len(b["sharded"]) == 4
        assert [u["exchange"]["received_bytes"] for u in a["sharded"]] == \
            [u["exchange"]["received_bytes"] for u in b["sharded"]]


def test_runs_on_other_workers_are_refused():
    a = _run("qwen2.5-3b", False, False, make_host_mesh(2, 2, devices=["cpu"] * 4))
    b = _run("qwen2.5-3b", False, False, make_host_mesh(1, 2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="the same workers"):
        run_all_on_mesh([a, b])
