"""The MoE experts computed over the mesh's ``model`` groups
(``repro_torch/distributed/sharded.py``), on the CPU:

- gloo workers on (1, 2) and (2, 2) host meshes run dbrx-132b and
  arctic-480b smoke (f32) through the sharded step with their axis groups,
  and hold the unsharded run (the elastic step on one worker over the same
  microbatches) over 3 updates: every metric within 1e-6 relative, every
  param leaf within 1e-5 of its norm; whether the bits matched is printed.
  The two hard cases: fewer computing ranks than ranks (a model group
  whose second rank has no rows), and a group whose computing rank takes
  3 microbatches beside a rank that takes none (the other group replays);
- the layer alone (its experts gathered over the expert group, computed
  over the model group) against the JAX package's ``moe.apply`` on the
  same numpy inputs: the routing exactly, the output within 1e-5;
- the all-to-all over a model group and the gather over an expert group,
  through the host slots and through the device exchange's code (gloo),
  give the bytes of a plain exchange;
- qwen2.5-3b smoke on (2, 2) with the axis groups stays bit-identical;
- a run on a mesh from an init seed (the state built on rank 0, kept on
  the workers) equals a run from the same state.

About 60 s on one worker.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _torch_expert_cases import expert_layer_worker, expert_parallel_worker, to_all_worker  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402

METRIC_RTOL = 1e-6
LEAF_TOL = 1e-5


def _spawn(fn, world, *args):
    torch.multiprocessing.spawn(fn, args=(world,) + args, nprocs=world, join=True)


def _results(tmp_path, world):
    return [json.loads((tmp_path / f"result_{r}").read_text()) for r in range(world)]


def _check_run(tmp_path, world, label):
    bits = True
    for r, res in enumerate(_results(tmp_path, world)):
        for got, want in zip(res["got"], res["want"], strict=True):
            for k in want:
                assert abs(got[k] - want[k]) <= METRIC_RTOL * abs(want[k]), (label, r, k, got[k], want[k])
        for leaf in res["leaves"]:
            assert leaf["diff"] <= LEAF_TOL * leaf["norm"], (label, r, leaf)
        bits = bits and all(leaf["equal"] for leaf in res["leaves"]) and res["got"] == res["want"]
    print(f"{label}: bit-identical to the unsharded run: {bits}")
    return bits


@pytest.mark.parametrize("arch,shape,width,device_exchange", [
    ("dbrx-132b", (1, 2), 2, False), ("dbrx-132b", (2, 2), 4, False),
    ("arctic-480b", (1, 2), 2, True), ("arctic-480b", (2, 2), 4, True)])
def test_expert_parallel_run_holds_the_unsharded_run(tmp_path, arch, shape, width, device_exchange):
    world = shape[0] * shape[1]
    _spawn(expert_parallel_worker, world, str(tmp_path), arch, shape, width, 1, device_exchange)
    _check_run(tmp_path, world, f"{arch} {shape}")


@pytest.mark.parametrize("arch,shape,width,local_accum", [("dbrx-132b", (1, 2), 1, 1), ("arctic-480b", (2, 2), 1, 3)])
def test_ranks_without_rows_join_their_groups_exchanges(tmp_path, arch, shape, width, local_accum):
    """(1, 2) at width 1: rank 1 has no rows but holds half the experts, so
    it runs its experts on rank 0's tokens; (2, 2) at width 1 and 3
    microbatches: rank 1 joins rank 0's three microbatches of all-to-alls,
    ranks 2-3 (a group without rows) replay their gathers."""
    world = shape[0] * shape[1]
    _spawn(expert_parallel_worker, world, str(tmp_path), arch, shape, width, local_accum, False)
    _check_run(tmp_path, world, f"{arch} {shape} width {width} x {local_accum}")


def test_dense_model_on_a_mesh_with_axis_groups_stays_bit_identical(tmp_path):
    _spawn(expert_parallel_worker, 4, str(tmp_path), "qwen2.5-3b", (2, 2), 2, 2, False)
    assert _check_run(tmp_path, 4, "qwen2.5-3b (2, 2)")


@pytest.mark.parametrize("arch,shape,device_exchange", [("dbrx-132b", (2, 2), False), ("arctic-480b", (1, 2), True)])
def test_split_layer_matches_jax(tmp_path, arch, shape, device_exchange):
    cfg = get_config(arch, "smoke").replace(compute_dtype="float32")
    world = shape[0] * shape[1]
    rng = np.random.default_rng(3)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    layer = {"router": rng.standard_normal((d, e)).astype(np.float32) * d**-0.5,
             "w_gate": rng.standard_normal((e, d, f)).astype(np.float32) * d**-0.5,
             "w_up": rng.standard_normal((e, d, f)).astype(np.float32) * d**-0.5,
             "w_down": rng.standard_normal((e, f, d)).astype(np.float32) * f**-0.5}
    x = rng.standard_normal((world, 40, d)).astype(np.float32)
    np.savez(tmp_path / "layer.npz", x=x, **layer)
    _spawn(expert_layer_worker, world, str(tmp_path), arch, shape, device_exchange)
    jcfg = jax_config(arch, "smoke").replace(compute_dtype="float32")
    jlayer = {k: jnp.asarray(v) for k, v in layer.items()}
    capacity = moe.capacity_of(cfg, 40)
    for r in range(world):
        got = np.load(tmp_path / f"layer_{r}.npz")
        assert bool(got["split"]) and int(got["experts"]) == e // shape[1]
        xr = jnp.asarray(x[r:r + 1])
        jprobs = jax.nn.softmax(jnp.einsum("bngd,de->bnge", xr.reshape(1, 1, 40, d), jlayer["router"]), axis=-1)
        jdisp, _ = jmoe._dispatch_tensors(jprobs, cfg.top_k, capacity)
        np.testing.assert_array_equal(got["disp"], np.asarray(jdisp))
        jy, jaux = jmoe.apply(jlayer, xr, jcfg)
        np.testing.assert_allclose(got["y"], np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(got["aux"]), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("device_exchange", [False, True])
def test_group_exchanges_give_a_plain_exchanges_bytes(tmp_path, device_exchange):
    _spawn(to_all_worker, 4, str(tmp_path), device_exchange)
    for r, res in enumerate(_results(tmp_path, 4)):
        assert res.pop("gather_equal")
        members = [2 * (r // 2), 2 * (r // 2) + 1]  # rank r's model group on (2, 2)
        me = members.index(r)
        for name, blocks in res.items():
            dtype = getattr(torch, name.split(".")[1])
            want = {str(p): (torch.arange(6, dtype=torch.float32).reshape(2, 3) + 100 * q + 10 * me)
                    .to(dtype).float().tolist() for p, q in enumerate(members)}
            assert blocks == want


def test_sebs_trainer_on_a_mesh_computes_experts_over_model_groups():
    """``SEBSTrainer(mesh=(2, 2))`` on dbrx-132b smoke (f32, momentum, SEBS
    b1 4, C1 16, rho 2, 3 stages, microbatch 2: widths 2 and 4, the first
    with a model group without rows) against the same schedule in one
    process: every loss within 1e-6 relative, every param within 1e-5 of
    its leaf's norm, the ladder the same."""
    from repro_torch.core import SEBS, SEBSTrainer
    from repro_torch.data import DataPipeline, TokenDataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.train.state import TrainState
    from repro_torch.utils.tree import tree_leaves

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_config("dbrx-132b", "smoke").replace(compute_dtype="float32")
        model = LanguageModel(cfg)
        runs = {}
        for mesh in (None, make_host_mesh(2, 2, devices=["cpu"] * 4)):
            opt = make_optimizer("momentum", beta=0.9)
            pipe = DataPipeline(TokenDataset(cfg.vocab_size, 8, 0), "cpu" if mesh is None else mesh)
            kw = {"mesh": mesh, "param_axes": model.param_axes(), "deadline": 300.0} if mesh is not None else {}
            trainer = SEBSTrainer(model, opt, SEBS(b1=4, C1=16, rho=2.0, num_stages=3, eta=0.5), pipe,
                                  microbatch=2, grad_clip=1.0, **kw)
            params = model.init(0, device="cpu")
            state, log = trainer.run(TrainState(params, opt.init(params), 0), log_every=1)
            runs[mesh is not None] = (log, tree_leaves(state.params))
    finally:
        torch.set_num_threads(old)
    (ref, ref_params), (log, params) = runs[False], runs[True]
    assert log.stages == ref.stages and log.batch_sizes == ref.batch_sizes
    for a, b in zip(log.losses, ref.losses, strict=True):
        assert abs(a - b) <= METRIC_RTOL * abs(b), (log.losses, ref.losses)
    for a, b in zip(params, ref_params, strict=True):
        assert float((a - b).detach().abs().max()) <= LEAF_TOL * float(b.detach().norm())
    print(f"SEBSTrainer (2, 2) dbrx smoke: bit-identical losses: {log.losses == ref.losses}")



def test_run_on_mesh_from_an_init_seed_keeps_the_state_on_the_workers():
    """``run_on_mesh(trainer, None, init_seed=0)``: rank 0 builds the state
    from the seed on its own device, and the state stays with the workers.
    qwen2.5-3b smoke (f32) on (1, 2): the losses bit-identical to the same
    run handed ``model.init(0)``; the returned params are meta tensors of
    the params' shapes; a state and a seed together are refused."""
    from repro_torch.core import SEBS, SEBSTrainer
    from repro_torch.data import DataPipeline, TokenDataset
    from repro_torch.distributed import run_on_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LanguageModel
    from repro_torch.optim import make_optimizer
    from repro_torch.train.state import TrainState
    from repro_torch.utils.tree import tree_leaves

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = LanguageModel(get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32"))
        mesh = make_host_mesh(1, 2, devices=["cpu"] * 2)
        runs = []
        for seeded in (False, True):
            opt = make_optimizer("psgd", gamma=1e4)
            trainer = SEBSTrainer(model, opt, SEBS(b1=4, C1=8, rho=2.0, num_stages=1, eta=0.5),
                                  DataPipeline(TokenDataset(model.cfg.vocab_size, 8, 0), mesh), microbatch=2,
                                  mesh=mesh, param_axes=model.param_axes(), deadline=300.0)
            params = model.init(0, device="cpu")
            state = TrainState(params, opt.init(params), 0)
            if seeded:
                with pytest.raises(ValueError, match="either a state or an init_seed"):
                    run_on_mesh(trainer, state, init_seed=0)
                runs.append(run_on_mesh(trainer, None, init_seed=0, log_every=1))
            else:
                runs.append(run_on_mesh(trainer, state, log_every=1))
    finally:
        torch.set_num_threads(old)
    (_, log), (state, seeded_log) = runs
    assert len(log.losses) == 2 and seeded_log.losses == log.losses
    got, want = tree_leaves(state.params), tree_leaves(model.init(0, device="meta"))
    assert all(a.device.type == "meta" and a.shape == b.shape for a, b in zip(got, want, strict=True))

def _unsharded_greedy(model, params, tokens, rows, new):
    """The single-process engine's calls (``model.prefill``, ``decode_step``)
    on each rank's rows, greedy: the same shapes the workers compute."""
    out = []
    with torch.no_grad():
        for r0 in range(0, tokens.shape[0], rows):
            cache = model.init_cache(rows, tokens.shape[1] + new, dtype=torch.float32, device="cpu")
            logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens[r0:r0 + rows])}, cache)
            steps = [logits]
            for t in range(new - 1):
                nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
                index = torch.full((rows,), tokens.shape[1] + t, dtype=torch.int32)
                logits, cache = model.decode_step(params, nxt, cache, index)
                steps.append(logits)
            out.append(steps)
    return [torch.cat([s[i] for s in out]) for i in range(new)]


@pytest.mark.parametrize("arch,shape,batch", [("qwen2.5-3b", (2, 2), 4), ("dbrx-132b", (2, 2), 4),
                                              ("arctic-480b", (1, 2), 1)])
def test_sharded_serving_forward_holds_the_unsharded_engine(arch, shape, batch):
    """Prefill and 3 greedy decode steps on a mesh, each layer gathered where
    it runs: dense logits bit-identical to the single-process engine's calls
    on the same rows; MoE (experts over the model groups, arctic's (1, 2)
    with one row: a rank without rows runs its experts) within 1e-5 of the
    logits' scale."""
    from repro_torch.distributed.mesh_serve import serve_on_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LanguageModel

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_config(arch, "smoke").replace(compute_dtype="float32")
        model = LanguageModel(cfg)
        params = model.init(0, device="cpu")
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, 12)).astype(np.int32)
        world = shape[0] * shape[1]
        got, = serve_on_mesh(make_host_mesh(*shape, devices=["cpu"] * world), [(model, params, tokens)], 4)
        want = _unsharded_greedy(model, params, tokens, max(1, batch // world), 4)
    finally:
        torch.set_num_threads(old)
    for a, b in zip(got, want, strict=True):
        if arch == "qwen2.5-3b":
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
