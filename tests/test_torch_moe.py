"""The port's MoE family against the JAX package's, on dbrx-132b and
arctic-480b smoke in float32 on the CPU, with the JAX parameters carried
over by ``repro_torch.bridge``: the MoE layer's routing (the dispatch and
combine tensors, capacity drops, ties under a zero router, two groups of
1,024 at S 2048), its output and aux loss, the model's logits, loss, aux
and gradients (the router's and arctic's residual MLP's included) through
the remat'd blocks, a short SEBS run with pSGD, checkpoints written by
either package and resumed by the other, the greedy tokens of the paged,
static and continuous engines, and both launchers with each MoE arch.

Tolerances (f32, the same formulas summed in other orders): the dispatch
tensors exactly (computed by each package from its own router
probabilities), the combine tensors exactly from the same probabilities
(1e-5 relative from each package's own);
the layer's output 1e-5 and its aux loss 1e-6 relative; logits and losses
1e-4; gradients 1e-4 of each leaf's norm; greedy tokens and engine stats
exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_engine_cases import CASES, run_engine_case  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import SEBS as JSEBS  # noqa: E402
from repro.core import SEBSTrainer as JTrainer  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.data import TokenDataset as JTokenDataset  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxContinuous  # noqa: E402
from repro.serve import PagedContinuousBatchingEngine as JaxPaged  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro.train.loss import lm_loss as jax_lm_loss  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro.train.step import _grads_over_microbatches as jax_grads  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SEBS, SEBSTrainer  # noqa: E402
from repro_torch.data import DataPipeline, TokenDataset  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine, PagedContinuousBatchingEngine, ServeEngine  # noqa: E402
from repro_torch.train.loss import lm_loss  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import _grads_over_microbatches  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

TOL = 1e-4
ARCHS = ("dbrx-132b", "arctic-480b")
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, where torch's default of one thread a core oversubscribes
    the host."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _spread(tree, seed=0):
    """Non-default norm scales, so that the test sees them."""
    rng = np.random.default_rng(seed)
    for block in tree["seg0"].values():
        for n in ("norm1", "norm2"):
            block[n]["scale"] = (0.1 * rng.standard_normal(block[n]["scale"].shape)).astype(np.float32)
    return tree


def _models(arch):
    """(jax model, jax params, port model, port params, numpy tree), made once."""
    if arch not in _MODELS:
        jcfg = jax_config(arch, "smoke").replace(compute_dtype="float32")
        tcfg = get_config(arch, "smoke").replace(compute_dtype="float32")
        jmodel = build_model(jcfg)
        tree = _spread(jax.tree.map(np.asarray, jmodel.init(jax.random.key(0))[0]))
        _MODELS[arch] = (jmodel, jax.tree.map(jnp.asarray, tree), LanguageModel(tcfg),
                         bridge.params_from_numpy(tree, tcfg, device="cpu"), tree)
    return _MODELS[arch]


def _close(out, expect, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(expect, np.float32),
                               atol=tol, rtol=tol)


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s)).astype(np.int32)


def _shapes(tree, path=""):
    """{path: (shape, dtype)} of every leaf."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items() for k, v in _shapes(sub, f"{path}/{name}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _shapes(sub, f"{path}/{i}").items()}
    return {path: (tuple(tree.shape), tree.dtype)}


def _layer(arch):
    """The first layer's MoE params: numpy (JAX) and the port's tensors."""
    _, _, _, tparams, tree = _models(arch)
    return (jax.tree.map(lambda a: a[0], tree["seg0"]["b0"]["moe"]), tparams["seg0"]["b0"][0]["moe"])


def _probs(x, router, gs):
    """Each package's router probabilities of ``x`` (B, S, d) in groups of ``gs``."""
    b, s, d = x.shape
    xg = x.reshape(b, s // gs, gs, d)
    jp = jax.nn.softmax(jnp.einsum("bngd,de->bnge", jnp.asarray(xg), jnp.asarray(router)), axis=-1)
    tp = torch.softmax(torch.einsum("bngd,de->bnge", torch.from_numpy(xg), torch.from_numpy(router.copy())),
                       dim=-1)
    return np.asarray(jp), tp


@pytest.mark.parametrize("arch,s", [("dbrx-132b", 33), ("arctic-480b", 33), ("dbrx-132b", 2048)])
def test_moe_layer_matches_jax(arch, s):
    """Routing exact, the output within 1e-5 and aux within 1e-6 relative;
    at S 2048 the tokens form two groups of 1,024, each with its own
    capacity buffers."""
    jmodel, _, tmodel, _, _ = _models(arch)
    cfg = tmodel.cfg
    jlayer, tlayer = _layer(arch)
    x = np.random.default_rng(2).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    gs = min(moe.GROUP_SIZE, s)
    capacity = moe.capacity_of(cfg, gs)
    assert capacity == max(1, -(-cfg.top_k * gs * 5 // (cfg.num_experts * 4)))  # ceil(k gs / E x 1.25)
    jprobs, tprobs = _probs(x, jlayer["router"], gs)
    jdisp, jcomb = jmoe._dispatch_tensors(jnp.asarray(jprobs), cfg.top_k, capacity)
    tdisp, tcomb = moe.dispatch_tensors(tprobs, cfg.top_k, capacity)
    assert tdisp.shape == (2, s // gs, gs, cfg.num_experts, capacity)
    np.testing.assert_array_equal(tdisp.numpy(), np.asarray(jdisp))
    # each package's own probabilities agree within a few f32 ulps
    np.testing.assert_allclose(tcomb.numpy(), np.asarray(jcomb), rtol=1e-5, atol=1e-7)
    # from the same probabilities, combine is exact
    _, tcomb_same = moe.dispatch_tensors(torch.from_numpy(jprobs.copy()), cfg.top_k, capacity)
    np.testing.assert_array_equal(tcomb_same.numpy(), np.asarray(jcomb))
    jy, jaux = jmoe.apply(jlayer, jnp.asarray(x), jmodel.cfg)
    with torch.no_grad():
        ty, taux = moe.apply(tlayer, torch.from_numpy(x), cfg)
    _close(ty, jy, 1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_capacity_drops_match_jax():
    """Capacity 3 for 16 tokens of top-2 over 4 experts: some assignments
    find their expert's buffer full, and the same ones as in JAX."""
    _, _, tmodel, _, _ = _models("dbrx-132b")
    cfg = tmodel.cfg
    jlayer, _ = _layer("dbrx-132b")
    x = np.random.default_rng(5).standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    jprobs, tprobs = _probs(x, jlayer["router"], 16)
    jdisp, _ = jmoe._dispatch_tensors(jnp.asarray(jprobs), cfg.top_k, 3)
    tdisp, _ = moe.dispatch_tensors(tprobs, cfg.top_k, 3)
    np.testing.assert_array_equal(tdisp.numpy(), np.asarray(jdisp))
    dropped = 3 * 16 * cfg.top_k - int(tdisp.sum())
    assert dropped == 3 * 16 * cfg.top_k - int(np.asarray(jdisp).sum()) > 0
    assert (tdisp.sum((-3, -1)) <= 3).all()  # no expert holds more than its capacity
    assert (tdisp.sum(-3) <= 1).all()  # one token a slot


def test_zero_router_ties_keep_jax_order():
    """A zero router gives every expert the same probability: the lower
    expert index wins each tie, as ``jax.lax.top_k`` orders them, and the
    slot-major buffer order fills experts 0 and 1 only."""
    _, _, tmodel, _, _ = _models("dbrx-132b")
    cfg = tmodel.cfg
    zero = {"router": torch.zeros_like(_layer("dbrx-132b")[1]["router"]), **{
        k: v for k, v in _layer("dbrx-132b")[1].items() if k != "router"}}
    jzero = {k: np.asarray(v) for k, v in zero.items()}
    x = np.random.default_rng(6).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    probs = np.full((2, 1, 12, cfg.num_experts), 1 / cfg.num_experts, np.float32)
    capacity = moe.capacity_of(cfg, 12)
    jdisp, jcomb = jmoe._dispatch_tensors(jnp.asarray(probs), cfg.top_k, capacity)
    tdisp, tcomb = moe.dispatch_tensors(torch.from_numpy(probs), cfg.top_k, capacity)
    np.testing.assert_array_equal(tdisp.numpy(), np.asarray(jdisp))
    np.testing.assert_array_equal(tcomb.numpy(), np.asarray(jcomb))
    assert tdisp[..., 2:, :].sum() == 0 and tdisp[..., :2, :].sum() == 2 * capacity * 2
    jy, jaux = jmoe.apply(jzero, jnp.asarray(x), _models("dbrx-132b")[0].cfg)
    with torch.no_grad():
        ty, taux = moe.apply(zero, torch.from_numpy(x), cfg)
    _close(ty, jy, 1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_bridge_carries_the_moe_tree():
    for arch in ARCHS:
        _, _, tmodel, tparams, tree = _models(arch)
        layer = tparams["seg0"]["b0"][0]
        expect = {"norm1", "attn", "norm2", "moe"} | ({"mlp"} if arch.startswith("arctic") else set())
        assert set(layer) == expect
        assert set(layer["moe"]) == {"router", "w_gate", "w_up", "w_down"}
        np.testing.assert_array_equal(layer["moe"]["w_down"], tree["seg0"]["b0"]["moe"]["w_down"][0])
        init = LanguageModel(tmodel.cfg).init(0, device="cpu")
        assert _shapes(init) == _shapes(tparams)
        back = bridge.params_to_numpy(tparams, tmodel.cfg)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)
    bf16 = LanguageModel(get_config("dbrx-132b", "smoke").replace(param_dtype="bfloat16")).init(0, device="cpu")
    layer = bf16["seg0"]["b0"][0]["moe"]
    assert layer["router"].dtype == torch.float32 and layer["w_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_aux_match_jax(arch):
    jmodel, jparams, tmodel, tparams, _ = _models(arch)
    tokens = _tokens(2, 33)
    jlogits, jaux = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    jtotal, jm = jax.jit(lambda p, b: jax_lm_loss(jmodel, p, b, z_loss=1e-4))(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tlogits, taux = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
        total, tm = lm_loss(tmodel, tparams, {"tokens": torch.from_numpy(tokens)}, z_loss=1e-4)
    _close(tlogits, jlogits)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-6)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=TOL)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_grads_match_jax(arch):
    """Gradients per leaf (1e-4 of the leaf's norm) over two microbatches
    through the remat'd blocks: the router's through the aux loss and the
    combine weights, the experts', arctic's residual MLP's; the aux metric
    averaged over the microbatches."""
    jmodel, jparams, tmodel, tparams, _ = _models(arch)
    batch = _tokens(4, 17, seed=3).reshape(2, 2, 17)
    jg, jm = jax.jit(lambda p, b: jax_grads(jmodel, p, b, 2, 0.0))(jparams, {"tokens": jnp.asarray(batch)})
    leaves = [w.detach().clone().requires_grad_(True) for w in tree_leaves(tparams)]
    params = _rebuild(tparams, iter(leaves))
    tg, tm = _grads_over_microbatches(tmodel, params, {"tokens": torch.from_numpy(batch)}, 2, 0.0)
    expect = bridge.params_from_numpy(jax.tree.map(np.asarray, jg), tmodel.cfg, device="cpu")
    layer = expect["seg0"]["b0"][0]
    assert torch.linalg.vector_norm(layer["moe"]["router"]) > 0
    if arch.startswith("arctic"):
        assert torch.linalg.vector_norm(layer["mlp"]["w_down"]) > 0
    expect = tree_leaves(expect)
    assert len(tg) == len(expect) == len(leaves)
    for got, e in zip(tg, expect):
        assert got.shape == e.shape
        assert torch.linalg.vector_norm(got - e) <= TOL * torch.linalg.vector_norm(e) + 1e-9
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_sq_small"]), float(jm["grad_sq_small"]), rtol=TOL)


def _sebs(pkg):
    return pkg(b1=4, C1=8, rho=2.0, num_stages=2, eta=0.3)  # batches 4, 4, 8, 8


def _jax_trainer():
    jmodel, _, _, _, tree = _models("dbrx-132b")
    jparams = jax.tree.map(jnp.asarray, tree)  # fresh buffers: the trainer donates them
    jopt = jax_make_optimizer("psgd", gamma=1e4)
    trainer = JTrainer(jmodel, jopt, _sebs(JSEBS), JPipeline(JTokenDataset(512, 16, 0)),
                       microbatch=4, mode="accumulate", accum_mode="psum_each")
    return trainer, JTrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))


def _port_trainer():
    _, _, tmodel, _, tree = _models("dbrx-132b")
    params = bridge.params_from_numpy(tree, tmodel.cfg, device="cpu")  # a fresh copy: updates in place
    opt = make_optimizer("psgd", gamma=1e4)
    trainer = SEBSTrainer(tmodel, opt, _sebs(SEBS), DataPipeline(TokenDataset(512, 16, 0), "cpu"),
                          microbatch=4, mode="accumulate", accum_mode="psum_each")
    return trainer, TrainState(params, opt.init(params), 0)


_JAX_LOG: list = []


def _jax_log():
    if not _JAX_LOG:
        trainer, state = _jax_trainer()
        _JAX_LOG.append(trainer.run(state, log_every=1)[1])
    return _JAX_LOG[0]


def test_sebs_run_matches_jax():
    """Four SEBS updates of dbrx smoke with pSGD (batches 4, 4, 8, 8 of 16
    tokens): the losses carry the router loss at weight 0.01."""
    jlog = _jax_log()
    trainer, state = _port_trainer()
    _, tlog = trainer.run(state, log_every=1)
    assert tlog.batch_sizes == jlog.batch_sizes == [4, 4, 8, 8] and tlog.stages == jlog.stages
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=TOL)
    assert all(np.isfinite(tlog.losses))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_the_packages(writer, tmp_path):
    """A checkpoint after update 2 written by one package, resumed by the
    other: the router, the expert tensors and pSGD's anchor cross both ways,
    and the resumed losses stay within 1e-4 relative of JAX's uninterrupted
    run."""
    jlog = _jax_log()
    if writer == "jax":
        trainer, state = _jax_trainer()
        with JCheckpointManager(str(tmp_path)) as ckpt:
            trainer.run(state, log_every=1, checkpointer=ckpt, save_every=2, stop_after_updates=2)
        trainer, state = _port_trainer()
        with CheckpointManager(str(tmp_path)) as ckpt:
            _, log = trainer.run(state, log_every=1, checkpointer=ckpt, save_every=2, resume=True)
    else:
        trainer, state = _port_trainer()
        with CheckpointManager(str(tmp_path)) as ckpt:
            trainer.run(state, log_every=1, checkpointer=ckpt, save_every=2, stop_after_updates=2)
        trainer, state = _jax_trainer()
        with JCheckpointManager(str(tmp_path)) as ckpt:
            _, log = trainer.run(state, log_every=1, checkpointer=ckpt, save_every=2, resume=True)
    assert log.stages == jlog.stages and log.batch_sizes == jlog.batch_sizes
    np.testing.assert_allclose(log.losses, jlog.losses, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_greedy_matches_jax(arch):
    """Prompts sharing a prefix through two slots with 4-token chunks (a
    chunk is one routing group of capacity 3; a prompt's tail rides the
    decode ticks, one token a group of capacity 1): prefix sharing stays on
    for MoE, and the tokens, stats and memory accounting equal JAX's."""
    jmodel, jparams, tmodel, tparams, _ = _models(arch)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 512, 8)
    prompts = [np.concatenate([prefix, rng.integers(0, 512, 3 + i)]).astype(np.int32) for i in range(3)]
    kw = dict(cache_len=64, max_slots=2, page_size=4, prefill_chunks=(4,))
    runs = []
    for engine in (JaxPaged(jmodel, jparams, kernel="xla", seed=0, **kw),
                   PagedContinuousBatchingEngine(tmodel, tparams, seed=0, device="cpu", **kw)):
        ids = [engine.submit(p, max_new_tokens=5) for p in prompts]
        out = engine.run()
        engine.pool.check()
        runs.append(([out[i] for i in ids], engine))
    (expect, jax_engine), (got, engine) = runs
    for i, (a, b) in enumerate(zip(expect, got)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
    for key in ("prefix_tokens_reused", "prefill_chunks", "ticks", "decoded_tokens",
                "prefill_tokens_computed", "peak_width"):
        assert engine.stats[key] == jax_engine.stats[key], key
    assert engine.prefix_sharing and engine.stats["prefix_tokens_reused"] > 0
    assert engine.memory_stats() == jax_engine.memory_stats()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_cases_match_jax(arch, case):
    """Pool pressure with requeue, and a one-page pool with a one-token
    prompt and one new token (tests/_torch_engine_cases.py): a decoded
    token is a routing group of its own."""
    jmodel, jparams, tmodel, tparams, _ = _models(arch)
    run_engine_case(case, JaxPaged, PagedContinuousBatchingEngine, jmodel, jparams, tmodel, tparams,
                    vocab=tmodel.cfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_engines_greedy_match_jax(arch):
    """The static batch (one prefill of 4 x 6: a group of 6 a row) and the
    continuous ring (batch-1 prefills, per-slot decode depths)."""
    jmodel, jparams, tmodel, tparams, _ = _models(arch)
    prompts = _tokens(4, 6, seed=7)
    static = JaxServe(jmodel, jparams, cache_len=64).generate(prompts, max_new_tokens=6)
    got = ServeEngine(tmodel, tparams, cache_len=64, device="cpu").generate(prompts, max_new_tokens=6)
    np.testing.assert_array_equal(got, static)
    streams = []
    for engine in (JaxContinuous(jmodel, jparams, cache_len=64, max_slots=2),
                   ContinuousBatchingEngine(tmodel, tparams, cache_len=64, max_slots=2, device="cpu")):
        ids = [engine.submit(p, max_new_tokens=6) for p in prompts]
        out = engine.run()
        streams.append(np.stack([out[i] for i in ids]))
    np.testing.assert_array_equal(streams[1], streams[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_take_moe(arch):
    results = serve_launcher.main(["--engine", "paged", "--device", "cpu", "--arch", arch,
                                   "--requests", "2", "--prompt-len", "9", "--shared-prefix", "4",
                                   "--new-tokens", "3", "--cache-len", "32", "--chunk", "4",
                                   "--page-size", "4"])
    assert all(len(row) == 9 + 3 for row in results.values())
    for engine in ("static", "continuous"):
        results = serve_launcher.main(["--engine", engine, "--device", "cpu", "--arch", arch,
                                       "--prompt-len", "5", "--new-tokens", "2", "--cache-len", "16"])
        assert all(len(row) == 5 + 2 for row in results.values())
    log = train_launcher.main(["--device", "cpu", "--arch", arch, "--b1", "2", "--c1", "2",
                               "--rho", "2", "--stages", "2", "--seq", "8", "--steps-log", "1"])
    assert log.batch_sizes == [2, 4] and all(np.isfinite(log.losses))
