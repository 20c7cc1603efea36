"""The port's zamba2 path against the JAX package's, on zamba2-2.7b smoke in
float32 on the CPU, with the JAX parameters carried over by
``repro_torch.bridge``: the Mamba2 layer (the full sequence, the chunked
prefill from a carried cache, the one-token decode, the conv window), the
causal conv's prefill and decode forms bit for bit, the weight-tied shared
attention block (at head_dim 80, zamba2-2.7b's own, too), the model's
logits, ``lm_loss``, the gradients of one train step and a short SEBS run
with pSGD, the paged engine's greedy tokens, stats and memory (the nine
shared caches' KV counted per page), checkpoints written by either package
and resumed by the other, and both launchers with ``--arch zamba2-2.7b``.
The static and continuous engines' tokens, and ``cache_insert`` /
``cache_extract`` of zamba2's rows, are in tests/test_torch_serve_dense.py.

The JAX weights get a spread of ``dt_bias``, non-zero conv bias, gated-norm
and norm scales and a ``D`` away from 1, so that the test sees them.
Tolerances (f32, the same formulas summed in other orders): layers, logits
and losses 1e-4; gradients 1e-4 of each leaf's norm; the conv's prefill and
decode forms exactly; greedy tokens and engine stats exactly.
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
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.layers import mamba2 as jmamba2  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.serve import PagedContinuousBatchingEngine as JaxEngine  # noqa: E402
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
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.layers import mamba2  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.serve import PagedContinuousBatchingEngine  # noqa: E402
from repro_torch.train.loss import lm_loss  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import _grads_over_microbatches  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

TOL = 1e-4
ARCH = "zamba2-2.7b"
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
    """Non-default values for the leaves the JAX init leaves at 0 or 1."""
    rng = np.random.default_rng(seed)
    seg = tree["seg0"]
    for name, block in seg.items():
        if "mamba" in block:
            m = block["mamba"]
            reps, nh = m["dt_bias"].shape
            m["dt_bias"] = np.broadcast_to(np.linspace(-2, 1, nh, dtype=np.float32), (reps, nh)).copy()
            m["D"] = (1 + 0.5 * rng.standard_normal(m["D"].shape)).astype(np.float32)
            for leaf in ("conv_b", "norm_scale"):
                m[leaf] = (0.1 * rng.standard_normal(m[leaf].shape)).astype(np.float32)
        for n in ("norm1", "norm2"):
            if n in block:
                block[n]["scale"] = (0.1 * rng.standard_normal(block[n]["scale"].shape)).astype(np.float32)
    return tree


def _models(**cfg_kw):
    """(jax model, jax params, port model, port params, numpy tree), made
    once per configuration."""
    key = tuple(sorted(cfg_kw.items()))
    if key not in _MODELS:
        jcfg = jax_config(ARCH, "smoke").replace(compute_dtype="float32", **cfg_kw)
        tcfg = get_config(ARCH, "smoke").replace(compute_dtype="float32", **cfg_kw)
        jmodel = build_model(jcfg)
        tree = _spread(jax.tree.map(np.asarray, jmodel.init(jax.random.key(0))[0]))
        _MODELS[key] = (jmodel, jax.tree.map(jnp.asarray, tree), LanguageModel(tcfg),
                        bridge.params_from_numpy(tree, tcfg, device="cpu"), tree)
    return _MODELS[key]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


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


def test_bridge_carries_the_zamba2_tree():
    _, _, tmodel, tparams, tree = _models()
    seg = tparams["seg0"]
    assert sorted(seg) == ["b0", "b1", "shared"]
    assert set(seg["shared"]) == {"norm1", "attn", "norm2", "mlp"}  # one tied block, no layers axis
    assert len(seg["b0"]) == 1 and set(seg["b0"][0]) == {"norm1", "mamba"}  # ffn "none": no norm2
    np.testing.assert_array_equal(seg["b1"][0]["mamba"]["D"], tree["seg0"]["b1"]["mamba"]["D"][0])
    init = LanguageModel(tmodel.cfg).init(0, device="cpu")
    assert _shapes(init) == _shapes(tparams)
    bf16 = LanguageModel(tmodel.cfg.replace(param_dtype="bfloat16")).init(0, device="cpu")
    mamba = bf16["seg0"]["b0"][0]["mamba"]
    assert mamba["A_log"].dtype == mamba["D"].dtype == torch.float32  # f32 under bf16 params
    assert mamba["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["scan", "scan_from_cache", "decode"])
def test_mamba2_layer_matches_jax(mode):
    """The layer's output and new cache (SSM state, conv window) in each of
    its three cases, the cache's conv window in bf16 as the engines hold it."""
    jmodel, _, tmodel, tparams, tree = _models()
    cfg, jcfg = tmodel.cfg, jmodel.cfg
    layer_np = jax.tree.map(lambda a: a[0], tree["seg0"]["b1"]["mamba"])
    rng = np.random.default_rng(2)
    s = 1 if mode == "decode" else 70  # past one 64-position chunk
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    cache = None
    if mode != "scan":
        ssm = (0.3 * rng.standard_normal((2, 8, 16, 64))).astype(np.float32)
        conv = rng.standard_normal((2, 3, 512 + 32)).astype(np.float32)
        cache = (ssm, conv)
    jc = None if cache is None else {"ssm": jnp.asarray(cache[0]), "conv": jnp.asarray(cache[1], jnp.bfloat16)}
    tc = None if cache is None else {"ssm": _t(cache[0])[0], "conv": _t(cache[1])[0].to(torch.bfloat16)}
    idx = 5 if mode == "decode" else None
    jy, jnew = jmamba2.apply(layer_np, jnp.asarray(x), jcfg, cache=jc,
                             cache_index=None if idx is None else jnp.int32(idx))
    with torch.no_grad():
        ty, tnew = mamba2.apply(tparams["seg0"]["b1"][0]["mamba"], _t(x)[0], cfg, cache=tc,
                                cache_index=None if idx is None else torch.tensor(idx))
    _close(ty, jy)
    if cache is None:
        assert tnew is None and jnew is None
        return
    for name in ("ssm", "conv"):
        assert tnew[name].dtype == getattr(torch, str(jnew[name].dtype)), name
        _close(tnew[name].float(), np.asarray(jnew[name], np.float32))


def test_causal_conv_gives_a_decode_tick_the_bits_of_a_prefill():
    """The paged engine feeds a prompt's tail through decode ticks: the conv
    of a one-token window equals the prefill's conv at that position bit for
    bit, and so does the window the layer carries on."""
    _, _, tmodel, tparams, _ = _models()
    cfg = tmodel.cfg
    w = tparams["seg0"]["b0"][0]["mamba"]["conv_w"]
    rng = np.random.default_rng(4)
    windowed = torch.from_numpy(rng.standard_normal((2, 3 + 40, w.shape[1])).astype(np.float32))
    full = mamba2._causal_conv(windowed, w)
    for t in range(40):
        assert torch.equal(mamba2._causal_conv(windowed[:, t:t + 4], w)[:, 0], full[:, t]), t
    # the layer: a prefill of 9 tokens, and one of 6 then three decode ticks
    x = torch.from_numpy(rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32))
    layer = tparams["seg0"]["b0"][0]["mamba"]
    with torch.no_grad():
        y_full, c_full = mamba2.apply(layer, x, cfg, cache=mamba2.init_cache(cfg, 2, torch.float32, "cpu"))
        ys = []
        y, c = mamba2.apply(layer, x[:, :6], cfg, cache=mamba2.init_cache(cfg, 2, torch.float32, "cpu"))
        ys.append(y)
        for t in range(6, 9):
            y, c = mamba2.apply(layer, x[:, t:t + 1], cfg, cache=c, cache_index=torch.tensor(t))
            ys.append(y)
    _close(torch.cat(ys, dim=1), y_full, 1e-5)
    _close(c["ssm"], c_full["ssm"], 1e-5)
    _close(c["conv"], c_full["conv"], 1e-5)


@pytest.mark.parametrize("head_dim", [64, 80])
def test_shared_block_matches_jax(head_dim):
    """The tied attention + dense block, full sequence, at the smoke's
    head_dim and at zamba2-2.7b's 80 (the CPU path: the flash kernels'
    plain versions)."""
    jmodel, _, tmodel, tparams, tree = _models(head_dim=head_dim)
    shared_np = tree["seg0"]["shared"]
    x = np.random.default_rng(3).standard_normal((2, 19, tmodel.cfg.d_model)).astype(np.float32)
    pos = np.arange(19)[None, :]
    jy, _, _ = jblocks.apply_block(shared_np, jnp.asarray(x), jmodel.cfg, jblocks.SHARED_SPEC,
                                   positions=jnp.asarray(pos))
    with torch.no_grad():
        ty, _, _ = blocks.apply_block(tparams["seg0"]["shared"], _t(x)[0], tmodel.cfg, blocks.SHARED_SPEC,
                                      positions=_t(pos)[0])
    assert tparams["seg0"]["shared"]["attn"]["wq"].shape[-1] == head_dim
    _close(ty, jy)


@pytest.mark.parametrize("head_dim", [64, 80])
def test_forward_and_loss_match_jax(head_dim):
    jmodel, jparams, tmodel, tparams, _ = _models(head_dim=head_dim)
    tokens = _tokens(2, 33)
    jlogits, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    jtotal, _ = jax.jit(lambda p, b: jax_lm_loss(jmodel, p, b, z_loss=1e-4))(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tlogits, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
        total, _ = lm_loss(tmodel, tparams, {"tokens": torch.from_numpy(tokens)}, z_loss=1e-4)
    _close(tlogits, jlogits)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=TOL)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def test_train_step_grads_match_jax():
    """Gradients per leaf (1e-4 of the leaf's norm) over two microbatches,
    through the remat'd blocks, the GLA backward with the current token
    included, the broadcasts of C, B and the decay summed back, and the
    shared block's two applications summed into its one set of weights."""
    jmodel, jparams, tmodel, tparams, _ = _models()
    batch = _tokens(4, 17, seed=3).reshape(2, 2, 17)
    jg, jm = jax.jit(lambda p, b: jax_grads(jmodel, p, b, 2, 0.0))(jparams, {"tokens": jnp.asarray(batch)})
    leaves = [w.detach().clone().requires_grad_(True) for w in tree_leaves(tparams)]
    params = _rebuild(tparams, iter(leaves))
    tg, tm = _grads_over_microbatches(tmodel, params, {"tokens": torch.from_numpy(batch)}, 2, 0.0)
    expect = tree_leaves(bridge.params_from_numpy(jax.tree.map(np.asarray, jg), tmodel.cfg, device="cpu"))
    assert len(tg) == len(expect) == len(leaves)
    for got, e in zip(tg, expect):
        assert got.shape == e.shape
        assert torch.linalg.vector_norm(got - e) <= TOL * torch.linalg.vector_norm(e) + 1e-9
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL)


def _sebs(pkg):
    return pkg(b1=4, C1=8, rho=2.0, num_stages=2, eta=0.3)  # batches 4, 4, 8, 8


def _jax_trainer():
    jmodel, _, _, _, tree = _models()
    jparams = jax.tree.map(jnp.asarray, tree)  # fresh buffers: the trainer donates them
    jopt = jax_make_optimizer("psgd", gamma=1e4)
    trainer = JTrainer(jmodel, jopt, _sebs(JSEBS), JPipeline(JTokenDataset(512, 16, 0)),
                       microbatch=4, mode="accumulate", accum_mode="psum_each")
    return trainer, JTrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))


def _port_trainer():
    _, _, tmodel, _, tree = _models()
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
    """Four SEBS updates with pSGD (batches 4, 4, 8, 8 of 16 tokens)."""
    jlog = _jax_log()
    trainer, state = _port_trainer()
    _, tlog = trainer.run(state, log_every=1)
    assert tlog.batch_sizes == jlog.batch_sizes == [4, 4, 8, 8] and tlog.stages == jlog.stages
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=TOL)
    assert all(np.isfinite(tlog.losses))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_the_packages(writer, tmp_path):
    """A checkpoint after update 2 written by one package, resumed by the
    other: the shared block stays one unstacked tree, the Mamba2 leaves
    (A_log and D f32) cross both ways, and the resumed losses stay within
    1e-4 relative of JAX's uninterrupted run."""
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


def test_paged_kv_bytes_count_the_shared_caches():
    """Each repeat's shared-attention cache holds K and V in the pool: the
    smoke's one repeat, and at full width 9 x 2 x 32 heads x 80 x 2 bytes
    a token, as the JAX engine accounts it."""
    jmodel, _, tmodel, _, _ = _models()
    assert tmodel.paged_kv_bytes_per_page(4) == jmodel.paged_kv_bytes_per_page(4) == 1 * 2 * 4 * 4 * 64 * 2
    full = LanguageModel(get_config(ARCH, "full"))
    assert full.paged_kv_bytes_per_page(1) == 9 * 2 * 32 * 80 * 2
    assert build_model(jax_config(ARCH, "full")).paged_kv_bytes_per_page(1) == 9 * 2 * 32 * 80 * 2


def test_paged_engine_greedy_matches_jax():
    """Prompts with a shared prefix through two slots: sharing is off for a
    hybrid model (no prefix reuse), and the tokens, stats and memory
    accounting equal the JAX engine's."""
    jmodel, jparams, tmodel, tparams, _ = _models()
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 512, 8)
    prompts = [np.concatenate([prefix, rng.integers(0, 512, 3 + i)]).astype(np.int32) for i in range(3)]
    kw = dict(cache_len=64, max_slots=2, page_size=4, prefill_chunks=(4,))
    runs = []
    for engine in (JaxEngine(jmodel, jparams, kernel="xla", seed=0, **kw),
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
    assert not engine.prefix_sharing and engine.stats["prefix_tokens_reused"] == 0
    assert engine.memory_stats() == jax_engine.memory_stats()


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_engine_cases_match_jax(case):
    """Pool pressure with requeue, and a one-page pool with a one-token
    prompt and one new token (tests/_torch_engine_cases.py): the Mamba2
    state rows ride per slot beside the pages."""
    jmodel, jparams, tmodel, tparams, _ = _models()
    run_engine_case(case, JaxEngine, PagedContinuousBatchingEngine, jmodel, jparams, tmodel, tparams)


def test_launchers_take_zamba2():
    results = serve_launcher.main(["--engine", "paged", "--device", "cpu", "--arch", ARCH,
                                   "--requests", "2", "--prompt-len", "9", "--new-tokens", "3",
                                   "--cache-len", "32", "--chunk", "4", "--page-size", "4"])
    assert all(len(row) == 9 + 3 for row in results.values())
    for engine in ("static", "continuous"):
        results = serve_launcher.main(["--engine", engine, "--device", "cpu", "--arch", ARCH,
                                       "--prompt-len", "5", "--new-tokens", "2", "--cache-len", "16"])
        assert all(len(row) == 5 + 2 for row in results.values())
    log = train_launcher.main(["--device", "cpu", "--arch", ARCH, "--b1", "2", "--c1", "2",
                               "--rho", "2", "--stages", "2", "--seq", "8", "--steps-log", "1"])
    assert log.batch_sizes == [2, 4] and all(np.isfinite(log.losses))
