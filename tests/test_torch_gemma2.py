"""The port's gemma2 path against the JAX package's, on gemma2-9b smoke in
float32 on the CPU, with the JAX parameters carried over by
``repro_torch.bridge``: the soft-capped full-sequence attention, which both
packages route to ``_sdpa`` (or ``_sdpa_chunked`` above ``attn_chunk``)
instead of a flash kernel, with the local layers' sliding window; the
model's logits, ``lm_loss`` with the final logit soft-cap and the
gradients of one train step; the attention layer's dense prefill and
decode with a cap; and the greedy tokens of the paged, static and
continuous engines.

Tolerances (f32, the same formulas summed in other orders): layers, logits
and losses 1e-4; gradients 1e-4 of each leaf's norm; the bf16 KV cache
1e-6 (the same roundings); greedy tokens and engine stats exactly.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_engine_cases import CASES, run_engine_case  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.layers import attention as jattention  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxContinuous  # noqa: E402
from repro.serve import PagedContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro.train.loss import lm_loss as jax_lm_loss  # noqa: E402
from repro.train.step import _grads_over_microbatches as jax_grads  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models.layers import attention  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine, PagedContinuousBatchingEngine, ServeEngine  # noqa: E402
from repro_torch.train.loss import lm_loss  # noqa: E402
from repro_torch.train.step import _grads_over_microbatches  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

TOL = 1e-4
ARCH = "gemma2-9b"
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


def _windowed(cfg, window=5):
    """The config with its local layers' window cut to ``window``."""
    segments = tuple(dataclasses.replace(seg, body=tuple(
        dataclasses.replace(b, sliding_window=window) if b.mixer == "swa" else b for b in seg.body))
        for seg in cfg.segments)
    return cfg.replace(sliding_window=window, segments=segments)


def _models(**cfg_kw):
    """(jax model, jax params, port model, port params, numpy tree), made
    once per configuration. The smoke's window of 4,096 covers any test
    sequence, so the local layer gets a window of 5."""
    key = tuple(sorted(cfg_kw.items()))
    if key not in _MODELS:
        jcfg, tcfg = (_windowed(fn(ARCH, "smoke").replace(compute_dtype="float32", **cfg_kw))
                      for fn in (jax_config, get_config))
        jmodel = build_model(jcfg)
        tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0))[0])
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


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("attn_chunk", [None, 8])
def test_softcapped_full_sequence_attention_matches_jax(window, attn_chunk):
    """``_sdpa`` over the whole sequence, and ``_sdpa_chunked`` by blocks of
    8 queries (S 32 > attn_chunk), with and without the window."""
    jmodel, _, tmodel, tparams, tree = _models(attn_chunk=attn_chunk)
    layer_np = jax.tree.map(lambda a: a[0], tree["seg0"]["b0"]["attn"])
    x = np.random.default_rng(2).standard_normal((2, 32, tmodel.cfg.d_model)).astype(np.float32)
    pos = np.arange(32)[None, :]
    jy, _ = jattention.apply(layer_np, jnp.asarray(x), jmodel.cfg, positions=jnp.asarray(pos),
                             sliding_window=window)
    with torch.no_grad():
        ty, _ = attention.apply(tparams["seg0"]["b0"][0]["attn"], _t(x)[0], tmodel.cfg,
                                positions=_t(pos)[0], sliding_window=window)
    _close(ty, jy)


def test_forward_and_loss_match_jax():
    jmodel, jparams, tmodel, tparams, _ = _models()
    tokens = _tokens(2, 33)
    jlogits, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    jtotal, _ = jax.jit(lambda p, b: jax_lm_loss(jmodel, p, b, z_loss=1e-4))(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tlogits, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
        total, _ = lm_loss(tmodel, tparams, {"tokens": torch.from_numpy(tokens)}, z_loss=1e-4)
    assert float(tlogits.abs().max()) <= 30.0  # the final soft-cap
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
    through the remat'd blocks and autograd of the soft-capped attention."""
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


@pytest.mark.parametrize("window", [None, 3])
def test_dense_prefill_and_decode_with_a_cap_match_jax(window):
    """``attention.apply`` with gemma2's cap: a prefill into a zero cache
    (``_sdpa``), then decodes at a scalar and at a per-row index."""
    jmodel, _, tmodel, tparams, tree = _models()
    layer = jax.tree.map(lambda a: a[0], tree["seg0"]["b1"]["attn"])
    tlayer = tparams["seg0"]["b1"][0]["attn"]
    jcfg, tcfg = jmodel.cfg, tmodel.cfg
    rng = np.random.default_rng(3)
    b, s, d = 2, 5, tcfg.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    japply = jax.jit(jattention.apply, static_argnames=("cfg", "sliding_window"))
    jcache = jattention.init_cache(jcfg, b, 16, jnp.bfloat16)
    tcache = attention.init_cache(tcfg, b, 16, torch.bfloat16, device="cpu")
    pos = np.arange(s)[None, :]
    jy, jcache = japply(layer, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), cache=jcache,
                        sliding_window=window)
    with torch.no_grad():
        ty, _ = attention.apply(tlayer, torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
                                cache=tcache, sliding_window=window)
    _close(ty, jy)
    for idx in (np.int32(s), np.asarray([s, s + 2], np.int32)):
        for n in "kv":
            np.testing.assert_allclose(tcache[n].float().numpy(), np.asarray(jcache[n], np.float32), atol=1e-6)
        x1 = rng.standard_normal((b, 1, d)).astype(np.float32)
        p1 = np.broadcast_to(idx, (b,))[:, None]
        jy, jcache = japply(layer, jnp.asarray(x1), jcfg, positions=jnp.asarray(p1), cache=jcache,
                            cache_index=jnp.asarray(idx), sliding_window=window)
        with torch.no_grad():
            ty, _ = attention.apply(tlayer, torch.from_numpy(x1), tcfg, positions=torch.from_numpy(p1.copy()),
                                    cache=tcache, cache_index=torch.from_numpy(np.asarray(idx)),
                                    sliding_window=window)
        _close(ty, jy)


def test_paged_engine_greedy_matches_jax():
    """Prompts sharing a prefix: prefix sharing is on for gemma2, and the
    tokens, stats and memory accounting equal JAX's paged engine's."""
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
    assert engine.prefix_sharing and engine.stats["prefix_tokens_reused"] > 0
    assert engine.memory_stats() == jax_engine.memory_stats()


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_engine_cases_match_jax(case):
    """Pool pressure with requeue, and a one-page pool with a one-token
    prompt and one new token (tests/_torch_engine_cases.py), with the
    local layers' window cut to 5 so that it bites."""
    jmodel, jparams, tmodel, tparams, _ = _models()
    run_engine_case(case, JaxEngine, PagedContinuousBatchingEngine, jmodel, jparams, tmodel, tparams)


def test_dense_engines_greedy_match_jax():
    jmodel, jparams, tmodel, tparams, _ = _models()
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
