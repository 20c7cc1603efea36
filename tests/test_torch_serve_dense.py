"""The port's dense serving path against the JAX package's, on qwen2.5-3b,
rwkv6-1.6b and zamba2-2.7b smoke in float32 on the CPU (zamba2's rows
carry Mamba2's SSM state and conv window and the shared block's KV), with
the JAX weights carried over by ``repro_torch.bridge`` (rwkv6's with
non-zero bonus ``u`` and a spread of decay rates, so that the test sees
them): the attention layer's dense prefill and decode branches (a scalar
and a per-row cache index, a sliding window, logit soft-capping, which
routes the prefill to ``_sdpa``), ``LanguageModel.prefill`` and the dense
``decode_step``, ``cache_insert``/``cache_extract``, and the greedy token
streams of ``ServeEngine`` and ``ContinuousBatchingEngine`` (slot
recycling, the admission ramp's one decode width per stage, mixed prompt
lengths and budgets), and the serve launcher's static and continuous
engines.

Tolerances (f32, the same formulas summed in other orders): layer outputs
and logits 1e-4; cache leaves 1e-6 (the bf16 KV cache holds the same
roundings); greedy tokens exactly. The JAX runs are made once per
architecture and shared (``_JAX_RUNS``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.layers import attention as jattention  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxContinuous  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models.layers import attention  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine, ServeEngine  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

TOL = 1e-4
# an f32 cache leaf of the prefill, against its scale (f32 rounding: qwen measured 8.5e-7)
CACHE_F32_TOL = 1e-5
ARCHS = ("qwen2.5-3b", "rwkv6-1.6b", "zamba2-2.7b")
_WEIGHTS: dict = {}
_JAX_RUNS: dict = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, where torch's default of one thread a core oversubscribes
    the host."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _weights(arch):
    """(jax model, jax params, port model, port params), made once."""
    if arch not in _WEIGHTS:
        jcfg = jax_config(arch, "smoke").replace(compute_dtype="float32")
        tcfg = get_config(arch, "smoke").replace(compute_dtype="float32")
        jmodel = build_model(jcfg)
        tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0))[0])
        if arch.startswith("rwkv6"):
            tmix = tree["seg0"]["b0"]["tmix"]
            reps, d = tmix["decay_base"].shape
            rng = np.random.default_rng(0)
            tmix["bonus_u"] = (0.5 * rng.standard_normal(tmix["bonus_u"].shape)).astype(np.float32)
            tmix["decay_base"] = np.broadcast_to(np.linspace(-6, -1, d, dtype=np.float32), (reps, d)).copy()
        _WEIGHTS[arch] = (jmodel, jax.tree.map(jnp.asarray, tree), LanguageModel(tcfg),
                          bridge.params_from_numpy(tree, tcfg, device="cpu"))
    return _WEIGHTS[arch]


def _prompts(n=4, length=6, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (n, length)).astype(np.int32)


def _serve(engine, prompts, max_new_tokens=6, **req):
    ids = [engine.submit(p, max_new_tokens=max_new_tokens, **req) for p in prompts]
    out = engine.run()
    return [out[i] for i in ids]


def _jax_runs(arch):
    """JAX's static and continuous greedy streams on ``_prompts()``."""
    if arch not in _JAX_RUNS:
        jmodel, jparams, _, _ = _weights(arch)
        prompts = _prompts()
        static = JaxServe(jmodel, jparams, cache_len=64).generate(prompts, max_new_tokens=6)
        cont = _serve(JaxContinuous(jmodel, jparams, cache_len=64, max_slots=4), prompts)
        _JAX_RUNS[arch] = (static, np.stack(cont))
    return _JAX_RUNS[arch]


def _static(arch, prompts, new=6):
    _, _, tmodel, tparams = _weights(arch)
    return ServeEngine(tmodel, tparams, cache_len=64, device="cpu").generate(prompts, max_new_tokens=new)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_engine_greedy_matches_jax(arch):
    static, _ = _jax_runs(arch)
    got = _static(arch, _prompts())
    assert got.shape == (4, 12) and got.dtype == np.int32
    np.testing.assert_array_equal(got, static)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_greedy_matches_jax_and_static(arch):
    """Per-slot depths, per-row cache writes and batch-1 prefills give the
    tokens of JAX's continuous engine and of the port's static batch."""
    static, cont = _jax_runs(arch)
    _, _, tmodel, tparams = _weights(arch)
    engine = ContinuousBatchingEngine(tmodel, tparams, cache_len=64, max_slots=4, device="cpu")
    got = np.stack(_serve(engine, _prompts()))
    np.testing.assert_array_equal(got, cont)
    np.testing.assert_array_equal(got, _static(arch, _prompts()))
    np.testing.assert_array_equal(got, static)
    assert engine.stats["ticks"] == 5 and engine.stats["decoded_tokens"] == 20


def test_slot_recycling_serves_more_requests_than_slots():
    """Six requests through two slots in one decode loop: freed rows are
    re-admitted mid-loop and give the tokens of a fresh static batch."""
    _, _, tmodel, tparams = _weights("qwen2.5-3b")
    prompts = _prompts(n=6)
    engine = ContinuousBatchingEngine(tmodel, tparams, cache_len=64, max_slots=2, device="cpu")
    got = _serve(engine, prompts, max_new_tokens=5)
    assert engine.stats["peak_width"] == 2
    np.testing.assert_array_equal(np.stack(got), _static("qwen2.5-3b", prompts, new=5))


def test_admission_ramp_builds_one_decode_variant_per_stage():
    _, _, tmodel, tparams = _weights("qwen2.5-3b")
    engine = ContinuousBatchingEngine(tmodel, tparams, cache_len=64, max_slots=4, b1=1, rho=2.0,
                                      patience=2, device="cpu")
    assert engine.admission.ladder == [1, 2, 4]
    prompts = _prompts(n=8, length=4)
    got = _serve(engine, prompts, max_new_tokens=8)
    assert engine.admission.stage == engine.admission.num_stages - 1
    assert engine.decode_widths == {1, 2, 4}
    # grown caches keep the admitted rows: the ramp does not change a token
    np.testing.assert_array_equal(np.stack(got), _static("qwen2.5-3b", prompts, new=8))
    _serve(engine, prompts[:3], max_new_tokens=4)
    assert len(engine.decode_widths) == engine.admission.num_stages


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_insert_extract_roundtrip(arch):
    _, _, tmodel, tparams = _weights(arch)
    wide = tmodel.init_cache(3, 32, device="cpu")
    tokens = torch.arange(4, dtype=torch.int32)[None, :]
    with torch.inference_mode():
        _, one = tmodel.prefill(tparams, {"tokens": tokens}, tmodel.init_cache(1, 32, device="cpu"))
    tmodel.cache_insert(wide, one, 2)
    back = tmodel.cache_extract(wide, 2)
    for a, b in zip(tree_leaves(one), tree_leaves(back)):
        assert torch.equal(a.to(b.dtype), b)
    # untouched rows stay zero, and an extract is a copy
    assert all(not leaf.any() for leaf in tree_leaves(tmodel.cache_extract(wide, 0)))
    tree_leaves(back)[0].fill_(1.0)
    assert not torch.equal(tree_leaves(back)[0], tree_leaves(tmodel.cache_extract(wide, 2))[0])


def test_mixed_prompt_lengths_and_budgets():
    """Mixed lengths and budgets share one ring; max_new_tokens=1 completes
    at admission without a decode tick; each stream is its static batch-1
    generation."""
    _, _, tmodel, tparams = _weights("qwen2.5-3b")
    engine = ContinuousBatchingEngine(tmodel, tparams, cache_len=64, max_slots=2, device="cpu")
    p = _prompts(n=1, length=8)[0]
    ids = [engine.submit(p[:4], max_new_tokens=1), engine.submit(p, max_new_tokens=8),
           engine.submit(p[:6], max_new_tokens=3), engine.submit(p[:1], max_new_tokens=2)]
    out = engine.run()
    assert [out[i].shape for i in ids] == [(5,), (16,), (9,), (3,)]
    for rid, (length, new) in zip(ids, ((4, 1), (8, 8), (6, 3), (1, 2))):
        np.testing.assert_array_equal(out[rid], _static("qwen2.5-3b", p[None, :length], new=new)[0])
    for rid in ids:
        req = engine.scheduler.requests[rid]
        assert req.t_admit <= req.t_prefill_done <= req.t_first_token < req.t_finish
    assert set(engine.latencies()) == set(ids)


def test_sampling_params_per_slot():
    """top_k=1 reduces to greedy at any temperature; sampling follows the
    engine's seed and stays in the vocabulary."""
    _, _, tmodel, tparams = _weights("qwen2.5-3b")
    prompts = _prompts(n=2)
    engine = ContinuousBatchingEngine(tmodel, tparams, cache_len=64, max_slots=2, seed=7, device="cpu")
    got = _serve(engine, prompts, temperature=1.0, top_k=1)
    np.testing.assert_array_equal(np.stack(got), _static("qwen2.5-3b", prompts))
    runs = [_serve(ContinuousBatchingEngine(tmodel, tparams, cache_len=64, max_slots=2, seed=s,
                                            device="cpu"), prompts, temperature=0.8, top_k=16)
            for s in (7, 7, 8)]
    np.testing.assert_array_equal(np.stack(runs[0]), np.stack(runs[1]))
    assert not np.array_equal(np.stack(runs[0]), np.stack(runs[2]))
    assert all(row.max() < tmodel.cfg.vocab_size for row in runs[0])


@pytest.mark.parametrize("window,cap", [(None, None), (3, None), (None, 5.0)])
def test_attention_dense_branches_match_jax(window, cap):
    """Prefill into a zero cache (through the flash forward), then decode at
    a scalar and at a per-row index, against JAX's attention.apply."""
    jcfg = jax_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32", attn_logit_softcap=cap)
    tcfg = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32", attn_logit_softcap=cap)
    layer = jax.tree.map(lambda a: np.asarray(a[0]), _weights("qwen2.5-3b")[1]["seg0"]["b0"]["attn"])
    tlayer = {k: torch.from_numpy(v.copy()) for k, v in layer.items()}
    rng = np.random.default_rng(3)
    b, s, d = 2, 5, tcfg.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    japply = jax.jit(jattention.apply, static_argnames=("cfg", "sliding_window"))
    jcache = jattention.init_cache(jcfg, b, 16, jnp.bfloat16)
    tcache = attention.init_cache(tcfg, b, 16, torch.bfloat16, device="cpu")
    pos = np.arange(s)[None, :]
    # the prefill: the flash forward, or with a soft-cap _sdpa as in JAX
    jy, jcache = japply(layer, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), cache=jcache,
                        sliding_window=window)
    ty, _ = attention.apply(tlayer, torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
                            cache=tcache, sliding_window=window)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    for n in "kv":
        np.testing.assert_allclose(tcache[n].float().numpy(), np.asarray(jcache[n], np.float32), atol=1e-6)
    for idx in (np.int32(s), np.asarray([s, s + 2], np.int32)):
        x1 = rng.standard_normal((b, 1, d)).astype(np.float32)
        p1 = np.broadcast_to(idx, (b,))[:, None]
        jy, jcache = japply(layer, jnp.asarray(x1), jcfg, positions=jnp.asarray(p1), cache=jcache,
                            cache_index=jnp.asarray(idx), sliding_window=window)
        ty, _ = attention.apply(tlayer, torch.from_numpy(x1), tcfg, positions=torch.from_numpy(p1.copy()),
                                cache=tcache, cache_index=torch.from_numpy(np.asarray(idx)),
                                sliding_window=window)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
        for n in "kv":
            np.testing.assert_allclose(tcache[n].float().numpy(), np.asarray(jcache[n], np.float32), atol=1e-6)


def _port_cache(jcache):
    """JAX's dense cache (each segment's blocks stacked over their repeats)
    in the port's layout (a list a repeat), bit for bit."""
    def leaf(a):
        a = np.asarray(a)
        t = torch.from_numpy(a.astype(np.float32))
        return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t

    out = {}
    for seg, blocks in jcache.items():
        out[seg] = {}
        for name, tree in blocks.items():
            n = jax.tree.leaves(tree)[0].shape[0]
            out[seg][name] = [jax.tree.map(lambda a, i=i: leaf(a[i]), tree) for i in range(n)]
    return out


def _jax_cache(cache):
    """The port's dense cache in JAX's layout (the repeats stacked), bit for
    bit: the inverse of :func:`_port_cache`."""
    def leaf(t):
        return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)

    return {seg: {name: jax.tree.map(lambda *xs: jnp.stack([leaf(x) for x in xs]), *layers)
                  for name, layers in blocks.items()} for seg, blocks in cache.items()}


def _sorted_leaves(cache):
    """A port-layout cache's tensors, dict keys in sorted order."""
    if isinstance(cache, dict):
        return [t for k in sorted(cache) for t in _sorted_leaves(cache[k])]
    if isinstance(cache, list):
        return [t for v in cache for t in _sorted_leaves(v)]
    return [cache]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    """The prefill's logits within ``TOL``; then the decode step. Its
    logits read the prefill's cache, stored in bf16, and an f32 value of the
    prefill that lies within f32 rounding of a bf16 midpoint rounds to one
    side in one package and to the other in the other (which f32 roundings
    a host gives depends on its BLAS kernels): a flipped entry moves by one
    bf16 step (2^-8 of its magnitude), and 4 such entries moved qwen's
    decode logits by 1.6e-4. So the caches are held first (each package's
    bf16 cache is its f32 cache rounded, and the f32 caches agree within
    ``CACHE_F32_TOL`` of a leaf's scale, f32 rounding: every flip is one of
    these roundings), and then each decode step against the other
    package's on the same cache, within ``TOL``: the port's from its own
    cache against JAX's from the port's, JAX's from its own cache against
    the port's from JAX's."""
    jmodel, jparams, tmodel, tparams = _weights(arch)
    prompts = _prompts(n=2, length=7)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)}, jmodel.init_cache(2, 16))
    _, jcache32 = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                                 jmodel.init_cache(2, 16, dtype=jnp.float32))
    token = np.asarray([[3], [9]], np.int32)
    idx = np.asarray([7, 7], np.int32)
    with torch.inference_mode():
        tlogits, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                                         tmodel.init_cache(2, 16, device="cpu"))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
        _, tcache32 = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                                     tmodel.init_cache(2, 16, dtype=torch.float32, device="cpu"))
        for own, own32 in ((tcache, tcache32), (_port_cache(jcache), _port_cache(jcache32))):
            for a, a32 in zip(_sorted_leaves(own), _sorted_leaves(own32), strict=True):
                assert torch.equal(a, a32.to(a.dtype))
        for a32, b32 in zip(_sorted_leaves(tcache32), _sorted_leaves(_port_cache(jcache32)), strict=True):
            assert float((a32 - b32).abs().max()) <= CACHE_F32_TOL * float(b32.abs().max())
        for cache in (tcache, _port_cache(jcache)):
            jlogits, _ = jmodel.decode_step(jparams, jnp.asarray(token), _jax_cache(cache), jnp.asarray(idx))
            tlogits, _ = tmodel.decode_step(tparams, torch.from_numpy(token), cache, torch.from_numpy(idx))
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_launcher_serves_dense_engines_on_cpu(engine):
    flags = ["--batch", "3"] if engine == "static" else ["--requests", "5", "--slots", "4", "--b1", "1"]
    results = launcher.main(["--engine", engine, "--device", "cpu", "--prompt-len", "6",
                             "--new-tokens", "4", "--cache-len", "32", *flags])
    assert len(results) == (3 if engine == "static" else 5)
    assert all(len(row) == 6 + 4 for row in results.values())
