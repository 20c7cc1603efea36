"""The port's rwkv6 path against the JAX package's, on rwkv6-1.6b smoke in
float32 on the CPU, with the JAX parameters carried over by
``repro_torch.bridge``: the time-mix (scan and decode branches) and
channel-mix layers, ``LanguageModel.forward`` logits, ``lm_loss`` and the
gradients of one train step, the paged cache's per-slot state rows after
chunked prefills and a decode tick, the ``active`` mask of
``paged_state_merge``, the attention-free page accounting, the greedy
token streams of the paged engine, and both launchers with
``--arch rwkv6-1.6b``.

The JAX weights get non-zero bonus ``u``, group-norm and norm scales and a
spread of decay rates (``decay_base`` from -6 to -1), so that the test sees
them. Tolerances (f32, the same formulas summed in other orders): layers,
logits and loss 1e-4; gradients 1e-4 of each leaf's norm; the bf16 token
shifts of the paged cache 1e-2 (one rounding of f32 values); greedy tokens
and engine stats exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.layers import rwkv6 as jrwkv6  # noqa: E402
from repro.serve import PagedContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.train.loss import lm_loss as jax_lm_loss  # noqa: E402
from repro.train.step import _grads_over_microbatches as jax_grads  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models.layers import rwkv6  # noqa: E402
from repro_torch.serve import PagedContinuousBatchingEngine  # noqa: E402
from repro_torch.train.loss import lm_loss  # noqa: E402
from repro_torch.train.step import _grads_over_microbatches  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

TOL = 1e-4
ARCH = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config(ARCH, "smoke").replace(compute_dtype="float32")
    tcfg = get_config(ARCH, "smoke").replace(compute_dtype="float32")
    jmodel = build_model(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    layer = tree["seg0"]["b0"]
    reps, d = layer["tmix"]["decay_base"].shape
    layer["tmix"]["bonus_u"] = (0.5 * rng.standard_normal(layer["tmix"]["bonus_u"].shape)).astype(np.float32)
    layer["tmix"]["decay_base"] = np.broadcast_to(np.linspace(-6, -1, d, dtype=np.float32), (reps, d)).copy()
    for name in ("ln_scale",):
        layer["tmix"][name] = (0.1 * rng.standard_normal(layer["tmix"][name].shape)).astype(np.float32)
    for name in ("norm1", "norm2"):
        layer[name]["scale"] = (0.1 * rng.standard_normal(layer[name]["scale"].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = bridge.params_from_numpy(tree, tcfg, device="cpu")
    return jmodel, jparams, LanguageModel(tcfg), tparams, tree


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(out, expect, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(expect, np.float32),
                               atol=tol, rtol=tol)


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s)).astype(np.int32)


def test_bridge_carries_the_rwkv6_tree(models):
    _, _, tmodel, tparams, tree = models
    layers = tparams["seg0"]["b0"]
    assert len(layers) == tmodel.cfg.num_layers == 2
    assert set(layers[0]) == {"norm1", "tmix", "norm2", "cmix"}
    assert layers[0]["tmix"]["decay_lora_a"].dtype == torch.float32
    np.testing.assert_array_equal(layers[1]["tmix"]["bonus_u"], tree["seg0"]["b0"]["tmix"]["bonus_u"][1])
    assert tparams["embed"]["unembed"].shape == (256, 512)  # untied head
    init = LanguageModel(tmodel.cfg).init(0, device="cpu")
    assert _shapes(init) == _shapes(tparams)


def _shapes(tree, path=""):
    """{path: (shape, dtype)} of every leaf."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items() for k, v in _shapes(sub, f"{path}/{name}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _shapes(sub, f"{path}/{i}").items()}
    return {path: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("mode", ["scan", "scan_from_cache", "decode"])
def test_time_and_channel_mix_match_jax(models, mode):
    jmodel, _, tmodel, tparams, tree = models
    cfg, jcfg = tmodel.cfg, jmodel.cfg
    layer_np = jax.tree.map(lambda a: a[1], tree["seg0"]["b0"])
    rng = np.random.default_rng(2)
    s = 1 if mode == "decode" else 19
    x = rng.standard_normal((2, s, 256)).astype(np.float32)
    cache = None
    if mode != "scan":
        cache = {"wkv": (0.3 * rng.standard_normal((2, 4, 64, 64))).astype(np.float32),
                 "shift_t": rng.standard_normal((2, 256)).astype(np.float32),
                 "shift_c": rng.standard_normal((2, 256)).astype(np.float32)}
    jc = None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()}
    tc = None if cache is None else {k: v for k, v in zip(cache, _t(*cache.values()))}
    decode = mode == "decode"
    jy, jwkv, jshift = jrwkv6.apply_time_mix(layer_np["tmix"], jnp.asarray(x), jcfg, cache=jc, decode=decode)
    with torch.no_grad():
        ty, twkv, tshift = rwkv6.apply_time_mix(tparams["seg0"]["b0"][1]["tmix"], _t(x)[0], cfg,
                                                cache=tc, decode=decode)
        tcy, tcs = rwkv6.apply_channel_mix(tparams["seg0"]["b0"][1]["cmix"], _t(x)[0], cfg, cache=tc)
    _close(ty, jy)
    _close(twkv, jwkv)
    _close(tshift, jshift)
    jcy, jcs = jrwkv6.apply_channel_mix(layer_np["cmix"], jnp.asarray(x), jcfg, cache=jc)
    _close(tcy, jcy)
    _close(tcs, jcs)


def test_forward_and_loss_match_jax(models):
    jmodel, jparams, tmodel, tparams, _ = models
    tokens = _tokens(2, 33)
    jlogits, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    jtotal, _ = jax.jit(lambda p, b: jax_lm_loss(jmodel, p, b, z_loss=1e-4))(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tlogits, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
        total, _ = lm_loss(tmodel, tparams, {"tokens": torch.from_numpy(tokens)}, z_loss=1e-4)
    _close(tlogits, jlogits)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=TOL)


def test_train_step_grads_match_jax(models):
    """Gradients per leaf (1e-4 of the leaf's norm) over two microbatches,
    through the remat'd blocks and the GLA backward."""
    jmodel, jparams, tmodel, tparams, _ = models
    batch = _tokens(4, 17, seed=3).reshape(2, 2, 17)
    jg, jm = jax.jit(lambda p, b: jax_grads(jmodel, p, b, 2, 0.0))(jparams, {"tokens": jnp.asarray(batch)})
    leaves = [w.detach().clone().requires_grad_(True) for w in tree_leaves(tparams)]
    it = iter(leaves)
    params = _rebuild(tparams, it)
    tg, tm = _grads_over_microbatches(tmodel, params, {"tokens": torch.from_numpy(batch)}, 2, 0.0)
    expect = tree_leaves(bridge.params_from_numpy(jax.tree.map(np.asarray, jg), tmodel.cfg, device="cpu"))
    assert len(tg) == len(expect) == len(leaves)
    for got, e in zip(tg, expect):
        assert got.shape == e.shape
        assert torch.linalg.vector_norm(got - e) <= TOL * torch.linalg.vector_norm(e) + 1e-9
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


@pytest.fixture(scope="module")
def paged_case(models):
    """Slot 1 prefilled by two chunks of 4, slot 0 by one chunk of 6, in
    the cache an engine of two slots would hold (bf16 token shifts)."""
    jmodel, jparams, tmodel, tparams, _ = models
    ps, num_pages = 4, 8
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, size=6).astype(np.int32), rng.integers(0, 512, size=9).astype(np.int32)]
    table = np.asarray([[4, 5, 0, 0], [1, 2, 3, 0]], np.int32)
    jcache = jmodel.init_paged_cache(num_pages, ps, 2)
    tcache = tmodel.init_paged_cache(num_pages, ps, 2, device="cpu")
    jlogits, tlogits = [], []
    for slot, start, size in ((1, 0, 4), (1, 4, 4), (0, 0, 6)):
        chunk = prompts[slot][start:start + size][None]
        jl, jcache = jmodel.prefill_chunk(jparams, jnp.asarray(chunk), jcache, jnp.int32(start),
                                          jnp.int32(slot), jnp.asarray(table[slot:slot + 1]))
        with torch.no_grad():
            tl, tcache = tmodel.prefill_chunk(tparams, _t(chunk)[0], tcache, start, slot,
                                              _t(table[slot:slot + 1])[0])
        jlogits.append(np.asarray(jl))
        tlogits.append(tl.numpy())
    return dict(jcache=jcache, tcache=tcache, table=table, prompts=prompts,
                jlogits=jlogits, tlogits=tlogits)


def _state_rows(jcache, tcache):
    """(name, port leaf, JAX leaf) for every layer's state leaves."""
    for r in range(2):
        for name in ("wkv", "shift_t", "shift_c"):
            yield (name, tcache["seg0"]["b0"][r]["rwkv"][name].float().numpy(),
                   np.asarray(jcache["seg0"]["b0"]["rwkv"][name][r].astype(jnp.float32)))


def test_prefill_chunk_state_rows_and_logits_match_jax(paged_case):
    for got, expect in zip(paged_case["tlogits"], paged_case["jlogits"]):
        assert got.shape == expect.shape == (1, 1, 512)
        _close(got, expect)
    for name, got, expect in _state_rows(paged_case["jcache"], paged_case["tcache"]):
        assert np.abs(got).max() > 0, name
        _close(got, expect, TOL if name == "wkv" else 1e-2)


def test_decode_tick_merges_only_active_lanes_as_jax(models, paged_case):
    """A tick of width 2 where slot 1 teacher-forces its last prompt token
    and slot 0 is a dead lane (awaiting a chunk): slot 1's rows advance as
    in JAX, slot 0's rows are left as they were."""
    jmodel, jparams, tmodel, tparams, _ = models
    tokens = np.asarray([[7], [paged_case["prompts"][1][8]]], np.int32)
    pos = np.asarray([6, 8], np.int32)
    active = np.asarray([False, True])
    before = [row.copy() for _, row, _ in _state_rows(paged_case["jcache"], paged_case["tcache"])]
    jsliced = jmodel.paged_state_slice(paged_case["jcache"], 2)
    jl, jnew = jmodel.decode_step(jparams, jnp.asarray(tokens), jsliced, jnp.asarray(pos),
                                  page_table=jnp.asarray(paged_case["table"]))
    jcache = jmodel.paged_state_merge(paged_case["jcache"], jnew, 2, active=jnp.asarray(active))
    with torch.no_grad():
        tsliced = tmodel.paged_state_slice(paged_case["tcache"], 2)
        tl, tnew = tmodel.decode_step(tparams, *_t(tokens), tsliced, *_t(pos, paged_case["table"]))
        tcache = tmodel.paged_state_merge(paged_case["tcache"], tnew, 2, active=_t(active)[0])
    _close(tl[1], np.asarray(jl)[1])
    for (name, got, expect), old in zip(_state_rows(jcache, tcache), before):
        np.testing.assert_array_equal(got[0], old[0], err_msg=f"dead lane's {name} moved")
        assert not np.array_equal(got[1], old[1]), name
        _close(got, expect, TOL if name == "wkv" else 1e-2)


def test_paged_state_merge_leaves_a_dead_lane_alone(models):
    _, _, tmodel, _, _ = models
    full = tmodel.init_paged_cache(3, 4, 3, device="cpu")
    ones = tmodel._map_paged(lambda leaf: leaf, torch.ones_like, tmodel.paged_state_slice(full, 2))
    merged = tmodel.paged_state_merge(full, ones, 2, active=torch.tensor([False, True]))
    for leaf in tree_leaves(merged):
        assert (leaf[0] == 0).all() and (leaf[1] == 1).all() and (leaf[2] == 0).all()
    tmodel.paged_zero_state_row(merged, 1)
    assert all((leaf == 0).all() for leaf in tree_leaves(merged))


def test_attention_free_pages_hold_no_kv(models):
    jmodel, _, tmodel, _, _ = models
    assert tmodel.paged_kv_bytes_per_page(16) == jmodel.paged_kv_bytes_per_page(16) == 0
    qwen = LanguageModel(get_config("qwen2.5-3b", "smoke"))
    jqwen = build_model(jax_config("qwen2.5-3b", "smoke"))
    assert qwen.paged_kv_bytes_per_page(16) == jqwen.paged_kv_bytes_per_page(16) > 0


def test_engine_greedy_matches_jax(models):
    """Prompts with a shared prefix: sharing is off for a recurrent model
    (no prefix reuse), the tokens, stats and memory accounting equal the JAX
    engine's."""
    jmodel, jparams, tmodel, tparams, _ = models
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


def test_launchers_take_rwkv6():
    results = serve_launcher.main(["--engine", "paged", "--device", "cpu", "--arch", ARCH,
                                   "--requests", "2", "--prompt-len", "9", "--new-tokens", "3",
                                   "--cache-len", "32", "--chunk", "4", "--page-size", "4"])
    assert all(len(row) == 9 + 3 for row in results.values())
    log = train_launcher.main(["--device", "cpu", "--arch", ARCH, "--b1", "2", "--c1", "2",
                               "--rho", "2", "--stages", "2", "--seq", "8", "--steps-log", "1"])
    assert log.batch_sizes == [2, 4] and all(np.isfinite(log.losses))
