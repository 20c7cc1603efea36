"""The port's layers and model against the JAX package's, on qwen2.5-3b
smoke in float32, with the JAX parameters carried over by
``repro_torch.bridge``: rope, norm, mlp, embedding, the paged attention
branches with their writes into the pool, and ``decode_step`` /
``prefill_chunk`` logits at atol = rtol = 1e-4. Inputs are made with numpy
from a seed. The KV pools are bfloat16 on both sides (the engine's default
cache type).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.checkpoint import save_checkpoint  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.models.layers import embedding as jemb  # noqa: E402
from repro.models.layers import mlp as jmlp  # noqa: E402
from repro.models.layers import norm as jnorm  # noqa: E402
from repro.models.layers import rope as jrope  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models.layers import attention, embedding, mlp, norm, rope  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def cfgs():
    jcfg = jax_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    tcfg = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models(cfgs):
    jcfg, tcfg = cfgs
    jmodel = build_model(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    # non-zero biases and norm scales, so that the test sees them
    rng = np.random.default_rng(0)
    layer = np_params["seg0"]["b0"]
    for name in ("bq", "bk", "bv"):
        layer["attn"][name] = rng.normal(size=layer["attn"][name].shape).astype(np.float32) * 0.1
    for name in ("norm1", "norm2"):
        layer[name]["scale"] = rng.normal(size=layer[name]["scale"].shape).astype(np.float32) * 0.1
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = bridge.params_from_numpy(np_params, tcfg, device="cpu")
    return jmodel, jparams, LanguageModel(tcfg), tparams, np_params


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(out, expect, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(expect, np.float32),
                               atol=tol, rtol=tol)


def test_bridge_unstacks_layers(models, cfgs):
    _, _, _, tparams, np_params = models
    layers = tparams["seg0"]["b0"]
    assert len(layers) == cfgs[1].num_layers == 2
    for r, layer in enumerate(layers):
        assert tuple(layer["attn"]["wq"].shape) == np_params["seg0"]["b0"]["attn"]["wq"].shape[1:]
        np.testing.assert_array_equal(layer["attn"]["wo"], np_params["seg0"]["b0"]["attn"]["wo"][r])
    assert tparams["embed"]["table"].device.type == "cpu"


def test_checkpoint_loader_reads_the_jax_format(tmp_path, models, cfgs):
    """A tree written by the JAX package's save_checkpoint, with a bf16 leaf,
    loads into the same parameters as the in-memory numpy tree."""
    _, jparams, _, _, np_params = models
    tree = dict(jparams, final_norm={"scale": jparams["final_norm"]["scale"].astype(jnp.bfloat16)})
    save_checkpoint(str(tmp_path), 3, tree, meta={"note": "x"})
    loaded, meta = bridge.load_checkpoint(str(tmp_path), 3)
    assert meta == {"step": 3, "note": "x"}
    got = bridge.params_from_numpy(loaded, cfgs[1], device="cpu")
    assert got["final_norm"]["scale"].dtype == torch.bfloat16
    expect = np.asarray(tree["final_norm"]["scale"].astype(jnp.float32))
    np.testing.assert_array_equal(got["final_norm"]["scale"].float().numpy(), expect)
    for r in range(2):
        for name, leaf in got["seg0"]["b0"][r]["attn"].items():
            np.testing.assert_array_equal(leaf.numpy(), np_params["seg0"]["b0"]["attn"][name][r])


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 5)).astype(np.int32)
    out = rope.apply_rope(*_t(x, pos), 1_000_000.0)
    _close(out, jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0), 1e-5)


def test_norm_and_mlp_match_jax(models):
    _, _, _, tparams, np_params = models
    x = np.random.default_rng(2).normal(size=(2, 3, 256)).astype(np.float32)
    layer_np = jax.tree.map(lambda a: a[0], np_params["seg0"]["b0"])
    layer = tparams["seg0"]["b0"][0]
    _close(norm.apply(layer["norm1"], _t(x)[0]), jnorm.apply(layer_np["norm1"], jnp.asarray(x)), 1e-5)
    _close(mlp.apply(layer["mlp"], _t(x)[0]), jmlp.apply(layer_np["mlp"], jnp.asarray(x)), 1e-5)


def test_embedding_and_logits_match_jax(models, cfgs):
    """Token ids out of range behave as jnp.take does: -1 wraps to the last
    row, ids past either end give NaN rows."""
    _, jparams, _, tparams, _ = models
    jcfg, tcfg = cfgs
    v = jcfg.padded_vocab
    tokens = np.asarray([[0, 7, v - 1, -1, v, -v - 1]], np.int32)
    out = embedding.embed(tparams["embed"], _t(tokens)[0], tcfg)
    expect = np.asarray(jemb.embed(jparams["embed"], jnp.asarray(tokens), jcfg))
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(expect))
    _close(np.nan_to_num(out.numpy()), np.nan_to_num(expect))
    x = np.random.default_rng(3).normal(size=(2, 1, 256)).astype(np.float32)
    _close(embedding.logits(tparams["embed"], _t(x)[0], tcfg),
           jemb.logits(jparams["embed"], jnp.asarray(x), jcfg))


def test_paged_write_edges_match_jax():
    """A position past the table clamps to its last entry; a table entry
    outside the pool is dropped by JAX and sent to scratch page 0 here, so
    every page but the scratch page agrees."""
    rng = np.random.default_rng(4)
    leaf = rng.normal(size=(6, 4, 2, 8)).astype(np.float32)
    val = rng.normal(size=(2, 3, 2, 8)).astype(np.float32)
    table = np.asarray([[1, 2], [3, 9]], np.int32)  # page 9 is outside the pool
    positions = np.asarray([[0, 5, 13], [2, 6, 7]], np.int32)  # 13 // 4 = 3 > last entry
    expect = np.asarray(jattn._paged_write(*(jnp.asarray(a) for a in (leaf, val, table, positions))))
    got = _t(leaf)[0]
    attention._paged_write(got, *_t(val, table, positions))
    np.testing.assert_array_equal(got.numpy()[1:], expect[1:])


@pytest.fixture(scope="module")
def paged_case(models):
    """A prefilled pool: slot 0 holds 8 of its 9 prompt tokens in pages
    [1, 2] (two chunks of 4; page 3 is its next); slot 1 holds a 6-token
    prompt in pages [4, 5] (one chunk of 6)."""
    jmodel, jparams, tmodel, tparams, _ = models
    ps, num_pages = 4, 8
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, size=9).astype(np.int32),
               rng.integers(0, 512, size=6).astype(np.int32)]
    table = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    jcache = jmodel.init_paged_cache(num_pages, ps, 2)
    tcache = tmodel.init_paged_cache(num_pages, ps, 2, device="cpu")
    jlogits, tlogits = [], []
    for slot, start, size in ((0, 0, 4), (0, 4, 4), (1, 0, 6)):
        chunk = prompts[slot][start:start + size][None]
        jl, jcache = jmodel.prefill_chunk(
            jparams, jnp.asarray(chunk), jcache, jnp.int32(start), jnp.int32(slot),
            jnp.asarray(table[slot:slot + 1]),
        )
        tl, tcache = tmodel.prefill_chunk(
            tparams, _t(chunk)[0], tcache, start, slot, _t(table[slot:slot + 1])[0],
        )
        jlogits.append(np.asarray(jl))
        tlogits.append(tl.numpy())
    return dict(jcache=jcache, tcache=tcache, table=table, prompts=prompts,
                jlogits=jlogits, tlogits=tlogits)


def _pages(jcache, tcache, layer):
    jk = np.asarray(jcache["seg0"]["b0"]["attn"]["k"][layer].astype(jnp.float32))
    tk = tcache["seg0"]["b0"][layer]["attn"]["k"].float().numpy()
    return jk, tk


def test_prefill_chunk_logits_and_pages_match_jax(paged_case):
    assert len(paged_case["tlogits"]) == 3
    for got, expect in zip(paged_case["tlogits"], paged_case["jlogits"]):
        assert got.shape == expect.shape == (1, 1, 512)
        _close(got, expect)
    for layer in range(2):
        jk, tk = _pages(paged_case["jcache"], paged_case["tcache"], layer)
        _close(tk[1:], jk[1:], 1e-2)  # bf16 pages: one rounding of f32 values


def test_decode_step_logits_and_pages_match_jax(models, paged_case):
    """Slot 0 teacher-forces its last prompt token at position 8 (the first
    of page 3); slot 1 decodes at position 6; a third lane is inactive (an
    all-zero table row, writing scratch page 0)."""
    jmodel, jparams, tmodel, tparams, _ = models
    table = np.concatenate([paged_case["table"], np.zeros((1, 4), np.int32)])
    tokens = np.asarray([[paged_case["prompts"][0][8]], [17], [0]], np.int32)
    pos = np.asarray([8, 6, 0], np.int32)
    jl, jcache = jmodel.decode_step(jparams, jnp.asarray(tokens), paged_case["jcache"],
                                    jnp.asarray(pos), page_table=jnp.asarray(table))
    tl, tcache = tmodel.decode_step(tparams, *_t(tokens), paged_case["tcache"], *_t(pos, table))
    assert tl.shape == (3, 1, 512) and tl.dtype == torch.float32
    _close(tl[:2], np.asarray(jl)[:2])
    for layer in range(2):
        jk, tk = _pages(jcache, tcache, layer)
        _close(tk[1:], jk[1:], 1e-2)


def test_attention_decode_branch_matches_jax(models, cfgs):
    """The layer alone: one decode token per slot over random pools."""
    _, _, _, tparams, np_params = models
    jcfg, tcfg = cfgs
    layer_np = jax.tree.map(lambda a: a[0], np_params["seg0"]["b0"]["attn"])
    rng = np.random.default_rng(6)
    pools = {n: rng.normal(size=(6, 4, 2, 64)).astype(np.float32) for n in ("k", "v")}
    table = np.asarray([[1, 2, 0], [3, 4, 5]], np.int32)
    x = rng.normal(size=(2, 1, 256)).astype(np.float32)
    idx = np.asarray([5, 10], np.int32)
    jy, jc = jattn.apply(layer_np, jnp.asarray(x), jcfg, positions=jnp.asarray(idx[:, None]),
                         cache={n: jnp.asarray(p) for n, p in pools.items()},
                         cache_index=jnp.asarray(idx), page_table=jnp.asarray(table))
    tcache = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    ty, _ = attention.apply(tparams["seg0"]["b0"][0]["attn"], _t(x)[0], tcfg,
                            positions=_t(idx[:, None])[0], cache=tcache, page_table=_t(table)[0],
                            cache_index=_t(idx)[0])
    _close(ty, jy)
    for n in ("k", "v"):
        _close(tcache[n].numpy(), np.asarray(jc[n]), 1e-6)


def test_unported_blocks_raise():
    """No block kind is left to a later slice: whisper's cross-attention
    blocks, zamba2's (Mamba2, the shared attention block) and gemma2's
    soft-capped full-sequence attention each raised until their slice; now
    their logits equal JAX's (whisper's with its audio; the MoE blocks' too:
    tests/test_torch_moe.py)."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 512, (2, 9)).astype(np.int32)
    audio = rng.standard_normal((2, 64, 128)).astype(np.float32)
    for arch in ("whisper-tiny", "zamba2-2.7b", "gemma2-9b"):
        jcfg = jax_config(arch, "smoke").replace(compute_dtype="float32")
        tcfg = get_config(arch, "smoke").replace(compute_dtype="float32")
        jmodel = build_model(jcfg)
        tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0))[0])
        batch = {"tokens": tokens, **({"audio_embeds": audio} if jcfg.is_encoder_decoder else {})}
        jlogits, _ = jax.jit(jmodel.forward)(jax.tree.map(jnp.asarray, tree),
                                             {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad():
            tlogits, _ = LanguageModel(tcfg).forward(bridge.params_from_numpy(tree, tcfg, device="cpu"),
                                                     {k: torch.from_numpy(v) for k, v in batch.items()})
        _close(tlogits, jlogits)


@pytest.mark.parametrize("key,slice_name", [("audio_embeds", "whisper slice")])
def test_forward_refuses_unported_batch_inputs(models, key, slice_name):
    """Audio embeddings, which waited for the whisper slice, now reach an
    encoder-decoder model's logits, and a whisper batch without them raises
    naming them (forward and lm_loss, which takes the training batch); a
    decoder-only model reads them no more than the JAX package does."""
    from repro_torch.train.loss import lm_loss

    _, _, tmodel, tparams, _ = models
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    logits, _ = tmodel.forward(tparams, {"tokens": tokens, key: torch.zeros((1, 2, 8))})
    plain, _ = tmodel.forward(tparams, {"tokens": tokens})
    assert torch.equal(logits, plain)
    cfg = get_config("whisper-tiny", "smoke").replace(compute_dtype="float32")
    whisper = LanguageModel(cfg)
    params = whisper.init(0, device="cpu")
    audio = torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        with_audio, _ = whisper.forward(params, {"tokens": tokens, key: audio})
        other, _ = whisper.forward(params, {"tokens": tokens, key: 2 * audio})
    assert torch.isfinite(with_audio).all() and not torch.equal(with_audio, other)
    for fn in (whisper.forward, lambda p, b: lm_loss(whisper, p, b)):
        with pytest.raises(ValueError, match=key):
            fn(params, {"tokens": tokens})


@pytest.mark.parametrize("with_vision", [True, False])
def test_vision_projector_matches_jax(with_vision):
    """internvl2 smoke: with ``vision_embeds`` (B, 8, 1024) the projector's
    tanh-GELU MLP replaces the first 8 token embeddings, and the logits,
    loss, gradients (``vision_proj``'s included) and a dense prefill's
    logits equal JAX's, its bf16 KV within one bf16 ulp; on tokens alone the projector gets a zero
    gradient, as under ``jax.grad``."""
    from repro.train.loss import lm_loss as jax_lm_loss
    from repro.train.step import _grads_over_microbatches as jax_grads
    from repro_torch.train.loss import lm_loss
    from repro_torch.train.step import _grads_over_microbatches
    from repro_torch.utils.tree import tree_leaves

    jcfg = jax_config("internvl2-1b", "smoke").replace(compute_dtype="float32")
    tcfg = get_config("internvl2-1b", "smoke").replace(compute_dtype="float32")
    jmodel, tmodel = build_model(jcfg), LanguageModel(tcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0))[0])
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = bridge.params_from_numpy(tree, tcfg, device="cpu")
    assert tuple(tparams["vision_proj"]["w1"].shape) == (1024, tcfg.d_model)
    init = tmodel.init(0, device="cpu")["vision_proj"]
    assert {k: tuple(v.shape) for k, v in init.items()} == {k: v.shape for k, v in tree["vision_proj"].items()}
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 512, (2, 13)).astype(np.int32)}
    if with_vision:
        batch["vision_embeds"] = rng.standard_normal((2, tcfg.num_vision_tokens, 1024)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, _ = jax.jit(jmodel.forward)(jparams, jbatch)
    jtotal, _ = jax.jit(lambda p, b: jax_lm_loss(jmodel, p, b))(jparams, jbatch)
    with torch.no_grad():
        tlogits, _ = tmodel.forward(tparams, tbatch)
        total, _ = lm_loss(tmodel, tparams, tbatch)
    _close(tlogits, jlogits)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=TOL)

    jg, _ = jax.jit(lambda p, b: jax_grads(jmodel, p, b, 1, 0.0))(jparams, jbatch)
    leaves = tree_leaves(tparams)
    for w in leaves:
        w.requires_grad_(True)
    try:
        tg, _ = _grads_over_microbatches(tmodel, tparams, tbatch, 1, 0.0)
    finally:
        for w in leaves:
            w.requires_grad_(False)
    expect_tree = bridge.params_from_numpy(jax.tree.map(np.asarray, jg), tcfg, device="cpu")
    proj = torch.linalg.vector_norm(expect_tree["vision_proj"]["w1"])
    assert (proj > 0) == with_vision
    for got, e in zip(tg, tree_leaves(expect_tree)):
        assert torch.linalg.vector_norm(got - e) <= TOL * torch.linalg.vector_norm(e) + 1e-9

    jcache = jmodel.init_cache(2, 16, jnp.bfloat16)
    jl, jc = jax.jit(jmodel.prefill)(jparams, jbatch, jcache)
    with torch.no_grad():
        tl, tc = tmodel.prefill(tparams, tbatch, tmodel.init_cache(2, 16, torch.bfloat16, device="cpu"))
    _close(tl, jl)
    for r, layer in enumerate(tc["seg0"]["b0"]):  # bf16 KV: within one bf16 ulp of JAX's
        for n in ("k", "v"):
            np.testing.assert_allclose(layer["attn"][n].float().numpy(),
                                       np.asarray(jc["seg0"]["b0"]["attn"][n][r], np.float32),
                                       rtol=2**-7, atol=1e-6)
