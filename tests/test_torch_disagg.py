"""The port's disaggregated prefill/decode engine against the JAX package's
(``kernel="xla"``), on the CPU, each family's smoke config in float32 with
the JAX weights carried over by ``repro_torch.bridge``: greedy tokens, the
host stats (transfers, pages streamed and adopted, prefix reuse, chunks,
ticks, the stage history, the seam's bytes) and the memory accounting must
be equal, and the tokens must equal the port's own paged engine's. Also the
split step budgets of the two workers, the encoder-decoder refusal,
``make_disagg_submeshes``, the page export / import round trip (against
JAX's ``paged_export_slot`` / ``paged_import_slot``) and the launcher's
``--engine disagg``.

The seam's bytes are equal across the packages although the block's layout
differs (the port's per-layer ``(K, page_size, ...)`` pages and ``(1, ...)``
state rows against JAX's ``(layers, K, ...)`` and ``(layers, 1, ...)``):
both count every element once, in the cache's dtype.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_disagg_cases import (  # noqa: E402
    assert_drained,
    host_stats,
    models,
    serve,
    shared_prefix_prompts,
)

from repro.serve import DisaggregatedEngine as JaxDisagg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.launch.mesh import make_disagg_submeshes  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.serve import DisaggregatedEngine, PagedContinuousBatchingEngine  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

# JAX's ARCHS (tests/test_disagg_serve.py), then the hybrid and MoE families
ARCHS = ["qwen2.5-3b", "gemma2-9b", "rwkv6-1.6b", "zamba2-2.7b", "dbrx-132b"]
KW = dict(cache_len=64, max_slots=2, page_size=4, prefill_chunks=(4,))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, where torch's default of one thread a core oversubscribes
    the host."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("arch", ARCHS)
def test_disagg_greedy_matches_jax_and_paged(arch):
    jmodel, jparams, tmodel, tparams = models(arch)
    prompts = shared_prefix_prompts(tmodel.cfg.vocab_size, n=5)
    budgets = [5] * len(prompts)
    jax_engine = JaxDisagg(jmodel, jparams, kernel="xla", prefill_slots=2, **KW)
    engine = DisaggregatedEngine(tmodel, tparams, prefill_slots=2, device="cpu", **KW)
    paged = PagedContinuousBatchingEngine(tmodel, tparams, device="cpu", **KW)
    expect, got = serve(jax_engine, prompts, budgets), serve(engine, prompts, budgets)
    single = serve(paged, prompts, budgets)
    for i, (a, b, c) in enumerate(zip(expect, got, single)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i} against JAX's disaggregated engine")
        np.testing.assert_array_equal(b, c, err_msg=f"request {i} against the port's paged engine")
    assert host_stats(engine) == host_stats(jax_engine)
    assert engine.memory_stats() == jax_engine.memory_stats()
    # on one device both workers hold the caller's weight tensors, no copy
    assert all(a is b is c for a, b, c in zip(tree_leaves(tparams), tree_leaves(engine.prefill.params),
                                              tree_leaves(engine.decode.params)))
    # every multi-token request crossed the seam as one streamed transfer
    assert engine.stats["transfers"] == len(prompts) and engine.stats["pages_streamed"] > 0
    if engine.prefix_sharing:
        # the shared prefix is adopted decode-side by reference
        assert engine.stats["pages_adopted"] > 0 and engine.stats["prefix_tokens_reused"] > 0
    else:
        assert arch in ("rwkv6-1.6b", "zamba2-2.7b")
    assert_drained(engine)


def test_disagg_split_step_budgets():
    """tests/test_disagg_serve.py::test_disagg_split_compile_budgets, with
    "compiles" read as steps built: the decode worker builds NO chunk step
    (one decode step a ladder stage) and the prefill worker one tail tick at
    its ring width and at most one chunk step a size; serving again at known
    shapes builds nothing."""
    _, _, tmodel, tparams = models("qwen2.5-3b")
    engine = DisaggregatedEngine(tmodel, tparams, cache_len=64, max_slots=4, b1=1, rho=2.0, patience=2,
                                 page_size=4, prefill_chunks=(4, 8), prefill_slots=2, device="cpu")
    rng = np.random.default_rng(3)
    ids = [engine.submit(rng.integers(0, 512, n), max_new_tokens=4) for n in rng.integers(1, 24, size=10)]
    assert set(engine.run()) == set(ids)
    assert engine.decode._chunk_steps == {} and engine.decode.prefill_chunks == ()
    assert set(engine.decode._decodes) <= {1, 2, 4} and len(engine.decode._decodes) > 1
    assert engine.decode_compiles == len(engine.decode._decodes)
    assert engine.prefill_compiles == len(engine.prefill._chunk_steps) <= len(engine.prefill.prefill_chunks)
    assert set(engine.prefill._decodes) == {engine.prefill_slots}
    built = (engine.decode_compiles, engine.prefill_compiles, engine.prefill.decode_compiles)
    engine.submit(rng.integers(0, 512, 13), max_new_tokens=3)
    engine.run()
    assert (engine.decode_compiles, engine.prefill_compiles, engine.prefill.decode_compiles) == built


def test_disagg_rejects_encoder_decoder():
    model = LanguageModel(get_config("whisper-tiny", "smoke"))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        DisaggregatedEngine(model, model.init(seed=0, device="cpu"), cache_len=32, device="cpu")


def test_make_disagg_submeshes_validates():
    with pytest.raises(ValueError, match="must each be >= 1"):
        make_disagg_submeshes(prefill_pods=0, decode_pods=1, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match=r"need 8 devices for a \(4\+4\)x1x1 submesh pair, have 2"):
        make_disagg_submeshes(prefill_pods=4, decode_pods=4, devices=[torch.device("cpu")] * 2)


def test_make_disagg_submeshes_disjoint_pod_major():
    devices = [torch.device("cuda", i) for i in range(9)]  # no card needed to name them
    prefill, decode = make_disagg_submeshes(prefill_pods=1, decode_pods=3, data=2, devices=devices)
    assert prefill.shape == (1, 2, 1) and decode.shape == (3, 2, 1)
    assert list(prefill.flat) == devices[:2] and list(decode.flat) == devices[2:8]
    assert not set(prefill.flat) & set(decode.flat)
    assert prefill.flat[0] == torch.device("cuda", 0) and decode.flat[0] == torch.device("cuda", 2)


def _random_cache(model, num_pages, state_batch, seed):
    """A paged cache with random bf16 pages and random state rows."""
    cache = model.init_paged_cache(num_pages, 4, state_batch, device="cpu")
    gen = torch.Generator().manual_seed(seed)

    def fill(leaf):
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
        return leaf

    return model._map_paged(fill, fill, cache)


def _as_jax(model, cache):
    """The JAX package's paged cache tree from the port's: each segment's
    per-layer lists stacked on a leading ``layers`` axis (a block without a
    cache left out, as JAX leaves it out)."""
    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([layer[k] for layer in layers]) for k in layers[0]}
        out = torch.stack(layers)
        return jnp.asarray(out.float().numpy()).astype(JNP_DTYPES[out.dtype])

    return {seg: {name: stack(layers) for name, layers in blocks.items() if _leaves(layers)}
            for seg, blocks in cache.items()}


JNP_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _stacked(model, tree):
    """The port's tree with each segment's layers stacked, as float32 numpy."""
    return [np.asarray(jnp.asarray(leaf, jnp.float32)) for leaf in _leaves(_as_jax(model, tree))]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_export_import_round_trip(arch):
    """A slot's pages [3, 5, 7] and state row 1 exported from a pool of 9
    pages and imported into one of 12 at pages [2, 0, 11] (the middle lane a
    page already resident there) and row 0: the imported pages and row are
    bit-equal to the exported ones, no other page changes (page 0
    included), and the block equals JAX's ``paged_export_slot`` up to
    layout, as the imported pool equals JAX's ``paged_import_slot`` outside
    its scratch page 0."""
    jmodel, _, model, _ = models(arch)
    src, dst = _random_cache(model, 9, 2, seed=1), _random_cache(model, 12, 3, seed=2)
    before = model._map_paged(torch.clone, torch.clone, dst)
    src_ids = np.asarray([3, 5, 7, 0, 0], np.int64)
    dst_ids = np.asarray([2, 0, 11, 0, 0], np.int64)
    block = model.paged_export_slot(src, torch.from_numpy(src_ids), 1)
    jblock = jmodel.paged_export_slot(_as_jax(model, src), jnp.asarray(src_ids, jnp.int32), jnp.int32(1))
    for got, expect in zip(_stacked(model, block), [np.asarray(x, np.float32) for x in _leaves(jblock)]):
        np.testing.assert_array_equal(got, expect)
    # the block owns its memory: writing the source pool leaves it as it was
    saved = model._map_paged(torch.clone, torch.clone, block)
    model._map_paged(lambda leaf: leaf.zero_(), lambda leaf: leaf.zero_(), src)
    for a, b in zip(_leaves(block), _leaves(saved)):
        assert torch.equal(a, b)
    model.paged_import_slot(dst, block, dst_ids, 0)

    def check_pages(full, part, old):
        assert torch.equal(full[2], part[0]) and torch.equal(full[11], part[2])
        kept = [p for p in range(full.shape[0]) if p not in (2, 11)]
        assert torch.equal(full[kept], old[kept])  # page 0 and page 1's resident copy untouched
        return full

    def check_row(full, part, old):
        assert torch.equal(full[0:1], part) and torch.equal(full[1:], old[1:])
        return full

    model._map_paged(check_pages, check_row, dst, block, before)
    jdst = jmodel.paged_import_slot(_as_jax(model, before), jblock, jnp.asarray(dst_ids, jnp.int32),
                                    jnp.int32(0))
    kv = model._kv_leaves(dst)
    for got, expect in zip(_stacked(model, dst), [np.asarray(x, np.float32) for x in _leaves(jdst)]):
        if kv and got.ndim == 5 and got.shape[1] == 12:  # pages: JAX wrote its pad lanes to page 0
            got, expect = got[:, 1:], expect[:, 1:]
        np.testing.assert_array_equal(got, expect)


def test_launcher_serves_disagg_on_cpu():
    results = launcher.main(["--engine", "disagg", "--device", "cpu", "--requests", "3", "--prompt-len", "12",
                             "--shared-prefix", "8", "--new-tokens", "5", "--cache-len", "64", "--chunk", "4",
                             "--page-size", "4", "--prefill-slots", "1"])
    assert sorted(results) == [0, 1, 2]
    assert all(len(row) == 12 + 5 for row in results.values())


def test_launcher_disagg_needs_two_cards(monkeypatch, capsys):
    """Asking for the card: without CUDA the launcher raises as every engine
    does; with one card it stops naming the two devices it needs, before
    any weight is made, and never goes on to the CPU."""
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        launcher.main(["--engine", "disagg"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(LanguageModel, "init", lambda *a, **k: pytest.fail("weights made"))
    with pytest.raises(SystemExit):
        launcher.main(["--engine", "disagg"])
    assert "need 2 devices" in capsys.readouterr().err


def test_launcher_disagg_options_need_the_engine(capsys):
    with pytest.raises(SystemExit):
        launcher.main(["--engine", "paged", "--device", "cpu", "--prefill-slots", "3"])
    assert "--prefill-slots requires --engine disagg" in capsys.readouterr().err
