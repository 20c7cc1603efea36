"""The port's paged-decode kernel family against the JAX package's.

On the CPU the port's wrappers run the kernels' plain PyTorch versions;
they are held here against the JAX oracles (``paged_decode/ref.py``) and
the Pallas kernels in interpret mode (the JAX package's own CPU default),
on the same inputs made with numpy from a seed: ragged lengths, COW-shared
pages, KV ending on a page boundary, a poisoned scratch page, a one-token
slot and window/softcap. Tolerances are those of
``tests/test_paged_decode_kernel.py``: 2e-5 in float32, 2e-2 with bf16
pages. The sampler must equal ``fused_sample_ref`` and ``sample_tokens``
exactly given the same noise. The plain versions that follow the bf16
kernels step for step (``paged_decode_split_ref``, ``paged_prefill_tiled_ref``)
are held to the same oracles at 2e-5 across the kernels' split, window, page
size and group edges, and the sampler's (``fused_sample_split_ref``) to
them exactly, over slices that do not divide V, V not a multiple of 4, top_k
from 0 past V, mass ties at the k-th largest, a row of -inf and a
temperature of 1e-8. ``test_torch_kernels_gpu.py`` holds the CUDA kernels
against the plain versions on the card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_decode import ops as jops  # noqa: E402
from repro.kernels.paged_decode import ref as jref  # noqa: E402
from repro.serve.step import sample_tokens as jax_sample_tokens  # noqa: E402
from repro_torch.kernels.paged_decode import kernel, ops, ref  # noqa: E402

from _paged_inputs import paged_lengths_setup, paged_setup, sampler_inputs  # noqa: E402


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(out, expect, tol):
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(expect, np.float32), atol=tol, rtol=tol
    )


DECODE_CASES = {
    # name: (setup kwargs, query heads)
    "ragged": (dict(seed=1, slots=5, ps=4, mp=4, hkv=2, d=16), 4),
    "cow_shared": (dict(seed=2, slots=4, ps=4, mp=4, hkv=2, d=16, share=True), 4),
    "gqa_6_3": (dict(seed=3, slots=3, ps=3, mp=4, hkv=3, d=16), 6),
    "mha": (dict(seed=4, slots=2, ps=8, mp=3, hkv=4, d=32), 4),
    "poisoned_scratch": (dict(seed=5, slots=3, ps=4, mp=4, hkv=2, d=16, poison=True), 4),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_jax(case):
    kwargs, hq = DECODE_CASES[case]
    k, v, table, pos = paged_setup(**kwargs)
    q = np.random.default_rng(kwargs["seed"] + 100).normal(size=(len(pos), hq, kwargs["d"]))
    q = q.astype(np.float32)
    out = ops.paged_flash_decode(*_t(q, k, v, table, pos))
    _close(out, jref.paged_attention_ref(*_j(q, k, v, table, pos)), 2e-5)
    _close(out, jops.paged_flash_decode(*_j(q, k, v, table, pos)), 2e-5)  # Pallas, interpret
    assert np.isfinite(out.numpy()).all()


def test_decode_page_boundary_and_one_token_slot():
    """Slot 0 ends exactly on a page boundary (later entries are scratch 0);
    slot 1 holds a single token at position 0 and must return its value."""
    ps, hkv, d = 4, 2, 16
    rng = np.random.default_rng(11)
    k = rng.normal(size=(5, ps, hkv, d)).astype(np.float32)
    v = rng.normal(size=(5, ps, hkv, d)).astype(np.float32)
    table = np.asarray([[1, 2, 0, 0], [3, 0, 0, 0]], np.int32)
    pos = np.asarray([2 * ps - 1, 0], np.int32)
    q = rng.normal(size=(2, 4, d)).astype(np.float32)
    out = ops.paged_flash_decode(*_t(q, k, v, table, pos))
    _close(out, jref.paged_attention_ref(*_j(q, k, v, table, pos)), 2e-5)
    _close(out, jops.paged_flash_decode(*_j(q, k, v, table, pos)), 2e-5)
    _close(out[1], np.repeat(v[3, 0], 2, axis=0), 2e-5)


@pytest.mark.parametrize("window,softcap", [(5, None), (None, 30.0), (7, 30.0)])
def test_decode_window_softcap(window, softcap):
    k, v, table, pos = paged_setup(6, slots=3, ps=4, mp=4, hkv=2, d=32)
    q = np.random.default_rng(7).normal(size=(3, 4, 32)).astype(np.float32)
    kw = dict(sliding_window=window, softcap=softcap)
    out = ops.paged_flash_decode(*_t(q, k, v, table, pos), **kw)
    _close(out, jref.paged_attention_ref(*_j(q, k, v, table, pos), **kw), 2e-5)
    _close(out, jops.paged_flash_decode(*_j(q, k, v, table, pos), **kw), 2e-5)


def test_decode_bf16_pages():
    k, v, table, pos = paged_setup(8, slots=2, ps=4, mp=3, hkv=2, d=16)
    q = np.random.default_rng(9).normal(size=(2, 4, 16)).astype(np.float32)
    kt, vt = [x.to(torch.bfloat16) for x in _t(k, v)]
    out = ops.paged_flash_decode(_t(q)[0].to(torch.bfloat16), kt, vt, *_t(table, pos))
    assert out.dtype == torch.bfloat16
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    qj = jnp.asarray(q, jnp.bfloat16)
    expect = jref.paged_attention_ref(qj, kj, vj, *_j(table, pos))
    _close(out.float(), expect, 2e-2)


@pytest.mark.parametrize("chunk,window,softcap", [(1, None, None), (4, None, None), (8, None, None),
                                                  (4, 3, None), (4, None, 20.0)])
def test_chunk_prefill_plain_matches_jax(chunk, window, softcap):
    k, v, table, pos = paged_setup(10 + chunk, slots=3, ps=4, mp=4, hkv=2, d=16, share=True,
                                    poison=True)
    pos_start = np.maximum(pos - (chunk - 1), 0).astype(np.int32)
    q = np.random.default_rng(12).normal(size=(3, chunk, 4, 16)).astype(np.float32)
    kw = dict(sliding_window=window, softcap=softcap)
    out = ops.paged_chunk_prefill(*_t(q, k, v, table, pos_start), **kw)
    _close(out, jref.paged_prefill_ref(*_j(q, k, v, table, pos_start), **kw), 2e-5)
    _close(out, jops.paged_chunk_prefill(*_j(q, k, v, table, pos_start), **kw), 2e-5)


def test_chunk_prefill_bf16_pages():
    k, v, table, pos = paged_setup(13, slots=2, ps=4, mp=4, hkv=2, d=16)
    pos_start = np.maximum(pos - 3, 0).astype(np.int32)
    q = np.random.default_rng(14).normal(size=(2, 4, 4, 16)).astype(np.float32)
    kt, vt = [x.to(torch.bfloat16) for x in _t(k, v)]
    out = ops.paged_chunk_prefill(_t(q)[0].to(torch.bfloat16), kt, vt, *_t(table, pos_start))
    kj, vj, qj = (jnp.asarray(x, jnp.bfloat16) for x in (k, v, q))
    _close(out.float(), jref.paged_prefill_ref(qj, kj, vj, *_j(table, pos_start)), 2e-2)


# ---------------------------------------------------------------------------
# the bf16 kernels' passes, step for step (ref.paged_decode_split_ref and
# ref.paged_prefill_tiled_ref), in f32: 16-key chunks through the table,
# decode splits of two chunks (more in a table wider than 8,192 positions)
# merged in order, prefill tiles of 32 rows with four warps dealing the chunks
# ---------------------------------------------------------------------------

SPLIT_CASES = {
    # name: (lengths, ps, mp, hkv, G, d, window, softcap, share)
    "fills_splits_exactly": ([64, 32], 16, 5, 2, 8, 64, None, None, False),
    "ragged_splits": ([50, 17, 33], 16, 4, 2, 7, 128, None, None, True),
    "one_token_slot": ([1, 40], 8, 6, 1, 2, 64, None, None, False),
    "window_inside_a_split": ([70, 45], 16, 5, 2, 1, 64, 20, None, False),
    "window_skips_splits": ([140, 100], 16, 9, 1, 8, 64, 10, None, True),
    "softcap": ([37, 60], 4, 16, 2, 2, 128, None, 30.0, False),
    "pages_straddle_chunks": ([29, 44], 3, 16, 2, 8, 64, 25, 20.0, True),
    # 9,600 positions: 150 splits of four chunks, walked by two warps in turn
    "wide_table": ([2100, 40], 16, 600, 1, 2, 64, 70, None, True),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_decode_split_passes_match_jax(case):
    lengths, ps, mp, hkv, group, d, window, softcap, share = SPLIT_CASES[case]
    k, v, table, pos = paged_lengths_setup(sorted(SPLIT_CASES).index(case), lengths=lengths, ps=ps, hkv=hkv, d=d, mp=mp, share=share)
    q = np.random.default_rng(3).normal(size=(len(lengths), hkv * group, d)).astype(np.float32)
    kw = dict(sliding_window=window, softcap=softcap)
    partials = []
    out = ref.paged_decode_split_ref(*_t(q, k, v, table, pos), **kw, partials=partials)
    assert np.isfinite(out.numpy()).all()
    _close(out, jref.paged_attention_ref(*_j(q, k, v, table, pos), **kw), 2e-5)
    _close(out, jops.paged_flash_decode(*_j(q, k, v, table, pos), **kw), 2e-5)  # Pallas, interpret
    _close(out, ref.paged_attention_ref(*_t(q, k, v, table, pos), **kw), 2e-5)
    # the live splits are those holding a visible key: from the split of the
    # first visible chunk to that of the last
    split_keys = kernel.decode_layout(mp, ps)[0] * kernel.CHUNK_KEYS
    for b, n in enumerate(lengths):
        first = max(n - window, 0) if window else 0
        live = sorted({s for (bb, h, s, *_) in partials if bb == b and h == 0})
        assert live == list(range(first // split_keys, (n - 1) // split_keys + 1))


@pytest.mark.parametrize("max_pages,ps", [(0, 16), (1, 1), (5, 3), (128, 16), (512, 16), (513, 16),
                                          (600, 16), (2048, 16), (300, 32)])
def test_decode_layout_covers_the_table_in_at_most_256_splits(max_pages, ps):
    split_chunks, nsplit = kernel.decode_layout(max_pages, ps)
    chunks = -(-max_pages * ps // kernel.CHUNK_KEYS)
    assert split_chunks % kernel.DECODE_KEY_GROUPS == 0 and 1 <= nsplit <= kernel.MAX_DECODE_SPLITS
    assert nsplit * split_chunks >= chunks > (nsplit - 1) * split_chunks or chunks == 0
    # the fewest chunks a split: one stage fewer would need more splits than allowed
    if split_chunks > kernel.DECODE_KEY_GROUPS:
        assert -(-chunks // (split_chunks - kernel.DECODE_KEY_GROUPS)) > kernel.MAX_DECODE_SPLITS


def test_split_without_visible_key_adds_exactly_zero():
    """A warp (or split) whose chunk holds no key its rows may see leaves
    (EMPTY, 0, 0); merging it changes no bit and makes no NaN."""
    k, v, table, pos = paged_lengths_setup(5, lengths=[40], ps=16, hkv=1, d=64, mp=4)
    kt, vt, tt = _t(k, v, table)
    q = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 64)).astype(np.float32))
    qlim, qwin = torch.full((4,), 39), torch.full((4,), 19)  # window 20 at position 39

    def chunk_kv(c):
        return ref._chunk_kv(kt, vt, tt[0], 0, c, 20, 39)

    empty = ref.walk_chunks(q, qlim, qwin, chunk_kv, [0], 64**-0.5, None)  # keys 0-15: none visible
    assert (empty[0] == ref.EMPTY).all() and (empty[1] == 0).all() and (empty[2] == 0).all()
    seen = ref.walk_chunks(q, qlim, qwin, chunk_kv, [1, 2], 64**-0.5, None)
    for parts in ([seen, empty], [empty, seen]):
        merged = ref.merge_partials(parts)
        assert all(torch.isfinite(x).all() for x in merged)
        assert torch.equal(merged[0], seen[0]) and torch.equal(merged[1], seen[1])
        assert torch.equal(merged[2], seen[2])


PREFILL_TILE_CASES = {
    # name: (lengths, chunk, ps, mp, hkv, G, d, window, softcap)
    "g8_d64": ([70, 40], 24, 16, 5, 2, 8, 64, None, None),
    "g7_d128_window": ([60, 33], 16, 16, 4, 1, 7, 128, 20, None),
    "g2_softcap_straddle": ([45, 30], 9, 3, 16, 2, 2, 64, None, 30.0),
    "g1_one_row": ([19, 1], 1, 4, 5, 2, 1, 128, None, None),
}


@pytest.mark.parametrize("case", sorted(PREFILL_TILE_CASES))
def test_prefill_tile_walk_matches_jax(case):
    lengths, chunk, ps, mp, hkv, group, d, window, softcap = PREFILL_TILE_CASES[case]
    k, v, table, pos = paged_lengths_setup(7, lengths=lengths, ps=ps, hkv=hkv, d=d, mp=mp, share=True)
    pos_start = np.maximum(pos - (chunk - 1), 0).astype(np.int32)
    q = np.random.default_rng(8).normal(size=(len(lengths), chunk, hkv * group, d)).astype(np.float32)
    kw = dict(sliding_window=window, softcap=softcap)
    out = ref.paged_prefill_tiled_ref(*_t(q, k, v, table, pos_start), **kw)
    assert np.isfinite(out.numpy()).all()
    _close(out, jref.paged_prefill_ref(*_j(q, k, v, table, pos_start), **kw), 2e-5)
    _close(out, jops.paged_chunk_prefill(*_j(q, k, v, table, pos_start), **kw), 2e-5)
    _close(out, ref.paged_prefill_ref(*_t(q, k, v, table, pos_start), **kw), 2e-5)


# ---------------------------------------------------------------------------
# the sampler: exact, given the same noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,v,ties", [(0, 8, False), (1, 50, True), (2, 257, False), (3, 257, True)])
def test_sampler_matches_sample_tokens_and_ref(seed, v, ties):
    b = 16
    logits, temp, top_k = sampler_inputs(seed, b, v, ties)
    key = jax.random.key(seed)
    noise = np.asarray(jax.random.gumbel(key, (b, v), jnp.float32))  # sample_tokens' own draw
    out = ops.fused_sample(*_t(logits, noise, temp, top_k)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_sample_tokens(*_j(logits), key, *_j(temp, top_k))))
    np.testing.assert_array_equal(out, np.asarray(jref.fused_sample_ref(*_j(logits, noise, temp, top_k))))
    assert out.dtype == np.int32


def test_sampler_greedy_ties_to_first_index():
    logits = np.random.default_rng(20).normal(size=(4, 64)).astype(np.float32)
    logits[0] = 0.0
    logits[1, 5] = logits[1, 9] = logits[1].max() + 1
    zeros = np.zeros(4, np.float32)
    out = ops.fused_sample(*_t(logits, np.ones_like(logits), zeros, np.zeros(4, np.int32)))
    np.testing.assert_array_equal(out.numpy(), [0, 5, logits[2].argmax(), logits[3].argmax()])


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sampler_duplicate_kth_value(k):
    """Duplicates exactly at the k-th largest value are all kept, as
    sort-descending[k - 1] keeps them."""
    logits = np.asarray([[1.0, 5.0, 5.0, 5.0, 2.0, 0.0]] * 4, np.float32)
    temp = np.full(4, 0.9, np.float32)
    top_k = np.full(4, k, np.int32)
    for s in range(4):
        key = jax.random.key(s)
        noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
        out = ops.fused_sample(*_t(logits, noise, temp, top_k)).numpy()
        np.testing.assert_array_equal(
            out, np.asarray(jax_sample_tokens(jnp.asarray(logits), key, *_j(temp, top_k)))
        )


def _split_rows(kind, b, v, seed):
    """(logits, temperature, top_k) of b rows: gaussian ("normal"),
    integers 0-3 ("ties"; with 16 rows, rows 1, 5 all equal, row 9 all -inf
    and row 13 -inf in its first half), all equal ("equal") or all -inf
    ("neginf"); top_k running over 0, 1, 2, 5, 50, V - 1, V, V + 7 and
    temperatures over sampled, 1e-8 and greedy."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, v)) * 4).astype(np.float32)
    if kind == "ties":
        logits = rng.integers(0, 4, size=(b, v)).astype(np.float32)
        if b >= 16:
            logits[[1, 5]] = 1.5
            logits[9] = -np.inf
            logits[13, : v // 2] = -np.inf
    elif kind == "equal":
        logits[:] = 1.5
    elif kind == "neginf":
        logits[:] = -np.inf
    top_k = np.resize(np.asarray([0, 1, 2, 5, 50, v - 1, v, v + 7], np.int32), b)
    temp = np.resize(np.asarray([0.8, 1e-8, 1.0, 0.0, 0.3, 1.5, 0.7], np.float32), b)
    return logits, temp, top_k


def _hold_split_sampler(logits, temp, top_k, splits, seed):
    key = jax.random.key(seed)
    noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))  # sample_tokens' own draw
    out = ref.fused_sample_split_ref(*_t(logits, noise, temp, top_k), splits).numpy()
    np.testing.assert_array_equal(out, np.asarray(jref.fused_sample_ref(*_j(logits, noise, temp, top_k))))
    np.testing.assert_array_equal(out, np.asarray(jax_sample_tokens(*_j(logits), key, *_j(temp, top_k))))
    assert out.dtype == np.int32


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("v", [8, 50, 257, 4099])
@pytest.mark.parametrize("splits", [1, 2, 7, 32])
def test_split_sampler_plain_matches_jax(splits, v, kind):
    """The kernel's slices, per-slice candidates and merge, step for step,
    equal JAX's sampler on 16 rows."""
    _hold_split_sampler(*_split_rows(kind, 16, v, seed=v + splits), splits, seed=splits)


@pytest.mark.parametrize("k", [0, 1, 2, 5, 50, 4098, 4099, 4106])
@pytest.mark.parametrize("kind", ["normal", "ties", "equal", "neginf"])
def test_split_sampler_plain_one_row(kind, k):
    """One row (a request's first token) over 32 slices of 132 values."""
    logits, _, _ = _split_rows(kind, 1, 4099, seed=k)
    _hold_split_sampler(logits, np.asarray([0.8], np.float32), np.asarray([k], np.int32), 32, seed=k)


@pytest.mark.parametrize("b,v", [(1, 8), (1, 4099), (1, 8192), (8, 65536), (1, 151936), (8, 151936),
                                 (16, 151936), (300, 262144)])
def test_sampler_layout(b, v):
    """Slices of a multiple of 4 and at most SAMPLE_MAX_SLICE values cover
    the row, none empty; every row of V >= 8,192 takes more than one block,
    and at a batch of one the grid covers the card's 132 SMs once a row
    has 132 slices of SAMPLE_MIN_SLICE values."""
    slice_len, splits = kernel.sample_layout(b, v)
    assert slice_len % 4 == 0 and slice_len <= kernel.SAMPLE_MAX_SLICE
    assert (splits - 1) * slice_len < v <= splits * slice_len
    assert kernel.sample_slices(v, splits) == (slice_len, splits)
    if v >= 8192:
        assert splits > 1
    if v >= 132 * kernel.SAMPLE_MIN_SLICE:
        assert b * splits >= 132


# ---------------------------------------------------------------------------
# the wrappers: CPU path, launch counters, other devices
# ---------------------------------------------------------------------------

def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    k, v, table, pos = paged_setup(30, slots=2, ps=4, mp=2, hkv=1, d=8)
    q = np.zeros((2, 2, 8), np.float32)
    ops.paged_flash_decode(*_t(q, k, v, table, pos))
    ops.paged_chunk_prefill(*_t(q[:, None], k, v, table, pos))
    ops.fused_sample(*_t(np.zeros((2, 4), np.float32), np.zeros((2, 4), np.float32),
                         np.zeros(2, np.float32), np.zeros(2, np.int32)))
    assert ops.LAUNCHES == {"paged_flash_decode": 0, "paged_chunk_prefill": 0, "fused_sample": 0}


def test_other_devices_are_refused():
    q = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="run on cuda"):
        ops.paged_flash_decode(q, q, q, q, q)
