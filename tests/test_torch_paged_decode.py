"""The port's paged-decode kernel family against the JAX package's.

On the CPU the port's wrappers run the kernels' plain PyTorch versions;
they are held here against the JAX oracles (``paged_decode/ref.py``) and
the Pallas kernels in interpret mode (the JAX package's own CPU default),
on the same inputs made with numpy from a seed: ragged lengths, COW-shared
pages, KV ending on a page boundary, a poisoned scratch page, a one-token
slot and window/softcap. Tolerances are those of
``tests/test_paged_decode_kernel.py``: 2e-5 in float32, 2e-2 with bf16
pages. The sampler must equal ``fused_sample_ref`` and ``sample_tokens``
exactly given the same noise. ``test_torch_kernels_gpu.py`` holds the CUDA
kernels against the plain versions on the card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_decode import ops as jops  # noqa: E402
from repro.kernels.paged_decode import ref as jref  # noqa: E402
from repro.serve.step import sample_tokens as jax_sample_tokens  # noqa: E402
from repro_torch.kernels.paged_decode import ops  # noqa: E402

from _paged_inputs import paged_setup, sampler_inputs  # noqa: E402


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
