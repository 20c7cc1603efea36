"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU or interpret mode, so every test here needs a CUDA
device and skips without one. Run them on the card with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not have; this file imports torch, numpy and the port only).
Inputs are made with numpy from a seed; pages are bf16. Attention agrees
within 2e-5 for f32 queries (f32 math on both sides; the CUDA-core kernels)
and within one bf16 ulp for bf16 queries (both sides round an f32 result to
bf16: rtol 2**-7, atol 1e-4 for values near 0; the tensor-core kernels,
whose decode splits a slot's keys over blocks and merges the splits in a
fixed order, so two calls give the same bits); the sampler agrees exactly
with the plain version and with its step-for-step version (the kernel's
slices, candidates and merge), at batch 1, 8 and 16, V 8 to 151,936, top_k
up to 40,000, mass ties, rows of -inf and rows off a 16-byte boundary.
The split and tile cases cover slots that fill their splits exactly and
ones that do not, one-token slots, windows that begin inside a split or
skip whole splits, page sizes that straddle the 16-key chunks, G from 1 to
16 (G 6 and 7 at the MoE family's serving shape too), D 64, 80 (zamba2's shared attention; bf16 queries only: the f32 route
refuses it by name), 128 and 256, and grids of more blocks than the card
has SMs.

The training kernels: flash attention's forward agrees as paged attention
does; its backward within 1e-5 of the tensor's largest value (f32) or two
bf16 ulps plus 1e-3 of that value (bf16: dS = P (dP - Di) cancels, so an
element near zero carries the f32 error of the tensor's scale), and is the
same bit for bit from run to run. f32 inputs take the CUDA-core kernels,
bf16 inputs the tensor-core ones, which also take D 80 (the f32 ones
refuse it by name); the cases include the MoE family's shapes (dbrx-132b
training, B 4, S 513, 48/8 heads; arctic-480b's static prefill, B 8, S
512, 56/8) and whisper-tiny's (the encoder non-causal at B 4, S 1500, 6/6
heads of 64; the decoder causal at S 448). The paged kernels run at
whisper's G 1, D 64 too. The fused pSGD, momentum and AdaGrad-DA
(nu = 1 and 1/2) updates equal their plain versions bit for bit, also over
the ResNets' many small leaves; for other
nu the kernel's powf may differ from torch.pow by a few ulps (rtol 1e-6).

Chunked GLA: the forward and the backward against the plain recurrence
(and its autograd), within 1e-4 of each output's largest value plus 1e-4
relative for f32 inputs (chunked sums in another order than the scan's,
and the fast exp), one bf16 ulp (y) or two (dq, dk, dv) plus 1e-3 of the
largest value for bf16 inputs; the backward is the same bit for bit from
run to run. f32 inputs take the CUDA-core kernels, bf16 inputs the
chunk-parallel tensor-core passes; the cases cover S across the 16-row
sub-chunk and 64-position chunk edges, strong decay, more (batch, head,
chunk) blocks than the card has SMs, and Mamba2's own inputs (80 heads, C
and B shared by every head, a decay per head from zamba2's A_log and dt,
the current token included).

The sharded runs' NCCL exchange (``distributed/nccl.py``, one card a
worker): on two or four cards, the shard gather, the partials' exchange and
the move onto rank 0 give the shared host slots' bits (skips with fewer
than two cards: NCCL refuses two ranks on one card).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.fused_optim import ops as optim_ops  # noqa: E402
from repro_torch.kernels.fused_optim import ref as optim_ref  # noqa: E402
from repro_torch.kernels.gla import ops as gla_ops  # noqa: E402
from repro_torch.kernels.gla import ref as gla_ref  # noqa: E402
from repro_torch.kernels.paged_decode import kernel, ops, ref  # noqa: E402

from _paged_inputs import paged_lengths_setup, paged_setup, sampler_inputs  # noqa: E402

pytestmark = pytest.mark.gpu

DECODE_CASES = {
    # name: (setup kwargs, query heads)
    "ragged": (dict(seed=1, slots=5, ps=4, mp=4, hkv=2), 4),
    "cow_shared": (dict(seed=2, slots=4, ps=4, mp=4, hkv=2, share=True), 4),
    "gqa_6_3": (dict(seed=3, slots=3, ps=16, mp=4, hkv=3), 6),
    "gqa_8_1": (dict(seed=4, slots=8, ps=16, mp=8, hkv=1), 8),
    "poisoned_scratch": (dict(seed=5, slots=3, ps=4, mp=4, hkv=2, poison=True), 4),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _on(device, *arrays):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


BF16_ULP = dict(atol=1e-4, rtol=2.0**-7)


def _close(out, expect, atol, rtol):
    np.testing.assert_allclose(out.float().cpu().numpy(), expect.float().cpu().numpy(),
                               atol=atol, rtol=rtol)


def _refused_by_name(q_dtype, d):
    """The f32 routes hold a row as D / 32 or D / 64 columns a thread and take
    no D 80: there the wrapper must raise, naming the width."""
    if q_dtype == "float32" and d == 80:
        return pytest.raises(ValueError, match="head_dim 80 is outside")
    return None


@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_kernel_matches_plain(cuda, case, q_dtype, d):
    kwargs, hq = DECODE_CASES[case]
    k, v, table, pos = paged_setup(d=d, **kwargs)
    q = np.random.default_rng(1).normal(size=(len(pos), hq, d)).astype(np.float32)
    qt, kt, vt, tt, pt = _on(cuda, q, k, v, table, pos)
    qt, kt, vt = qt.to(getattr(torch, q_dtype)), kt.to(torch.bfloat16), vt.to(torch.bfloat16)
    refused = _refused_by_name(q_dtype, d)
    if refused is not None:
        with refused:
            ops.paged_flash_decode(qt, kt, vt, tt, pt)
        return
    tol = dict(atol=2e-5, rtol=2e-5) if q_dtype == "float32" else BF16_ULP
    ops.reset_launches()
    for kw in (dict(), dict(sliding_window=5, softcap=30.0)):
        out = ops.paged_flash_decode(qt, kt, vt, tt, pt, **kw)
        assert out.dtype == qt.dtype and out.shape == qt.shape
        _close(out, ref.paged_attention_ref(qt, kt, vt, tt, pt, **kw), **tol)
    assert ops.LAUNCHES["paged_flash_decode"] == 2


@pytest.mark.parametrize("chunk", [1, 4, 16, 64])
def test_chunk_prefill_kernel_matches_plain(cuda, chunk):
    k, v, table, pos = paged_setup(40, slots=3, ps=16, mp=8, hkv=2, d=128, share=True, poison=True)
    pos_start = np.maximum(pos - (chunk - 1), 0).astype(np.int32)
    q = np.random.default_rng(41).normal(size=(3, chunk, 16, 128)).astype(np.float32)
    qt, kt, vt, tt, pt = _on(cuda, q, k, v, table, pos_start)
    kt, vt = kt.to(torch.bfloat16), vt.to(torch.bfloat16)
    ops.reset_launches()
    for kw in (dict(), dict(sliding_window=3, softcap=20.0)):
        out = ops.paged_chunk_prefill(qt, kt, vt, tt, pt, **kw)
        _close(out, ref.paged_prefill_ref(qt, kt, vt, tt, pt, **kw), atol=2e-5, rtol=2e-5)
    assert ops.LAUNCHES["paged_chunk_prefill"] == 2


SPLIT_CASES = {
    # name: (lengths, ps, mp, hkv, G)
    "fills_splits_exactly": ([64, 32, 96], 16, 8, 2, 8),
    # 64 splits x 2 kv heads x 8 slots: 1,024 blocks, more than the card's SMs
    "ragged_long": ([1100, 544, 1, 300, 17, 33, 64, 595], 16, 128, 2, 8),
    "g16": ([200, 45, 1], 16, 16, 2, 16),
    "g1_mha": ([77, 130], 16, 16, 4, 1),
    "g7_pages_straddle_chunks": ([29, 44, 3], 3, 20, 1, 7),
    "g2_small_pages": ([37, 60], 4, 16, 2, 2),
    # 16,384 positions: 256 splits of four chunks, each walked in two stages
    "wide_table": ([12000, 33, 2100, 1], 16, 1024, 2, 8),
}


def _split_case(device, case, q_dtype, d, chunk=None):
    """A prefill chunk ends at each slot's last token, and each slot holds at
    least a chunk, as in the engine: no row sees scratch page 0 unmasked
    (where its 1e4 keys would make f32 scores cancel beyond 2e-5)."""
    lengths, ps, mp, hkv, group = SPLIT_CASES[case]
    if chunk is not None:
        lengths = [max(n, chunk) for n in lengths]
    k, v, table, pos = paged_lengths_setup(sorted(SPLIT_CASES).index(case), lengths=lengths, ps=ps, hkv=hkv,
                                           d=d, mp=mp, share=True)
    if chunk is not None:
        pos = (pos - (chunk - 1)).astype(np.int32)
    shape = (len(lengths), hkv * group, d) if chunk is None else (len(lengths), chunk, hkv * group, d)
    q = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    qt, kt, vt, tt, pt = _on(device, q, k, v, table, pos)
    return qt.to(getattr(torch, q_dtype)), kt.to(torch.bfloat16), vt.to(torch.bfloat16), tt, pt


# windows: none, one that begins inside a split, one that skips whole splits
SPLIT_KWARGS = (dict(), dict(sliding_window=20, softcap=30.0), dict(sliding_window=70))


@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_decode_split_edges_match_plain(cuda, case, q_dtype, d):
    qt, kt, vt, tt, pt = _split_case(cuda, case, q_dtype, d)
    refused = _refused_by_name(q_dtype, d)
    if refused is not None:
        with refused:
            ops.paged_flash_decode(qt, kt, vt, tt, pt)
        return
    tol = dict(atol=2e-5, rtol=2e-5) if q_dtype == "float32" else BF16_ULP
    for kw in SPLIT_KWARGS:
        out = ops.paged_flash_decode(qt, kt, vt, tt, pt, **kw)
        assert out.dtype == qt.dtype and out.shape == qt.shape
        _close(out, ref.paged_attention_ref(qt, kt, vt, tt, pt, **kw), **tol)


@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,chunk", [("fills_splits_exactly", 32), ("ragged_long", 256), ("g16", 37),
                                        ("g16", 1), ("g1_mha", 64), ("g7_pages_straddle_chunks", 3),
                                        ("g2_small_pages", 1), ("wide_table", 64)])
def test_chunk_prefill_tiles_match_plain(cuda, case, chunk, q_dtype, d):
    """ragged_long at C 256: 8 x 2 x 64 tiles of 32 rows, 1,024 blocks."""
    qt, kt, vt, tt, pt = _split_case(cuda, case, q_dtype, d, chunk=chunk)
    refused = _refused_by_name(q_dtype, d)
    if refused is not None:
        with refused:
            ops.paged_chunk_prefill(qt, kt, vt, tt, pt)
        return
    tol = dict(atol=2e-5, rtol=2e-5) if q_dtype == "float32" else BF16_ULP
    for kw in SPLIT_KWARGS:
        out = ops.paged_chunk_prefill(qt, kt, vt, tt, pt, **kw)
        assert out.dtype == qt.dtype and out.shape == qt.shape
        _close(out, ref.paged_prefill_ref(qt, kt, vt, tt, pt, **kw), **tol)


# the MoE family's attention: query heads over 8 kv heads of 128
MOE_GROUPS = {"g6_dbrx": 48, "g7_arctic": 56}


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("case", sorted(MOE_GROUPS))
def test_paged_kernels_at_the_moe_groups_match_plain(cuda, case, kind):
    """The MoE family's serving shape: 8 slots of 544 positions whose first
    16 pages hold one shared 256-token prefix, G 6 (dbrx-132b) and G 7
    (arctic-480b); decode one token a slot, or a 256-token chunk at
    pos_start 256 and 288 (its 32-row tiles hold the heads of 5 1/3 or
    4 4/7 tokens, so rows straddle tokens); the same bits twice."""
    hq = MOE_GROUPS[case]
    k, v, table, pos = paged_lengths_setup(hq, lengths=[544] * 8, ps=16, hkv=8, d=128, mp=128)
    table[1:, :16] = table[0, :16]
    rng = np.random.default_rng(hq + 1)
    if kind == "decode":
        q = rng.normal(size=(8, hq, 128)).astype(np.float32)
        fn, plain = ops.paged_flash_decode, ref.paged_attention_ref
    else:
        q = rng.normal(size=(2, 256, hq, 128)).astype(np.float32)
        table, pos = table[:2], np.array([256, 288], np.int32)
        fn, plain = ops.paged_chunk_prefill, ref.paged_prefill_ref
    qt, kt, vt, tt, pt = _on(cuda, q, k, v, table, pos)
    qt, kt, vt = qt.to(torch.bfloat16), kt.to(torch.bfloat16), vt.to(torch.bfloat16)
    out = fn(qt, kt, vt, tt, pt)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, plain(qt, kt, vt, tt, pt), **BF16_ULP)
    assert torch.equal(out, fn(qt, kt, vt, tt, pt))


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_paged_kernels_at_whisper_shape_match_plain(cuda, kind):
    """whisper-tiny's decoder: 6 query heads over 6 kv heads of 64 (G 1);
    decode one token in each of 8 slots of 228 and 100 positions (a prompt
    of 132 or 4 and 96 new tokens), or a 64-token chunk at pos_start 0 and
    64; bf16 within a bf16 ulp, f32 within 2e-5; the same bits twice."""
    k, v, table, pos = paged_lengths_setup(6, lengths=[228, 100] * 4, ps=16, hkv=6, d=64, mp=28)
    rng = np.random.default_rng(7)
    if kind == "decode":
        q = rng.normal(size=(8, 6, 64)).astype(np.float32)
        fn, plain = ops.paged_flash_decode, ref.paged_attention_ref
    else:
        q = rng.normal(size=(2, 64, 6, 64)).astype(np.float32)
        table, pos = table[[0, 2]], np.array([0, 64], np.int32)  # two slots of 228
        fn, plain = ops.paged_chunk_prefill, ref.paged_prefill_ref
    for dtype, tol in ((torch.float32, dict(atol=2e-5, rtol=2e-5)), (torch.bfloat16, BF16_ULP)):
        qt, kt, vt, tt, pt = _on(cuda, q, k, v, table, pos)
        qt = qt.to(dtype)
        kt, vt = kt.to(torch.bfloat16), vt.to(torch.bfloat16)
        out = fn(qt, kt, vt, tt, pt)
        assert out.dtype == dtype and out.shape == qt.shape
        _close(out, plain(qt, kt, vt, tt, pt), **tol)
        assert torch.equal(out, fn(qt, kt, vt, tt, pt))


def test_decode_layout_matches_the_library(cuda):
    """kernel.decode_layout, which the step-for-step plain version follows,
    splits a table as the library does: the scratch sizes agree."""
    for mp, ps in [(0, 16), (1, 1), (5, 3), (128, 16), (512, 16), (513, 16), (2048, 16), (300, 32)]:
        nsplit = kernel.decode_layout(mp, ps)[1]
        assert kernel.decode_scratch_floats(3, 16, 128, mp, ps) == 3 * 16 * nsplit * (128 + 2)


@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_bf16_paged_kernels_give_the_same_bits_twice(cuda, d):
    for case, chunk in (("ragged_long", None), ("ragged_long", 256), ("wide_table", None)):
        qt, kt, vt, tt, pt = _split_case(cuda, case, "bfloat16", d, chunk=chunk)
        fn = ops.paged_flash_decode if chunk is None else ops.paged_chunk_prefill
        for kw in SPLIT_KWARGS[:2]:
            assert torch.equal(fn(qt, kt, vt, tt, pt, **kw), fn(qt, kt, vt, tt, pt, **kw))


def _sampler_rows(kind, b, v, k, seed):
    """(logits, temperature, top_k) of b rows: gaussian ("normal"), integers
    0-3 ("ties"), all equal ("equal") or all -inf ("neginf"). One row is
    sampled at t = 0.8 with top_k k; of 8 rows, row 0 is greedy, row 3 at
    t = 1e-8, row 2 keeps every logit (top_k 0) and row 6 too (V + 7)."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, v)) * 4).astype(np.float32)
    if kind == "ties":
        logits = rng.integers(0, 4, size=(b, v)).astype(np.float32)
    elif kind == "equal":
        logits[:] = 1.5
    elif kind == "neginf":
        logits[:] = -np.inf
    temp = np.full(b, 0.8, np.float32)
    top_k = np.full(b, k, np.int32)
    if b == 8:
        temp[[0, 3, 5, 7]] = [0.0, 1e-8, 0.5, 1.0]
        top_k[[2, 6]] = [0, v + 7]
    return logits, temp, top_k


def _hold_sampler(args, splits=None):
    """The kernel's tokens (through ops, one launch) against fused_sample_ref
    and fused_sample_split_ref (the kernel's own slices) exactly; the
    counters are back at 0 after the call."""
    logits, noise, temp, top_k = args
    b, v = logits.shape
    ops.reset_launches()
    got = ops.fused_sample(*args)
    assert ops.LAUNCHES["fused_sample"] == 1
    splits = splits or kernel.sample_layout(b, v)[1]
    expect = ref.fused_sample_ref(*args).cpu().numpy()
    np.testing.assert_array_equal(got.cpu().numpy(), expect)
    np.testing.assert_array_equal(ref.fused_sample_split_ref(*args, splits).cpu().numpy(), expect)
    for _, counters in kernel._SAMPLE_BUFFERS.values():
        assert int(counters.abs().sum()) == 0
    return got


SAMPLER_CARD_CASES = [
    # (seed, b, v, kind, top_k); None: sampler_inputs' rows, top_k over 0, 1, 2, 5, V, V + 7
    (0, 16, 8, "normal", None), (1, 16, 50, "ties", None), (2, 16, 257, "normal", None),
    (3, 16, 151936, "normal", None), (4, 16, 151936, "ties", None),
    (5, 1, 151936, "normal", 50), (6, 1, 151936, "ties", 1000), (7, 1, 65536, "normal", 40000),
    (8, 8, 151936, "normal", 50), (9, 8, 151936, "normal", 1000), (10, 8, 151936, "ties", 40000),
    (11, 8, 65536, "normal", 50), (12, 8, 65536, "ties", 1000), (13, 1, 65536, "equal", 50),
    (14, 8, 151936, "equal", 1000), (15, 8, 151936, "neginf", 50), (16, 1, 151936, "neginf", 40000),
    # the MoE family's vocabularies: dbrx-132b's 100,352 and arctic-480b's 32,000
    (17, 8, 100352, "normal", 50), (18, 8, 100352, "ties", 1000), (19, 8, 32000, "normal", 50),
]


@pytest.mark.parametrize("seed,b,v,kind,k", SAMPLER_CARD_CASES)
def test_sampler_kernel_matches_plain(cuda, seed, b, v, kind, k):
    if k is None:
        logits, temp, top_k = sampler_inputs(seed, b, v, kind == "ties")
    else:
        logits, temp, top_k = _sampler_rows(kind, b, v, k, seed)
    noise = np.random.default_rng(seed).gumbel(size=logits.shape).astype(np.float32)
    _hold_sampler(_on(cuda, logits, noise, temp, top_k))


@pytest.mark.parametrize("b,v", [(8, 151936), (1, 65536), (8, 4099)])
def test_sampler_rows_off_a_16_byte_boundary(cuda, b, v):
    """(B, V) views that start one float into their buffers (and V = 4,099,
    not a multiple of 4) take the one-value-at-a-time route."""
    logits, temp, top_k = _sampler_rows("normal", b, v, 50, seed=v)
    noise = np.random.default_rng(v).gumbel(size=logits.shape).astype(np.float32)
    views = []
    for a in (logits, noise):
        buf = torch.empty(b * v + 1, device=cuda)
        buf[1:] = torch.from_numpy(a).reshape(-1).to(cuda)
        views.append(buf[1:].view(b, v))
    assert views[0].data_ptr() % 16 == 4 and views[0].is_contiguous()
    _hold_sampler((*views, *_on(cuda, temp, top_k)))


def test_sampler_calls_in_a_row_agree(cuda):
    """A call, another of another shape, then the first again: equal
    tokens, so what a call leaves in the counters and scratch is clean."""
    sets = []
    for b, v, k in ((8, 151936, 50), (1, 151936, 1000)):
        logits, temp, top_k = _sampler_rows("normal", b, v, k, seed=b)
        noise = np.random.default_rng(b).gumbel(size=logits.shape).astype(np.float32)
        sets.append(_on(cuda, logits, noise, temp, top_k))
    first = _hold_sampler(sets[0])
    _hold_sampler(sets[1])
    assert torch.equal(_hold_sampler(sets[0]), first)
    assert torch.equal(ops.fused_sample(*sets[0]), first)


def test_sampler_layout_matches_the_library(cuda):
    """kernel.sample_layout, which the step-for-step plain version follows,
    cuts rows as the library does; every row of V >= 8,192 takes more than
    one block."""
    for b in (1, 2, 8, 16, 300):
        for v in (1, 8, 4099, 8192, 65536, 151936, 262144):
            assert kernel.sample_splits(b, v) == kernel.sample_layout(b, v)[1]
            assert kernel.sample_layout(b, v)[1] > 1 or v < 8192


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((2, 4, 48), device=cuda)  # head_dim 48
    pages = torch.zeros((3, 4, 2, 48), device=cuda, dtype=torch.bfloat16)
    table = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    pos = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_flash_decode(q, pages, pages, table, pos)
    with pytest.raises(ValueError, match="must be on"):
        ops.paged_flash_decode(torch.zeros((2, 4, 64), device=cuda), pages.cpu(), pages.cpu(), table, pos)
    f32_pages = torch.zeros((3, 4, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.paged_flash_decode(torch.zeros((2, 4, 64), device=cuda), f32_pages, f32_pages, table, pos)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.paged_chunk_prefill(torch.zeros((2, 1, 4, 64), device=cuda), f32_pages, f32_pages, table, pos)


FLASH_CASES = {
    # name: (b, sq, sk, hq, hkv, d, causal, window). The bf16 kernels cut Sq
    # and Sk into 64-row tiles right-aligned to their ends, so S runs over
    # every alignment: 1 (Sq = Sk = 1 has identically zero dQ and dK, which a
    # tolerance scaled to the gradient cannot read, so one query over 65
    # keys, whose first key tile holds one key), 63, 64, 65, 127, 128, 129
    # and 513.
    "ragged_causal": (2, 77, 77, 4, 2, 64, True, None),
    "window": (2, 130, 130, 6, 3, 64, True, 17),
    "gqa_1_1": (1, 65, 65, 4, 4, 128, True, None),
    "gqa_8_1": (2, 100, 100, 8, 1, 128, True, None),
    "sq_lt_sk": (2, 50, 129, 4, 2, 128, True, 40),
    "fully_masked_rows": (1, 70, 50, 4, 2, 128, True, None),
    "not_causal": (2, 33, 33, 4, 1, 64, False, None),
    "full_width": (4, 513, 513, 16, 2, 128, True, None),
    "s1": (2, 1, 65, 8, 1, 128, True, None),
    "s63": (1, 63, 63, 4, 1, 64, True, None),
    "s64": (2, 64, 64, 8, 1, 128, True, None),
    "s127_window_100": (1, 127, 127, 2, 2, 64, True, 100),
    "s128_not_causal": (1, 128, 128, 4, 4, 128, False, None),
    "s129": (1, 129, 129, 8, 1, 64, True, None),
    "s513_window_100": (1, 513, 513, 8, 1, 128, True, 100),
    # D 80: zamba2's shared attention at its training shape, and ragged edges
    "d80_zamba2": (4, 513, 513, 32, 32, 80, True, None),
    "d80_ragged_gqa": (2, 77, 77, 4, 2, 80, True, None),
    "d80_window": (1, 130, 130, 2, 1, 80, True, 17),
    "d80_sq_lt_sk": (2, 50, 129, 4, 4, 80, True, 40),
    # the MoE family: dbrx-132b's training shape (G 6) and arctic-480b's
    # static prefill (G 7)
    "g6_dbrx": (4, 513, 513, 48, 8, 128, True, None),
    "g7_arctic": (8, 512, 512, 56, 8, 128, True, None),
    # whisper-tiny: the encoder's self-attention (non-causal, 1,500 frames =
    # 23 x 64 + 28: a ragged last tile) and the decoder's (causal, 448)
    "whisper_encoder": (4, 1500, 1500, 6, 6, 64, False, None),
    "whisper_decoder": (4, 448, 448, 6, 6, 64, True, None),
}


def _flash_inputs(device, case, dtype, seed=0):
    b, sq, sk, hq, hkv, d, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))]
    return [t.to(dtype) for t in _on(device, *arrays)], dict(causal=causal, sliding_window=window)


def _close_to_scale(out, expect, rtol, scale_tol):
    out, expect = out.float().cpu().numpy(), expect.float().cpu().numpy()
    np.testing.assert_allclose(out, expect, rtol=rtol, atol=scale_tol * np.abs(expect).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_plain(cuda, case, dtype):
    dt = getattr(torch, dtype)
    (q, k, v, d_out), kw = _flash_inputs(cuda, case, dt)
    refused = _refused_by_name(dtype, q.shape[-1])
    if refused is not None:
        with refused:
            flash_ops.forward(q, k, v, **kw)
        return
    flash_ops.reset_launches()
    out, lse = flash_ops.forward(q, k, v, **kw)
    expect, expect_lse = flash_ref.attention_fwd_ref(q, k, v, **kw)
    assert out.dtype == dt and out.shape == q.shape
    _close(out, expect, **(dict(atol=2e-5, rtol=2e-5) if dtype == "float32" else BF16_ULP))
    finite = torch.isfinite(expect_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    _close(lse[finite], expect_lse[finite], atol=1e-5, rtol=1e-5)
    grads = flash_ops.backward(q, k, v, out, lse, d_out, **kw)
    expect_grads = flash_ref.attention_bwd_ref(q, k, v, out, lse, d_out, **kw)
    for g, e in zip(grads, expect_grads):
        assert g.dtype == dt and g.shape == e.shape and torch.isfinite(g).all()
        if dtype == "float32":
            _close_to_scale(g, e, rtol=1e-5, scale_tol=1e-5)
        else:
            _close_to_scale(g, e, rtol=2.0**-6, scale_tol=1e-3)
    again = flash_ops.backward(q, k, v, out, lse, d_out, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again)), "backward is not deterministic"
    assert flash_ops.LAUNCHES == {"flash_attention_fwd": 1, "flash_attention_bwd": 2}
    noncausal = 0 if kw["causal"] else 1
    assert flash_ops.LAUNCHES_NONCAUSAL == {"flash_attention_fwd": noncausal, "flash_attention_bwd": 2 * noncausal}


def test_flash_attention_autograd_on_the_card(cuda):
    (q, k, v, d_out), kw = _flash_inputs(cuda, "window", torch.float32, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_ops.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, d_out)
    expect, lse = flash_ref.attention_fwd_ref(q, k, v, **kw)
    for g, e in zip(grads, flash_ref.attention_bwd_ref(q, k, v, expect, lse, d_out, **kw)):
        _close_to_scale(g, e, rtol=1e-5, scale_tol=1e-5)


def _leaves(device, sizes, seed, positive=False):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    return _on(device, *[np.abs(a) if positive else a for a in arrays])


# ragged leaf sizes around the kernel's 2,048-element blocks, an empty leaf,
# and one leaf of many blocks, in one table
LEAF_SIZES = [1, 2047, 2048, 2049, 0, 77, 5 * 2048 + 3, 1 << 20]


@pytest.mark.parametrize("name", ["psgd", "momentum", "adagrad_da", "adagrad_da_nu_half",
                                  "adagrad_da_nu_other"])
def test_fused_updates_match_plain(cuda, name):
    w, g, a, z = (_leaves(cuda, LEAF_SIZES, seed) for seed in range(4))
    s2 = _leaves(cuda, LEAF_SIZES, 4, positive=True)
    ws = [x.clone() for x in w]
    optim_ops.reset_launches()
    if name == "psgd":
        states = [x.clone() for x in a]
        optim_ops.psgd_update(ws, g, states, lr=0.3, gamma=1e4)
        expect = [(optim_ref.psgd_ref(*x, lr=0.3, gamma=1e4),) for x in zip(w, g, a)]
        got = [(x,) for x in ws]
    elif name == "momentum":
        states = [x.clone() for x in a]
        optim_ops.momentum_update(ws, g, states, lr=0.3, beta=0.9)
        expect = [optim_ref.momentum_ref(*x, lr=0.3, beta=0.9) for x in zip(w, g, a)]
        got = list(zip(ws, states))
    else:
        nu = {"adagrad_da": 1.0, "adagrad_da_nu_half": 0.5, "adagrad_da_nu_other": 0.7}[name]
        zs, s2s = [x.clone() for x in z], [x.clone() for x in s2]
        optim_ops.adagrad_da_update(ws, g, a, zs, s2s, lr=0.3, delta=0.5, nu=nu)
        expect = [optim_ref.adagrad_da_ref(*x, lr=0.3, delta=0.5, nu=nu) for x in zip(w, g, a, z, s2)]
        got = list(zip(ws, zs, s2s))
    for x, y in zip(got, expect):
        for u, e in zip(x, y):
            if name == "adagrad_da_nu_other":
                _close(u, e, atol=1e-6, rtol=1e-6)
            else:
                assert torch.equal(u, e), f"{name}: {(u - e).abs().max().item()}"
    assert sum(optim_ops.LAUNCHES.values()) == 1


def _resnet_leaf_sizes():
    """The element counts of ResNet-20's leaves (width 16, 3 blocks a stage)
    and of Fig. 3's narrower one (width 8, 2 blocks a stage): convolutions,
    GroupNorm scales and biases of 8 to 64 elements, the 10-element head
    bias."""
    from repro_torch.models import vision
    from repro_torch.utils.tree import tree_leaves

    sizes = []
    for cfg in (vision.VisionConfig(), vision.VisionConfig(width=8, blocks_per_stage=2, image_size=16)):
        sizes += [w.numel() for w in tree_leaves(vision.init(0, cfg, device="cpu"))]
    return sizes


@pytest.mark.parametrize("name", ["psgd", "momentum", "adagrad_da"])
def test_fused_updates_over_resnet_leaves_match_plain(cuda, name):
    """One launch over every leaf of the two ResNets, bit for bit against
    the plain versions leaf by leaf."""
    sizes = _resnet_leaf_sizes()
    w, g, a, z = (_leaves(cuda, sizes, seed) for seed in range(10, 14))
    s2 = _leaves(cuda, sizes, 14, positive=True)
    ws = [x.clone() for x in w]
    optim_ops.reset_launches()
    if name == "psgd":
        states = [x.clone() for x in a]
        optim_ops.psgd_update(ws, g, states, lr=0.15, gamma=1e4)
        expect = [(optim_ref.psgd_ref(*x, lr=0.15, gamma=1e4),) for x in zip(w, g, a)]
        got = [(x,) for x in ws]
    elif name == "momentum":
        states = [x.clone() for x in a]
        optim_ops.momentum_update(ws, g, states, lr=0.05, beta=0.9)
        expect = [optim_ref.momentum_ref(*x, lr=0.05, beta=0.9) for x in zip(w, g, a)]
        got = list(zip(ws, states))
    else:
        zs, s2s = [x.clone() for x in z], [x.clone() for x in s2]
        optim_ops.adagrad_da_update(ws, g, a, zs, s2s, lr=0.08, delta=1.0, nu=1.0)
        expect = [optim_ref.adagrad_da_ref(*x, lr=0.08, delta=1.0, nu=1.0) for x in zip(w, g, a, z, s2)]
        got = list(zip(ws, zs, s2s))
    for x, y in zip(got, expect):
        for u, e in zip(x, y):
            assert torch.equal(u, e), f"{name}: {(u - e).abs().max().item()}"
    assert sum(optim_ops.LAUNCHES.values()) == 1


def test_training_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.fused_optim import kernel as optim_kernel

    q = torch.zeros((1, 8, 4, 64), device=cuda)
    kv = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="must be on"):
        flash_kernel.flash_attention_fwd(q.cpu(), kv.cpu(), kv.cpu())
    with pytest.raises(ValueError, match="head_dim"):
        flash_kernel.flash_attention_fwd(torch.zeros((1, 8, 4, 96), device=cuda),
                                         torch.zeros((1, 8, 2, 96), device=cuda),
                                         torch.zeros((1, 8, 2, 96), device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_kernel.flash_attention_fwd(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="like q"):
        flash_kernel.flash_attention_fwd(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash_kernel.flash_attention_fwd(q.transpose(1, 2), kv, kv)
    w = [torch.zeros(10, device=cuda)]
    with pytest.raises(ValueError, match="must be on"):
        optim_kernel.psgd_(w, [torch.zeros(10)], w, lr=0.1, gamma=1.0, denom=1.1)
    with pytest.raises(ValueError, match="float32"):
        optim_kernel.momentum_([torch.zeros(10, device=cuda, dtype=torch.bfloat16)], w, w,
                               lr=0.1, beta=0.9)
    with pytest.raises(ValueError, match="sizes differ"):
        optim_kernel.psgd_(w, [torch.zeros(11, device=cuda)], w, lr=0.1, gamma=1.0, denom=1.1)


GLA_CASES = {
    # name: (b, s, h, include_current, bonus, initial state[, strong decay])
    "rwkv6_ragged": (2, 150, 3, False, True, True),
    "rwkv6_no_state": (1, 64, 2, False, True, False),
    "mamba2_style": (2, 130, 2, True, False, True),
    "short": (3, 5, 2, False, True, True),
    "training_shape": (4, 513, 32, False, True, False),
    # S across the 16-row sub-chunk and the chunk edges
    "s15": (2, 15, 3, False, True, True),
    "s16": (1, 16, 2, True, False, True),
    "s17": (2, 17, 2, False, True, False),
    "s63": (1, 63, 2, True, False, False),
    "s65": (2, 65, 3, False, True, True),
    # log_w -30 a step on every fifth channel: exp(-W) overflows within a chunk
    "strong_decay": (2, 150, 3, False, True, True, True),
    # 3 x 12 x 5 = 180 (batch, head, chunk) blocks a pass, more than the 132 SMs
    "many_chunks": (3, 300, 12, False, True, True),
}


def _gla_inputs(device, case, dtype, seed=0):
    """Decays from RWKV6's range: log_w = -exp(b + noise), b from -6 to -1
    across channels (strong decay included)."""
    b, s, h, inc, bonus, init, *strong = GLA_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, dy = (rng.standard_normal((b, s, h, 64)).astype(np.float32) for _ in range(4))
    lw = -np.exp(np.linspace(-6, -1, 64) + 0.5 * rng.standard_normal((b, s, h, 64))).astype(np.float32)
    if strong:
        lw[..., ::5] = -30.0
    u = 0.5 * rng.standard_normal((h, 64)).astype(np.float32)
    s0 = 0.3 * rng.standard_normal((b, h, 64, 64)).astype(np.float32)
    d_final = rng.standard_normal((b, h, 64, 64)).astype(np.float32)
    q, k, v, dy, lw, u, s0, d_final = _on(device, q, k, v, dy, lw, u, s0, d_final)
    q, k, v, dy = (t.to(dtype) for t in (q, k, v, dy))
    return (q, k, v, lw, u if bonus else None, s0 if init else None, dy, d_final), inc


def _gla_tol(dtype, grad=False):
    if dtype == torch.float32:
        return dict(rtol=1e-4, scale_tol=1e-4)
    return dict(rtol=2.0**-6 if grad else 2.0**-7, scale_tol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GLA_CASES))
def test_gla_matches_plain(cuda, case, dtype):
    dt = getattr(torch, dtype)
    (q, k, v, lw, u, s0, dy, d_final), inc = _gla_inputs(cuda, case, dt)
    gla_ops.reset_launches()
    y, final, states = gla_ops.forward(q, k, v, lw, u, s0, include_current=inc, save_states=True)
    expect_y, expect_final = gla_ref.gla_fwd_ref(q, k, v, lw, bonus_u=u, include_current=inc,
                                                 initial_state=s0)
    assert y.dtype == dt and y.shape == v.shape and final.dtype == torch.float32
    _close_to_scale(y, expect_y, **_gla_tol(dt))
    _close_to_scale(final, expect_final, **_gla_tol(torch.float32))
    grads = gla_ops.backward(q, k, v, lw, u, s0, states, final, dy, d_final, include_current=inc)
    expect = gla_ref.gla_bwd_ref(q, k, v, lw, u, s0, dy, d_final, include_current=inc)
    for name, g, e in zip(("dq", "dk", "dv", "dlog_w", "du", "ds0"), grads, expect):
        if e is None:  # no bonus: no du; no initial state: its gradient is not asked for
            assert (name == "du" and g is None) or (name == "ds0" and s0 is None)
            continue
        assert g.dtype == e.dtype and g.shape == e.shape and torch.isfinite(g).all(), name
        _close_to_scale(g, e, **_gla_tol(g.dtype, grad=True))
    again = gla_ops.backward(q, k, v, lw, u, s0, states, final, dy, d_final, include_current=inc)
    assert all(a is None or torch.equal(a, b) for a, b in zip(grads, again)), "not deterministic"
    assert gla_ops.LAUNCHES == {"gla_fwd": 1, "gla_bwd": 2}


def _mamba2_gla_inputs(device, b, s, seed=0, heads=80, steep=1.0):
    """GLA as Mamba2 drives it at zamba2-2.7b's width: q = C and k = B
    shared by every head, v = dt x, and the head's log decay -softplus(dt)
    exp(A_log) on every k channel, A_log = log(linspace(1, 16, heads)) as
    initialized (``steep`` multiplies it: a steeper planted decay)."""
    rng = np.random.default_rng(seed)
    c, bm = (rng.standard_normal((b, s, 1, 64)).astype(np.float32) for _ in range(2))
    dtp = np.log1p(np.exp(rng.standard_normal((b, s, heads)).astype(np.float32)))
    a = np.linspace(1.0, 16.0, heads, dtype=np.float32) * steep
    lw = np.broadcast_to((-dtp * a)[..., None], (b, s, heads, 64)).copy()
    v = (rng.standard_normal((b, s, heads, 64)) * dtp[..., None]).astype(np.float32)
    dy = rng.standard_normal((b, s, heads, 64)).astype(np.float32)
    s0 = 0.3 * rng.standard_normal((b, heads, 64, 64)).astype(np.float32)
    d_final = rng.standard_normal((b, heads, 64, 64)).astype(np.float32)
    q, k = (np.broadcast_to(x, (b, s, heads, 64)).copy() for x in (c, bm))
    return _on(device, q, k, v, lw, s0, dy, d_final)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("steep", [1.0, 8.0])
def test_gla_at_mamba2_decay_matches_plain(cuda, dtype, steep):
    """zamba2's decays reach -16 softplus(dt) a step, so a chunk's cumulative
    log decay runs to -1e2 .. -1e3 (x8 planted): outputs and gradients stay
    finite (underflow to 0 is right, a NaN from 0 x inf is not) and within
    the file's GLA tolerances."""
    dt = getattr(torch, dtype)
    q, k, v, lw, s0, dy, d_final = _mamba2_gla_inputs(cuda, 2, 200, steep=steep)
    q, k, v, dy = (t.to(dt) for t in (q, k, v, dy))
    y, final, states = gla_ops.forward(q, k, v, lw, None, s0, include_current=True, save_states=True)
    expect_y, expect_final = gla_ref.gla_fwd_ref(q, k, v, lw, include_current=True, initial_state=s0)
    assert torch.isfinite(y).all() and torch.isfinite(final).all()
    _close_to_scale(y, expect_y, **_gla_tol(dt))
    _close_to_scale(final, expect_final, **_gla_tol(torch.float32))
    grads = gla_ops.backward(q, k, v, lw, None, s0, states, final, dy, d_final, include_current=True)
    expect = gla_ref.gla_bwd_ref(q, k, v, lw, None, s0, dy, d_final, include_current=True)
    for name, g, e in zip(("dq", "dk", "dv", "dlog_w", "du", "ds0"), grads, expect):
        if e is None:
            assert g is None, name
            continue
        assert torch.isfinite(g).all(), name
        _close_to_scale(g, e, **_gla_tol(g.dtype, grad=True))


def test_gla_autograd_on_the_card(cuda):
    (q, k, v, lw, u, s0, dy, d_final), inc = _gla_inputs(cuda, "rwkv6_ragged", torch.float32, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, lw, u, s0)]
    y, final = gla_ops.gla_chunked(*leaves[:4], bonus_u=leaves[4], include_current=inc,
                                   initial_state=leaves[5])
    grads = torch.autograd.grad((y, final), leaves, (dy, d_final))
    expect = gla_ref.gla_bwd_ref(q, k, v, lw, u, s0, dy, d_final, include_current=inc)
    for g, e in zip(grads, expect):
        _close_to_scale(g, e, rtol=1e-4, scale_tol=1e-4)


def test_gla_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.gla import kernel as gla_kernel

    x = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="must be on"):
        gla_kernel.gla_fwd(x.cpu(), x, x, x, include_current=True)
    with pytest.raises(ValueError, match="64"):
        y = torch.zeros((1, 8, 2, 32), device=cuda)
        gla_kernel.gla_fwd(y, y, y, y, include_current=True)
    with pytest.raises(ValueError, match="like q"):
        gla_kernel.gla_fwd(x, x.bfloat16(), x, x, include_current=True)
    with pytest.raises(ValueError, match="log_w must be float32"):
        gla_kernel.gla_fwd(x.bfloat16(), x.bfloat16(), x.bfloat16(), x.bfloat16(), include_current=True)
    with pytest.raises(ValueError, match="contiguous"):
        gla_kernel.gla_fwd(x.transpose(1, 2), x, x, x, include_current=True)


def test_nccl_exchange_keeps_the_host_slots_bits(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more: NCCL refuses two ranks on one card")
    from _torch_dist_cases import exchange_worker

    world = 4 if torch.cuda.device_count() >= 4 else 2
    torch.multiprocessing.spawn(exchange_worker, args=(world, str(tmp_path), "nccl", True), nprocs=world, join=True)
    assert all((tmp_path / f"ok_{r}").exists() for r in range(world))


def test_remat_policies_give_the_same_bits_on_the_card(cuda):
    """qwen2.5-3b smoke in bf16 through the flash kernels: the loss and
    every gradient under dots_saveable, dots_no_batch and
    save_block_outputs equal nothing_saveable's bit for bit, and the flash
    forward runs twice a layer (the forward and its recomputation) under
    every policy: no policy keeps a tensor from inside a kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.train.step import _grads_over_microbatches
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config("qwen2.5-3b", "smoke")
    params = LanguageModel(cfg).init(0, device=cuda)
    for w in tree_leaves(params):
        w.requires_grad_(True)
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64), generator=gen).to(torch.int32).to(cuda)}
    runs = {}
    for policy in ("nothing_saveable", "dots_saveable", "dots_no_batch", "save_block_outputs"):
        flash_ops.reset_launches()
        grads, metrics = _grads_over_microbatches(LanguageModel(cfg.replace(remat_policy=policy)), params, batch,
                                                  1, 0.0)
        assert flash_ops.LAUNCHES["flash_attention_fwd"] == 2 * cfg.num_layers
        assert flash_ops.LAUNCHES["flash_attention_bwd"] == cfg.num_layers
        runs[policy] = (metrics["loss"].detach(), [g.detach() for g in grads])
    loss, grads = runs.pop("nothing_saveable")
    for policy, (other_loss, other) in runs.items():
        assert torch.equal(other_loss, loss), policy
        assert all(torch.equal(a, b) for a, b in zip(other, grads, strict=True)), policy
