"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU or interpret mode, so every test here needs a CUDA
device and skips without one. Run them on the card with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not have; this file imports torch, numpy and the port only).
Inputs are made with numpy from a seed; pages are bf16. Attention agrees
within 2e-5 for f32 queries (f32 math on both sides) and within one bf16
ulp for bf16 queries (both sides round an f32 result to bf16: rtol 2**-7,
atol 1e-4 for values near 0); the sampler agrees exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_decode import ops, ref  # noqa: E402

from _paged_inputs import paged_setup, sampler_inputs  # noqa: E402

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


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_kernel_matches_plain(cuda, case, q_dtype, d):
    kwargs, hq = DECODE_CASES[case]
    k, v, table, pos = paged_setup(d=d, **kwargs)
    q = np.random.default_rng(1).normal(size=(len(pos), hq, d)).astype(np.float32)
    qt, kt, vt, tt, pt = _on(cuda, q, k, v, table, pos)
    qt, kt, vt = qt.to(getattr(torch, q_dtype)), kt.to(torch.bfloat16), vt.to(torch.bfloat16)
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


@pytest.mark.parametrize("seed,v,ties", [(0, 8, False), (1, 50, True), (2, 257, False),
                                         (3, 151936, False), (4, 151936, True)])
def test_sampler_kernel_matches_plain(cuda, seed, v, ties):
    logits, temp, top_k = sampler_inputs(seed, 16, v, ties)
    noise = np.random.default_rng(seed).gumbel(size=logits.shape).astype(np.float32)
    args = _on(cuda, logits, noise, temp, top_k)
    ops.reset_launches()
    np.testing.assert_array_equal(ops.fused_sample(*args).cpu().numpy(),
                                  ref.fused_sample_ref(*args).cpu().numpy())
    assert ops.LAUNCHES["fused_sample"] == 1


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
