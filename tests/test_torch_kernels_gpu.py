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

The training kernels: flash attention's forward agrees as paged attention
does; its backward within 1e-5 of the tensor's largest value (f32) or two
bf16 ulps plus 1e-3 of that value (bf16: dS = P (dP - Di) cancels, so an
element near zero carries the f32 error of the tensor's scale), and is the
same bit for bit from run to run. f32 inputs take the CUDA-core kernels,
bf16 inputs the tensor-core ones. The fused pSGD, momentum and AdaGrad-DA
(nu = 1 and 1/2) updates equal their plain versions bit for bit; for other
nu the kernel's powf may differ from torch.pow by a few ulps (rtol 1e-6).

Chunked GLA: the forward and the backward against the plain recurrence
(and its autograd), within 1e-4 of each output's largest value plus 1e-4
relative for f32 inputs (chunked sums in another order than the scan's,
and the fast exp), one bf16 ulp (y) or two (dq, dk, dv) plus 1e-3 of the
largest value for bf16 inputs; the backward is the same bit for bit from
run to run.
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
    # name: (b, s, h, include_current, bonus, initial state)
    "rwkv6_ragged": (2, 150, 3, False, True, True),
    "rwkv6_no_state": (1, 64, 2, False, True, False),
    "mamba2_style": (2, 130, 2, True, False, True),
    "short": (3, 5, 2, False, True, True),
    "training_shape": (4, 513, 32, False, True, False),
}


def _gla_inputs(device, case, dtype, seed=0):
    """Decays from RWKV6's range: log_w = -exp(b + noise), b from -6 to -1
    across channels (strong decay included)."""
    b, s, h, inc, bonus, init = GLA_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, dy = (rng.standard_normal((b, s, h, 64)).astype(np.float32) for _ in range(4))
    lw = -np.exp(np.linspace(-6, -1, 64) + 0.5 * rng.standard_normal((b, s, h, 64))).astype(np.float32)
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
