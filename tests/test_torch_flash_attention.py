"""The port's flash attention (its plain versions, the CPU path of
``kernels/flash_attention/ops.py``) against the JAX package's: the forward
against ``attention_ref`` and against the Pallas kernel in interpret mode,
the backward against ``jax.vjp`` of ``attention_ref``. Inputs are made with
numpy from a seed, in f32: forward within 2e-5, gradients within 1e-4 (f32
sums taken in other orders). The CUDA kernels are held against these plain
versions on the card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

FWD_TOL = 2e-5
BWD_TOL = 1e-4

CASES = {
    # name: (b, sq, sk, hq, hkv, d, causal, window)
    "causal": (2, 16, 16, 4, 2, 8, True, None),  # GQA 4:2
    "window": (2, 16, 16, 4, 2, 8, True, 5),
    "gqa_1_1": (1, 12, 12, 4, 4, 16, True, None),
    "gqa_6_3": (1, 16, 16, 6, 3, 8, True, 6),
    "sq_lt_sk": (2, 8, 16, 4, 2, 8, True, None),
    "sq_lt_sk_window": (1, 8, 24, 4, 1, 8, True, 4),
    "not_causal": (2, 8, 8, 2, 1, 8, False, None),
}


def _inputs(case, seed=0):
    b, sq, sk, hq, hkv, d, causal, window = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    return q, k, v, do, dict(causal=causal, sliding_window=window)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    q, k, v, _, kw = _inputs(case)
    out, lse = ref.attention_fwd_ref(*_t(q, k, v), **kw)
    expect = np.asarray(jax_attention_ref(q, k, v, **kw))
    np.testing.assert_allclose(out.numpy(), expect, atol=FWD_TOL, rtol=FWD_TOL)
    interp = np.asarray(jops.flash_attention(q, k, v, interpret=True, **kw))
    np.testing.assert_allclose(out.numpy(), interp, atol=FWD_TOL, rtol=FWD_TOL)
    # the log-sum-exp the backward reads: log of the softmax denominator
    b, sq, hq, d = q.shape
    logits = np.einsum("bshd,bthd->bhst", q.astype(np.float64),
                       np.repeat(k, hq // k.shape[2], axis=2).astype(np.float64)) * d**-0.5
    mask = ref._mask(sq, k.shape[1], kw["causal"], kw["sliding_window"], "cpu").numpy()
    expect_lse = np.log(np.where(mask, np.exp(logits), 0.0).sum(-1))
    np.testing.assert_allclose(lse.numpy(), expect_lse, atol=FWD_TOL, rtol=FWD_TOL)


def test_fully_masked_row_is_zero_like_the_tpu_kernel():
    """Causal with Sq > Sk leaves the first rows with no visible key: the
    TPU kernel's max(l, 1e-30) guard (and the port's kernels) give zeros
    there, and the plain version agrees; its gradient is zero too."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 12, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
    interp = np.asarray(jops.flash_attention(q, k, v, causal=True, interpret=True))
    out, lse = ref.attention_fwd_ref(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), interp, atol=FWD_TOL, rtol=FWD_TOL)
    assert (out[:, :4] == 0).all() and torch.isneginf(lse[:, :, :4]).all()
    dq, _, _ = ref.attention_bwd_ref(*_t(q, k, v), out, lse, torch.ones_like(out), causal=True)
    assert torch.isfinite(dq).all() and (dq[:, :4] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_vjp(case):
    """The plain backward (through the autograd function, as training calls
    it) against jax.vjp of attention_ref with the same output gradient."""
    q, k, v, do, kw = _inputs(case, seed=1)
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    expect = jax.jit(jax.grad(
        lambda a, b_, c: jnp.vdot(jax_attention_ref(a, b_, c, **kw), do), argnums=(0, 1, 2)
    ))(q, k, v)
    for name, g, e in zip("qkv", got, expect):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"d{name}")


def test_cpu_path_counts_no_launch():
    q, k, v, do, kw = _inputs("causal")
    ops.reset_launches()
    ops.backward(*_t(q, k, v), *ops.forward(*_t(q, k, v), **kw), torch.from_numpy(do), **kw)
    assert ops.LAUNCHES == {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def test_reset_zeroes_the_noncausal_counts():
    """``reset_launches`` zeroes the non-causal counts with the others, and
    a non-causal call on CPU tensors raises neither."""
    q, k, v, do, kw = _inputs("not_causal")
    ops.LAUNCHES_NONCAUSAL["flash_attention_fwd"] = 3
    ops.reset_launches()
    ops.backward(*_t(q, k, v), *ops.forward(*_t(q, k, v), **kw), torch.from_numpy(do), **kw)
    assert ops.LAUNCHES_NONCAUSAL == {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
    assert ops.LAUNCHES == {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
