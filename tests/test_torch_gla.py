"""The port's chunked gated linear attention (``kernels/gla``) on the CPU,
where it runs its plain version, against the JAX package: the forward
against ``gla_ref`` (the exact recurrence) and ``gla_chunked`` (the Pallas
kernel in interpret mode), in both readout modes, with and without the
RWKV6 bonus and an initial state; a sequence that is not a multiple of any
chunk (against ``gla_ref`` only: the TPU grid asserts divisibility); a
strong-decay case; and all six gradients (q, k, v, log_w, u, initial state)
against ``jax.vjp`` of ``gla_ref``, through the port's autograd function.

The chunked plain versions (``gla_fwd_chunked_ref``, ``gla_bwd_chunked_ref``:
the CUDA kernels' passes step for step, 64-position chunks cut into 16-row
sub-chunks) against the same oracles, over S in {1, 15, 16, 17, 63, 64, 65,
130} (every sub-chunk and chunk edge), both readout modes, with and without
the bonus and an initial state, and a strong-decay case (log_w -30 a step on
some channels, where a factorisation through the chunk start overflows);
every exponent they evaluate is <= 0.

Inputs are made with numpy from a seed. Tolerance: f32, atol 5e-5 and
rtol 5e-4, the JAX tests' own bound for the kernel against the oracle
(the same sums in another order); gradients 5e-5 of each gradient's
largest value plus rtol 5e-4. Every test runs the port with torch's
intra-op threads pinned to one (and restored after), so that its sums take
one order whatever else the process runs beside it.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.gla.ops import gla_chunked as jax_gla_chunked  # noqa: E402
from repro.kernels.gla.ref import gla_ref  # noqa: E402
from repro_torch.kernels.gla import ops, ref  # noqa: E402

ATOL, RTOL = 5e-5, 5e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


CASES = [
    # (b, s, h, K, V, include_current, bonus, initial state, chunk of the JAX kernel)
    (2, 64, 2, 16, 16, True, False, False, 32),   # mamba2-style
    (1, 64, 3, 16, 32, False, True, False, 32),   # rwkv6-style
    (2, 32, 2, 16, 16, True, False, True, 16),
    (1, 48, 2, 8, 8, False, True, True, 16),
]


def _inputs(b, s, h, kd, vd, bonus, init, seed=0, decay=2.0):
    rng = np.random.default_rng(seed)
    q = 0.5 * rng.standard_normal((b, s, h, kd)).astype(np.float32)
    k = 0.5 * rng.standard_normal((b, s, h, kd)).astype(np.float32)
    v = 0.5 * rng.standard_normal((b, s, h, vd)).astype(np.float32)
    lw = (-decay * np.abs(rng.standard_normal((b, s, h, kd)))).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, kd))).astype(np.float32) if bonus else None
    s0 = (0.2 * rng.standard_normal((b, h, kd, vd))).astype(np.float32) if init else None
    return q, k, v, lw, u, s0


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(out, expect, atol=ATOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(expect, np.float32),
                               atol=atol, rtol=RTOL)


def _port(q, k, v, lw, u, s0, inc):
    with torch.no_grad():
        y, final = ops.gla_chunked(*_torch(q, k, v, lw), bonus_u=_torch(u)[0], include_current=inc,
                                   initial_state=_torch(s0)[0])
    return y.numpy(), final.numpy()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_forward_matches_jax_ref_and_pallas_kernel(case):
    b, s, h, kd, vd, inc, bonus, init, chunk = case
    q, k, v, lw, u, s0 = _inputs(b, s, h, kd, vd, bonus, init)
    y, final = _port(q, k, v, lw, u, s0, inc)
    jq, jk, jv, jlw, ju, js0 = _jax(q, k, v, lw, u, s0)
    ry, rf = gla_ref(jq, jk, jv, jlw, bonus_u=ju, include_current=inc, initial_state=js0)
    ky, kf = jax_gla_chunked(jq, jk, jv, jlw, bonus_u=ju, include_current=inc, initial_state=js0,
                             chunk=chunk, interpret=True)
    assert y.shape == (b, s, h, vd) and final.shape == (b, h, kd, vd)
    for expect_y, expect_f in ((ry, rf), (ky, kf)):
        _close(y, expect_y)
        _close(final, expect_f)


@pytest.mark.parametrize("s,inc", [(37, False), (70, True), (1, False)])
def test_any_sequence_length(s, inc):
    """No multiple of a chunk, down to one position: the JAX grid refuses
    these, the exact recurrence takes them."""
    q, k, v, lw, u, s0 = _inputs(2, s, 2, 16, 16, not inc, True, seed=s)
    y, final = _port(q, k, v, lw, u, s0, inc)
    ry, rf = gla_ref(*_jax(q, k, v, lw), bonus_u=_jax(u)[0], include_current=inc,
                     initial_state=_jax(s0)[0])
    _close(y, ry)
    _close(final, rf)


def test_strong_decay_stays_finite():
    """log_w down to ~-25 a step: the state forgets within a step or two,
    and nothing overflows."""
    q, k, v, lw, u, s0 = _inputs(1, 64, 2, 16, 16, True, True, seed=9, decay=12.0)
    y, final = _port(q, k, v, lw, u, s0, False)
    assert np.isfinite(y).all() and np.isfinite(final).all()
    ry, rf = gla_ref(*_jax(q, k, v, lw), bonus_u=_jax(u)[0], include_current=False,
                     initial_state=_jax(s0)[0])
    _close(y, ry)
    _close(final, rf)


@pytest.mark.parametrize("inc,bonus,init", [(False, True, True), (True, False, True), (False, True, False)])
def test_gradients_match_jax_vjp(inc, bonus, init):
    """All six gradients through the port's autograd function (its plain
    backward, torch.func.vjp of the recurrence) against jax.vjp of gla_ref,
    for cotangents of both y and the final state."""
    q, k, v, lw, u, s0 = _inputs(2, 21, 2, 8, 8, bonus, init, seed=4)
    rng = np.random.default_rng(5)
    dy = rng.standard_normal(v.shape).astype(np.float32)
    df = rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
    given = [a for a in (q, k, v, lw, u, s0) if a is not None]

    def jfwd(*xs):
        it = iter(xs)
        jq, jk, jv, jlw = next(it), next(it), next(it), next(it)
        ju = next(it) if bonus else None
        js0 = next(it) if init else None
        return gla_ref(jq, jk, jv, jlw, bonus_u=ju, include_current=inc, initial_state=js0)

    _, vjp = jax.vjp(jfwd, *_jax(*given))
    expect = vjp((jnp.asarray(dy), jnp.asarray(df)))
    leaves = [t.requires_grad_(True) for t in _torch(*given)]
    it = iter(leaves)
    tq, tk, tv, tlw = next(it), next(it), next(it), next(it)
    y, final = ops.gla_chunked(tq, tk, tv, tlw, bonus_u=next(it) if bonus else None,
                               include_current=inc, initial_state=next(it) if init else None)
    got = torch.autograd.grad((y, final), leaves, _torch(dy, df))
    assert len(got) == len(expect) == len(given)
    for g, e in zip(got, expect):
        e = np.asarray(e)
        _close(g.numpy(), e, atol=ATOL * np.abs(e).max())


def test_plain_backward_returns_six_gradients():
    q, k, v, lw, u, s0 = _torch(*_inputs(1, 9, 2, 8, 8, True, True, seed=6))
    dy = torch.ones_like(v)
    grads = ref.gla_bwd_ref(q, k, v, lw, u, s0, dy, None, include_current=False)
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in (q, k, v, lw, u, s0)]
    assert ref.gla_bwd_ref(q, k, v, lw, None, None, dy, None, include_current=False)[4:] == (None, None)


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    q, k, v, lw, u, s0 = _torch(*_inputs(1, 5, 1, 8, 8, True, True))
    ops.reset_launches()
    ops.gla_chunked(q, k, v, lw, bonus_u=u, include_current=False, initial_state=s0)
    assert ops.LAUNCHES == {"gla_fwd": 0, "gla_bwd": 0}
    # meta tensors (the dry run) get the kernel's outputs, unwritten, and launch nothing
    y, final = ops.gla_chunked(*(t.to("meta") for t in (q, k, v, lw)))
    assert y.device.type == final.device.type == "meta"
    assert y.shape == v.shape and final.shape == (1, 1, 8, 8)
    assert ops.LAUNCHES == {"gla_fwd": 0, "gla_bwd": 0}
    with pytest.raises(ValueError, match="not xpu"):
        ops.forward(types.SimpleNamespace(device=torch.device("xpu")), k, v, lw, include_current=True)


# -- the chunked plain versions, which the CUDA kernels follow step for step --

CHUNKED_S = [1, 15, 16, 17, 63, 64, 65, 130]


def _jax_chunk(s):
    """A chunk of the JAX kernel that divides S (its grid asserts that)."""
    return 65 if s == 130 else s


def _chunked_case(s, inc, strong=False):
    bonus, init = not inc and s % 2 == 1, s % 3 != 0
    q, k, v, lw, u, s0 = _inputs(2, s, 2, 16, 8, bonus, init, seed=s + 7 * inc)
    if strong:
        lw[..., ::3] = -30.0  # the state forgets within a step
    return q, k, v, lw, u, s0


def _exponents_ok(exponents):
    assert exponents and max(exponents) <= 0.0, f"an exponent above 0: {max(exponents)}"


@pytest.mark.parametrize("inc", [True, False], ids=["include_current", "rwkv6"])
@pytest.mark.parametrize("s", CHUNKED_S)
def test_chunked_forward_matches_jax(s, inc):
    q, k, v, lw, u, s0 = _chunked_case(s, inc)
    exponents = []
    y, final = ref.gla_fwd_chunked_ref(*_torch(q, k, v, lw), bonus_u=_torch(u)[0], include_current=inc,
                                       initial_state=_torch(s0)[0], exponents=exponents)
    _exponents_ok(exponents)
    jargs = dict(bonus_u=_jax(u)[0], include_current=inc, initial_state=_jax(s0)[0])
    ry, rf = gla_ref(*_jax(q, k, v, lw), **jargs)
    ky, kf = jax_gla_chunked(*_jax(q, k, v, lw), chunk=_jax_chunk(s), interpret=True, **jargs)
    for expect_y, expect_f in ((ry, rf), (ky, kf)):
        _close(y.numpy(), expect_y)
        _close(final.numpy(), expect_f)


def _jax_grads(q, k, v, lw, u, s0, dy, df, inc):
    given = [a for a in (q, k, v, lw, u, s0) if a is not None]

    def jfwd(*xs):
        it = iter(xs)
        jq, jk, jv, jlw = next(it), next(it), next(it), next(it)
        return gla_ref(jq, jk, jv, jlw, bonus_u=next(it) if u is not None else None,
                       include_current=inc, initial_state=next(it) if s0 is not None else None)

    _, vjp = jax.vjp(jfwd, *_jax(*given))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(df)))]


def _check_chunked_grads(s, inc, strong=False):
    q, k, v, lw, u, s0 = _chunked_case(s, inc, strong)
    rng = np.random.default_rng(s)
    dy = rng.standard_normal(v.shape).astype(np.float32)
    df = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
    exponents = []
    got = ref.gla_bwd_chunked_ref(*_torch(q, k, v, lw, u, s0, dy, df), include_current=inc,
                                  exponents=exponents)
    _exponents_ok(exponents)
    got = [g for g in got if g is not None]
    expect = _jax_grads(q, k, v, lw, u, s0, dy, df, inc)
    assert len(got) == len(expect)
    for g, e in zip(got, expect):
        assert torch.isfinite(g).all()
        _close(g.numpy(), e, atol=ATOL * np.abs(e).max())


@pytest.mark.parametrize("inc", [True, False], ids=["include_current", "rwkv6"])
@pytest.mark.parametrize("s", CHUNKED_S)
def test_chunked_backward_matches_jax_vjp(s, inc):
    """All gradients of the chunked plain backward (local pass, reverse dS
    scan, per-chunk sub-chunked products) against jax.vjp of gla_ref."""
    _check_chunked_grads(s, inc)


@pytest.mark.parametrize("inc", [True, False], ids=["include_current", "rwkv6"])
def test_chunked_strong_decay_stays_finite(inc):
    """log_w = -30 a step on every third channel: W reaches -1,920 within a
    chunk, so exp(-W) (a factorisation through the chunk start) is inf, yet
    the chunked versions, whose exponents are all <= 0, stay finite and
    match the oracles."""
    s = 130
    q, k, v, lw, u, s0 = _chunked_case(s, inc, strong=True)
    w = torch.from_numpy(lw[:, :64]).cumsum(1)
    assert torch.isinf(torch.exp(-w)).any()
    exponents = []
    y, final = ref.gla_fwd_chunked_ref(*_torch(q, k, v, lw), bonus_u=_torch(u)[0], include_current=inc,
                                       initial_state=_torch(s0)[0], exponents=exponents)
    _exponents_ok(exponents)
    assert torch.isfinite(y).all() and torch.isfinite(final).all()
    ry, rf = gla_ref(*_jax(q, k, v, lw), bonus_u=_jax(u)[0], include_current=inc,
                     initial_state=_jax(s0)[0])
    _close(y.numpy(), ry)
    _close(final.numpy(), rf)
    _check_chunked_grads(s, inc, strong=True)


def test_chunked_versions_match_the_step_recurrence_on_the_kernel_width():
    """At K = V = 64, the kernels' width, over three chunks with a ragged
    last one: the chunked forward and backward against the port's own step
    recurrence and its autograd."""
    q, k, v, lw, u, s0 = _torch(*_inputs(1, 150, 2, 64, 64, True, True, seed=11))
    dy, df = torch.randn(1, 150, 2, 64), torch.randn(1, 2, 64, 64)
    for expect, got in zip(ref.gla_fwd_ref(q, k, v, lw, bonus_u=u, include_current=False, initial_state=s0),
                           ref.gla_fwd_chunked_ref(q, k, v, lw, bonus_u=u, include_current=False,
                                                   initial_state=s0)):
        _close(got.numpy(), expect.numpy())
    for expect, got in zip(ref.gla_bwd_ref(q, k, v, lw, u, s0, dy, df, include_current=False),
                           ref.gla_bwd_chunked_ref(q, k, v, lw, u, s0, dy, df, include_current=False)):
        e = expect.numpy()
        _close(got.numpy(), e, atol=ATOL * np.abs(e).max())
