"""The port's fused optimizer updates and optimizers against the JAX
package's, on the CPU.

The plain versions (the CPU path of ``kernels/fused_optim/ops.py``) against
``fused_optim/ref.py`` and the Pallas kernels in interpret mode; then the
port's ``make_optimizer`` against the JAX optimizers over several updates
across stage boundaries, so that the anchor, u, z and s2 are reset at the
same update. Inputs are made with numpy from a seed. f32 throughout: the
same formulas in the same order agree within 1e-6 (XLA may contract a
multiply-add where PyTorch rounds twice). The CUDA kernels are held against
the plain versions bit for bit on the card.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fused_optim import ops as jops  # noqa: E402
from repro.kernels.fused_optim import ref as jref  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.kernels.fused_optim import ops, ref  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPE = (37, 5)  # not a multiple of the TPU kernel's (8, 128) tiling


def _arrays(n, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    return out


def _close(got, expect):
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect), **TOL)


def test_psgd_matches_jax():
    w, g, a = _arrays(3)
    got = ref.psgd_ref(*map(torch.from_numpy, (w, g, a)), lr=0.3, gamma=1e4)
    _close(got, jref.psgd_ref(w, g, a, lr=0.3, gamma=1e4))
    _close(got, jops.psgd_update(w, g, a, lr=0.3, gamma=1e4, interpret=True))


def test_momentum_matches_jax():
    w, g, u = _arrays(3, seed=1)
    got = ref.momentum_ref(*map(torch.from_numpy, (w, g, u)), lr=0.3, beta=0.9)
    for x, y, z in zip(got, jref.momentum_ref(w, g, u, lr=0.3, beta=0.9),
                       jops.momentum_update(w, g, u, lr=0.3, beta=0.9, interpret=True)):
        _close(x, y)
        _close(x, z)


@pytest.mark.parametrize("nu", [1.0, 0.5])
def test_adagrad_da_matches_jax(nu):
    w, g, a, z = _arrays(4, seed=2)
    s2 = np.abs(_arrays(1, seed=3)[0])
    kw = dict(lr=0.3, delta=0.5, nu=nu)
    got = ref.adagrad_da_ref(*map(torch.from_numpy, (w, g, a, z, s2)), **kw)
    for x, y, q in zip(got, jref.adagrad_da_ref(w, g, a, z, s2, **kw),
                       jops.adagrad_da_update(w, g, a, z, s2, interpret=True, **kw)):
        _close(x, y)
        _close(x, q)


def test_ops_update_every_leaf_in_place():
    """The list wrappers on CPU tensors: each leaf updated in place exactly
    as its plain version, no launch counted."""
    sizes = [(3,), (4, 5), (0,), (2049,)]
    rng = np.random.default_rng(4)
    make = lambda: [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in sizes]
    w, g, a, z = make(), make(), make(), make()
    s2 = [x.abs() for x in make()]
    ops.reset_launches()
    for name in ("psgd", "momentum", "adagrad_da"):
        ws, states = [x.clone() for x in w], [[x.clone() for x in st] for st in (a, z, s2)]
        if name == "psgd":
            ops.psgd_update(ws, g, states[0], lr=0.1, gamma=10.0)
            expect = [(ref.psgd_ref(*x, lr=0.1, gamma=10.0),) for x in zip(w, g, a)]
            got = [(x,) for x in ws]
        elif name == "momentum":
            ops.momentum_update(ws, g, states[0], lr=0.1, beta=0.9)
            expect = [ref.momentum_ref(*x, lr=0.1, beta=0.9) for x in zip(w, g, a)]
            got = list(zip(ws, states[0]))
        else:
            ops.adagrad_da_update(ws, g, *states, lr=0.1, delta=1.0, nu=1.0)
            expect = [ref.adagrad_da_ref(*x, lr=0.1, delta=1.0, nu=1.0) for x in zip(w, g, a, z, s2)]
            got = list(zip(ws, states[1], states[2]))
        for x, y in zip(got, expect):
            for u, v in zip(x, y):
                assert torch.equal(u, v), name
    assert ops.LAUNCHES == {"fused_psgd": 0, "fused_momentum": 0, "fused_adagrad_da": 0}


OPTIMIZERS = {
    "sgd": ("sgd", {}),
    "psgd": ("psgd", {"gamma": 1e4}),
    "psgd_gamma_inf": ("psgd", {"gamma": math.inf}),
    "momentum": ("momentum", {"beta": 0.9}),
    "momentum_no_reset": ("momentum", {"beta": 0.9, "reset_on_stage": False}),
    "adagrad_da": ("adagrad_da", {"delta": 0.5}),
    "adagrad": ("adagrad", {}),
}
STAGES = [0, 0, 1, 1, 1, 2]  # two stage boundaries


def _params(seed=5):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((6, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((9,)).astype(np.float32)}}


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_across_stages(case):
    name, hp = OPTIMIZERS[case]
    np_params = _params()
    jopt, topt = jax_make_optimizer(name, **hp), make_optimizer(name, **hp)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = jax.tree.map(torch.from_numpy, np_params)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    jupdate = jax.jit(jopt.update)
    rng = np.random.default_rng(6)
    for i, stage in enumerate(STAGES):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), np_params)
        jparams, jstate = jupdate(jax.tree.map(jnp.asarray, grads), jstate, jparams,
                                  lr=jnp.float32(0.1), stage=jnp.int32(stage))
        tparams, tstate = topt.update(jax.tree.map(torch.from_numpy, grads), tstate, tparams,
                                      lr=0.1, stage=stage)
        assert tstate["stage"] == int(jstate["stage"]) == stage
        for key in tstate:
            if key == "stage":
                continue
            for x, y in zip(tree_leaves(tstate[key]), jax.tree.leaves(jstate[key])):
                np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL,
                                           err_msg=f"{case}: {key} after update {i}")
        for x, y in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL,
                                       err_msg=f"{case}: params after update {i}")


def test_psgd_gamma_inf_is_sgd():
    np_params = _params()
    grads = jax.tree.map(lambda x: x * 0.5 + 1.0, np_params)
    outs = []
    for opt in (make_optimizer("psgd", gamma=math.inf), make_optimizer("sgd")):
        p = jax.tree.map(torch.from_numpy, jax.tree.map(np.copy, np_params))
        p, _ = opt.update(jax.tree.map(torch.from_numpy, grads), opt.init(p), p, lr=0.3, stage=1)
        outs.append(tree_leaves(p))
    assert all(torch.equal(x, y) for x, y in zip(*outs))


def test_adaptive_optimizers_wait_for_their_slice():
    """Their slice has come: the registry builds them (plain PyTorch, no
    fused kernel; tests/test_torch_adaptive.py holds them against JAX) and
    still refuses a name it does not know."""
    for name in ("adamw", "lars", "lamb"):
        assert make_optimizer(name).name == name
    with pytest.raises(KeyError, match="unknown optimizer"):
        make_optimizer("adafactor")
