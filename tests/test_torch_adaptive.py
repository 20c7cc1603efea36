"""The port's adaptive optimizers (AdamW, LARS, LAMB) against the JAX
package's ``optim/adaptive.py`` on the CPU: one and three updates from the
same parameters and gradients (qwen2.5-3b smoke's tree in f32, gradients
from a seeded numpy generator, one leaf zero so that the trust ratio's
fallback is taken), within 1e-6 relative; the ``count`` slot across the
bridge both ways; and the train launcher with ``--optimizer adamw``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

RTOL = 1e-6
NAMES = ("adamw", "lars", "lamb")
HP = {"adamw": {"weight_decay": 0.01}, "lars": {}, "lamb": {}}
CFG = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, where torch's default of one thread a core oversubscribes
    the host."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
_JAX_UPDATES: dict = {}


def _jax_optimizer(name, **hp):
    """(the JAX optimizer, its jitted update), compiled once per name."""
    if name not in _JAX_UPDATES:
        jopt = jax_make_optimizer(name, **hp)
        _JAX_UPDATES[name] = (jopt, jax.jit(jopt.update))
    return _JAX_UPDATES[name]


@pytest.fixture(scope="module")
def np_params():
    jcfg = jax_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    return jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.key(0))[0])


def _grads(np_params, seed):
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32), np_params)
    grads["final_norm"]["scale"] = np.zeros_like(grads["final_norm"]["scale"])  # trust ratio falls back to 1
    return grads


def _close(got_tree, expect_tree):
    for got, e in zip(tree_leaves(got_tree), tree_leaves(expect_tree)):
        np.testing.assert_allclose(got.numpy(), e.numpy(), rtol=RTOL, atol=RTOL * float(np.abs(e.numpy()).max()))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", NAMES)
def test_updates_match_jax(np_params, name, steps):
    (jopt, jupdate), topt = _jax_optimizer(name, **HP[name]), make_optimizer(name, **HP[name])
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = jopt.init(jparams)
    tparams = bridge.params_from_numpy(np_params, CFG, device="cpu")
    tstate = topt.init(tparams)
    for i in range(steps):
        grads = _grads(np_params, seed=i)
        jparams, jstate = jupdate(jax.tree.map(jnp.asarray, grads), jstate, jparams,
                                  lr=jnp.float32(0.01), stage=jnp.int32(0))
        tparams, tstate = topt.update(tree_leaves(bridge.params_from_numpy(grads, CFG, "cpu")), tstate,
                                      tparams, lr=0.01, stage=0)
    _close(tparams, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu"))
    expect_state = bridge.opt_state_from_numpy(jax.tree.map(np.asarray, jstate), CFG, "cpu")
    assert set(tstate) == set(expect_state)
    for slot, value in expect_state.items():
        if isinstance(value, dict):
            _close(tstate[slot], value)
        else:
            assert tstate[slot] == value, slot
    if "count" in tstate:
        assert tstate["count"] == steps


@pytest.mark.parametrize("name", ["adamw", "lamb"])
def test_count_crosses_the_bridge(np_params, name):
    """JAX's state after two updates (count 2) crosses into the port and
    back; the next update agrees, and the count goes on from 2."""
    (jopt, jupdate), topt = _jax_optimizer(name, **HP[name]), make_optimizer(name, **HP[name])
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = jopt.init(jparams)
    for i in range(2):
        jparams, jstate = jupdate(jax.tree.map(jnp.asarray, _grads(np_params, i)), jstate, jparams,
                                  lr=jnp.float32(0.01), stage=jnp.int32(1))
    tstate = bridge.opt_state_from_numpy(jax.tree.map(np.asarray, jstate), CFG, "cpu")
    assert tstate["count"] == 2 and tstate["stage"] == 1
    back = bridge.opt_state_to_numpy(tstate, CFG)
    assert back["count"].dtype == np.int32 and back["count"].shape == () and int(back["count"]) == 2
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, jstate))):
        np.testing.assert_array_equal(a, b)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")
    grads = _grads(np_params, 2)
    jparams, jstate = jupdate(jax.tree.map(jnp.asarray, grads), jstate, jparams,
                              lr=jnp.float32(0.01), stage=jnp.int32(1))
    tparams, tstate = topt.update(tree_leaves(bridge.params_from_numpy(grads, CFG, "cpu")), tstate, tparams,
                                  lr=0.01, stage=1)
    assert tstate["count"] == int(jstate["count"]) == 3
    _close(tparams, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu"))


def test_train_launcher_runs_adamw(tmp_path):
    log = train_launcher.main(["--device", "cpu", "--optimizer", "adamw", "--eta", "0.001", "--b1", "2",
                               "--c1", "4", "--rho", "2", "--stages", "2", "--seq", "8", "--steps-log", "1"])
    assert log.batch_sizes == [2, 2, 4, 4] and all(np.isfinite(log.losses))
