"""The port's sharding rules (``src/repro_torch/sharding/``), logical-axes
trees and meshes against the JAX package's, with no devices.

- ``LOGICAL_RULES`` and ``DATA_AXES`` are JAX's;
- ``LanguageModel.param_axes()`` and ``cache_axes()`` equal the axes trees
  of JAX's ``init`` and ``cache_axes``, key for key, for all ten archs;
- ``logical_to_mesh_spec`` gives JAX's ``PartitionSpec`` (on an
  ``AbstractMesh``) for every leaf of every arch's full config (params, the
  dense cache, and every optimizer's ``state_axes``), in JAX's stacked layout
  and, through ``unstack_axes``, in the port's per-layer one (each layer's
  spec is the stacked leaf's without its ``"layers"`` entry), at meshes
  (16, 16), (2, 16, 16), (1, 1), (1, 4), (2, 2), (4, 1) and (2, 1, 2);
- ``batch_spec`` at batch 1, 3, 4 and 256;
- ``make_production_mesh``'s layouts at 1, 4, 8, 256 and 512 devices, JAX's
  ``MeshConfig`` at 256 and 512;
- a ``NamedSharding``'s shards, taken by ``reshard_state`` and concatenated
  in index order, rebuild each leaf bit for bit, the ``("pod", "data")``
  index ``pod_idx * data + data_idx``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import MeshConfig  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.sharding import DATA_AXES as JDATA_AXES  # noqa: E402
from repro.sharding import LOGICAL_RULES as JRULES  # noqa: E402
from repro.sharding import batch_spec as jax_batch_spec  # noqa: E402
from repro.sharding import logical_to_mesh_spec as jax_spec  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro.train.state import state_axes as jax_state_axes  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.distributed.reshard import reshard_state, state_shardings  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, production_shape  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.optim import OPTIMIZERS, make_optimizer  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    DATA_AXES,
    LOGICAL_RULES,
    batch_spec,
    is_axes_leaf,
    logical_to_mesh_spec,
    named_sharding,
)
from repro_torch.train.state import TrainState, state_axes, unstack_axes  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

MESHES = [(16, 16), (2, 16, 16), (1, 1), (1, 4), (2, 2), (4, 1), (2, 1, 2)]


def _meshes(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    n = int(np.prod(shape))
    port = make_host_mesh(*shape[-2:], pod=shape[0] if len(shape) == 3 else None, devices=["cpu"] * n)
    return port, AbstractMesh(shape, names)


def test_rules_are_jax_rules():
    assert LOGICAL_RULES == JRULES
    assert DATA_AXES == JDATA_AXES


_JAX: dict = {}


def _jax_model(arch):
    """(JAX model, params ShapeDtypeStruct tree, init axes tree) of the full config."""
    if arch not in _JAX:
        jmodel = build_model(jax_config(arch, "full"))
        box = {}

        def init(key):
            params, axes = jmodel.init(key)
            box["axes"] = axes
            return params

        shapes = jax.eval_shape(init, jax.random.key(0))
        _JAX[arch] = (jmodel, shapes, box["axes"])
    return _JAX[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_trees_equal_jax(arch):
    jmodel, _, jaxes = _jax_model(arch)
    model = LanguageModel(get_config(arch, "full"))
    assert model.param_axes() == jaxes
    assert model.cache_axes() == jmodel.cache_axes()


def _specs(fn, axes, shapes):
    """``fn(axes, shape)`` at every leaf of an axes tree and its shape tree."""
    if is_axes_leaf(axes):
        return fn(axes, tuple(shapes.shape))
    if isinstance(axes, dict):
        return {k: _specs(fn, v, shapes[k]) for k, v in axes.items()}
    return [_specs(fn, a, s) for a, s in zip(axes, shapes, strict=True)]


def _port_equals_stacked(port, stacked):
    """The port's per-layer spec tree against JAX's stacked one: where the
    port has a list of layers, each layer's spec is the stacked spec
    without its leading ``"layers"`` entry (never sharded: None)."""
    if isinstance(port, list) and not isinstance(stacked, list):
        def drop(spec):
            assert spec[0] is None
            return spec[1:]

        layer = jax.tree.map(drop, stacked, is_leaf=lambda x: isinstance(x, tuple))
        for p in port:
            _port_equals_stacked(p, layer)
    elif isinstance(port, dict):
        assert port.keys() == stacked.keys()
        for k in port:
            _port_equals_stacked(port[k], stacked[k])
    else:
        assert port == stacked


def _meta(shapes):
    return jax.tree.map(lambda s: torch.empty(s.shape, dtype=getattr(torch, str(s.dtype)), device="meta"), shapes)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch):
    jmodel, shapes, jaxes = _jax_model(arch)
    cfg = get_config(arch, "full")
    cache_shapes = jax.eval_shape(lambda: jmodel.init_cache(4, 64))
    port_params = bridge.params_from_numpy(_meta(shapes), cfg, device="meta")
    port_axes = unstack_axes(LanguageModel(cfg).param_axes(), port_params)
    states = {}
    for name in sorted(OPTIMIZERS):
        jopt, opt = jax_make_optimizer(name), make_optimizer(name)
        jstate = jax.eval_shape(lambda p, o=jopt: JTrainState(p, o.init(p), jax.numpy.zeros((), "int32")), shapes)
        states[name] = (jstate, jax_state_axes(jstate, jaxes),
                        TrainState(port_params, opt.init(port_params), 0))
    for shape in MESHES:
        port_mesh, jmesh = _meshes(shape)
        mine = lambda a, s: logical_to_mesh_spec(a, port_mesh, s)  # noqa: E731
        theirs = lambda a, s: tuple(jax_spec(a, jmesh, s))  # noqa: E731
        # JAX's stacked layout, leaf by leaf
        assert _specs(mine, jaxes, shapes) == _specs(theirs, jaxes, shapes), shape
        assert _specs(mine, jmodel.cache_axes(), cache_shapes) == _specs(theirs, jmodel.cache_axes(), cache_shapes)
        # the port's per-layer layout
        stacked = _specs(theirs, jaxes, shapes)
        _port_equals_stacked(_specs(mine, port_axes, port_params), stacked)
        for name, (jstate, jstate_axes, state) in states.items():
            jspecs = jax.tree.map(lambda a, s: tuple(jax_spec(a, jmesh, s.shape)), jstate_axes, jstate,
                                  is_leaf=is_axes_leaf)
            axes = state_axes(state, LanguageModel(cfg).param_axes())
            specs = state_shardings(state, port_mesh, LanguageModel(cfg).param_axes())
            assert axes.step == () and specs.step.spec == ()
            for slot, value in state.opt_state.items():
                port_slot = jax.tree.map(lambda s: s.spec, specs.opt_state[slot],
                                         is_leaf=lambda x: hasattr(x, "spec"))
                if isinstance(value, int):
                    assert port_slot == () == jspecs.opt_state[slot], (name, slot)
                else:
                    _port_equals_stacked(port_slot, jspecs.opt_state[slot])
            _port_equals_stacked(jax.tree.map(lambda s: s.spec, specs.params, is_leaf=lambda x: hasattr(x, "spec")),
                                 jspecs.params)


@pytest.mark.parametrize("shape", MESHES)
def test_batch_spec_equals_jax(shape):
    port_mesh, jmesh = _meshes(shape)
    for batch in (None, 1, 3, 4, 256):
        for extra in (0, 1, 2):
            assert batch_spec(port_mesh, extra, batch) == tuple(jax_batch_spec(jmesh, extra, batch)), (batch, extra)


def test_production_mesh_layouts():
    single, multi = MeshConfig.single_pod(), MeshConfig.multi_pod()
    assert production_shape(single.num_devices) == single.shape
    assert production_shape(multi.num_devices, multi_pod=True) == multi.shape
    assert [production_shape(n) for n in (1, 4, 8, 256, 512)] == [(1, 1), (2, 2), (4, 2), (16, 16), (32, 16)]
    assert [production_shape(n, True) for n in (4, 8, 512)] == [(2, 2, 1), (2, 2, 2), (2, 16, 16)]
    for n, cfg in ((256, single), (512, multi)):
        mesh = make_production_mesh(multi_pod=cfg is multi, devices=["cpu"] * n)
        assert tuple(mesh.shape.values()) == cfg.shape and mesh.axis_names == cfg.axis_names
    assert tuple(make_production_mesh(devices=["cpu"] * 4).shape.values()) == (2, 2)
    with pytest.raises(ValueError, match="have 1"):
        make_production_mesh(multi_pod=True, devices=["cpu"])


def test_shards_rebuild_each_leaf():
    """qwen2.5-3b smoke with pSGD on (2, 2): ``embed`` over "data", heads
    over "model", and its 2 kv heads over "model" too; every leaf's shards,
    taken by ``reshard_state``, concatenate back in index order."""
    cfg = get_config("qwen2.5-3b", "smoke")
    model = LanguageModel(cfg)
    params = model.init(0, device="cpu")
    opt = make_optimizer("psgd")
    state = TrainState(params, opt.init(params), 3)
    mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
    shards = [reshard_state(state, mesh, model.param_axes(), rank=r) for r in range(4)]
    specs = state_shardings(state, mesh, model.param_axes())
    assert specs.params["embed"]["table"].spec == ("model", "data")
    assert specs.params["seg0"]["b0"][0]["attn"]["wk"].spec == ("data", "model", None)
    leaves = [tree_leaves([s.params, s.opt_state]) for s in shards]
    sharded = 0
    for i, (full, sharding) in enumerate(zip(tree_leaves([state.params, state.opt_state]),
                                             tree_leaves([specs.params, specs.opt_state]))):
        if not isinstance(full, torch.Tensor):
            assert all(leaf[i] == full for leaf in leaves)
            continue
        rebuilt = torch.empty_like(full)
        for index, holder in sharding.holders().items():
            rebuilt[sharding.slices_of(index)] = leaves[holder][i]
        assert torch.equal(rebuilt, full)
        sharded += not sharding.replicated
    assert sharded > 0


def test_pod_data_shard_index():
    """Along a dimension over ("pod", "data") the shard index is
    ``pod_idx * data + data_idx``, JAX's order (the dense cache's batch)."""
    cfg = get_config("qwen2.5-3b", "smoke")
    mesh = make_host_mesh(2, 1, pod=2, devices=["cpu"] * 4)
    k = named_sharding(mesh, LanguageModel(cfg).cache_axes()["seg0"]["b0"]["attn"]["k"][1:], (8, 16, 2, 64))
    assert k.spec[0] == ("pod", "data")
    for rank in range(4):
        c = mesh.coords(rank)
        assert k.shard_index(rank)[0] == c["pod"] * 2 + c["data"]
        assert k.shard_slices(rank)[0] == slice(2 * k.shard_index(rank)[0], 2 * k.shard_index(rank)[0] + 2)
