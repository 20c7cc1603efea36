"""The port's input-shape catalog (``repro_torch/configs/shapes.py``)
against the JAX package's: the shapes, which (arch, shape) pairs apply,
the config each resolves to, and the meta stand-ins' shapes and dtypes
against JAX's ``ShapeDtypeStruct``s."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.registry import ARCHS  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, input_specs, shape_applicable  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402

PAIRS = [(a, s) for a in ARCHS for s in jshapes.INPUT_SHAPES]


def _fields(cfg) -> dict:
    """The config's fields but its source note: the port's qwen2.5-3b
    cites the 3B model card where the JAX package's names the 0.5B one."""
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "cite"}


def test_input_shapes_equal_jax():
    assert list(INPUT_SHAPES) == list(jshapes.INPUT_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshapes.INPUT_SHAPES[name])


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_applicable_and_config_equal_jax(arch, shape):
    assert shape_applicable(arch, shape) == jshapes.shape_applicable(arch, shape)
    if not jshapes.shape_applicable(arch, shape):
        with pytest.raises(ValueError, match="inapplicable"):
            tshapes.config_for(arch, shape)
        return
    assert _fields(tshapes.config_for(arch, shape)) == _fields(jshapes.config_for(arch, shape))


@pytest.mark.parametrize("arch,shape", [p for p in PAIRS if jshapes.shape_applicable(*p)])
def test_input_specs_equal_jax(arch, shape):
    cfg = tshapes.config_for(arch, shape)
    ours = input_specs(cfg, INPUT_SHAPES[shape])
    theirs = jshapes.input_specs(jshapes.config_for(arch, shape), jshapes.INPUT_SHAPES[shape])
    assert list(ours) == list(theirs)
    for k, spec in theirs.items():
        assert ours[k].device.type == "meta"
        assert tuple(ours[k].shape) == tuple(spec.shape)
        assert str(ours[k].dtype).removeprefix("torch.") == np.dtype(spec.dtype).name
