"""The port's roofline (``repro_torch/roofline/``) against the JAX
package's: the three terms, the model FLOPs, the depth extrapolation, the
SSM correction and the scaled configs on the same inputs, with JAX's TPU
constants replaced by the port's H100 ones; the hillclimb variants give
JAX's configs, ``tp_rs`` (``tp_reduce_scatter``, counted with tensor
parallelism) among them."""
import dataclasses
import os

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.registry import ARCHS  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import extrapolate as jextrapolate  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.roofline import analysis, extrapolate, hillclimb  # noqa: E402


def _jax_hillclimb():
    """JAX's hillclimb module; its import sets XLA_FLAGS for 512 host
    devices, which must reach neither this process's backend (started
    first) nor the subprocesses later tests start."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.roofline import hillclimb as jhill
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jhill


def _fields(cfg) -> dict:
    """The config's fields but its source note (the port's qwen2.5-3b cites
    the 3B model card)."""
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "cite"}


SUMMARY = {
    "devices": 256, "kind": "train", "global_batch": 256, "seq_len": 4096,
    "param_counts": {"active": 3_085_938_688, "total": 3_085_938_688},
    "cost": {"flops": 4.1e14, "bytes_accessed": 1.7e13},
    "collectives": {"total_bytes": 3.2e12},
}


def test_hw_is_the_h100s():
    assert analysis.HW == {"card": "NVIDIA H100 SXM, 700 W", "peak_flops": 989e12, "hbm_bw": 3.35e12,
                           "link_bw": 450e9}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("overrides", [{}, {"flops": 2.5e14, "hbm_bytes": 3e12, "collective_bytes": 1e9}])
def test_roofline_from_summary_equals_jax(kind, overrides, monkeypatch):
    for k in ("peak_flops", "hbm_bw", "link_bw"):
        monkeypatch.setitem(janalysis.HW, k, analysis.HW[k])
    summary = dict(SUMMARY, kind=kind)
    ours = analysis.roofline_from_summary(summary, **overrides)
    theirs = janalysis.roofline_from_summary(summary, **overrides)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.dominant, ours.step_time_s, ours.roofline_fraction) == (
        theirs.dominant, theirs.step_time_s, theirs.roofline_fraction)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equal_jax(kind):
    assert analysis.model_flops_for(kind, 123_456_789, 4096) == janalysis.model_flops_for(kind, 123_456_789, 4096)


def test_extrapolate_costs_equal_jax():
    def summ(f, b, c):
        return {"cost": {"flops": f, "bytes_accessed": b}, "collectives": {"total_bytes": c}}

    r1, r2 = summ(1.5e12, 2.0e10, 3.0e9), summ(2.75e12, 3.5e10, 5.5e9)
    for ssm in (0.0, 1.25e11):
        assert extrapolate.extrapolate_costs(r1, r2, 36, ssm) == jextrapolate.extrapolate_costs(r1, r2, 36, ssm)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_flops_and_scaled_config_equal_jax(arch):
    for name, shape in tshapes.INPUT_SHAPES.items():
        if not tshapes.shape_applicable(arch, name):
            continue
        ours, theirs = tshapes.config_for(arch, name), jshapes.config_for(arch, name)
        assert extrapolate.ssm_recurrence_flops(ours, shape) == jextrapolate.ssm_recurrence_flops(
            theirs, jshapes.INPUT_SHAPES[name])
        for r in (1, 2):
            assert _fields(extrapolate.scaled_config(ours, r)) == _fields(jextrapolate.scaled_config(theirs, r))


@pytest.mark.parametrize("variant", ["base", "save_out", "dots_nb", "bf16_params", "save_out+bf16_params", "tp_rs",
                                     "tp_rs+save_out"])
def test_hillclimb_variants_give_jaxs_configs(variant):
    jhill = _jax_hillclimb()
    for arch in ("qwen2.5-3b", "dbrx-132b", "zamba2-2.7b"):
        ours = hillclimb.apply_variant(tshapes.config_for(arch, "train_4k"), variant)
        theirs = jhill.apply_variant(jshapes.config_for(arch, "train_4k"), variant)
        assert _fields(ours) == _fields(theirs)


def test_hillclimb_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="unknown variant"):
        hillclimb.apply_variant(tshapes.config_for("qwen2.5-3b", "train_4k"), "nope")
