"""The paper's Fig. 1 and Table 1 in the port (``repro_torch/experiments/
fig1_util.py``, ``table1_updates.py``) against the JAX package's
``benchmarks/`` files, on the CPU:

- Table 1's four records (classical and mSEBS update counts, the final
  batch, the saving) equal ``benchmarks/table1_updates.run``'s exactly;
- Fig. 1's records at smoke size have the JAX file's names, units and
  directions, its batches and sequence length, finite times, and the
  speedup their ratio (the JAX run cut to batches 1 and 2: its names do
  not depend on the batches);
- importing the port's two modules loads no JAX.

About 30 s on one worker.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from benchmarks import fig1_util as jax_fig1  # noqa: E402
from benchmarks import table1_updates as jax_table1  # noqa: E402
from repro_torch.experiments import fig1_util, table1_updates  # noqa: E402


def _fields(r):
    return (r.name, r.value, r.unit, r.direction, r.derived, r.context)


def test_table1_records_equal_jax(tmp_path):
    ours = table1_updates.run(out_dir=str(tmp_path / "port"))
    theirs = jax_table1.run(out_dir=str(tmp_path / "jax"))
    assert [_fields(r) for r in ours] == [_fields(r) for r in theirs]
    assert ours[2].value == 36_864 and ours[0].value > ours[1].value


def test_fig1_records_have_jax_names_units_directions(tmp_path, monkeypatch):
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ours = fig1_util.run(out_dir=str(tmp_path / "port"), device="cpu", iters=1)
    finally:
        torch.set_num_threads(old)
    batches = list(jax_fig1.BATCHES)
    assert fig1_util.BATCHES == batches and fig1_util.SEQ == jax_fig1.SEQ
    monkeypatch.setattr(jax_fig1, "BATCHES", [1, 2])
    theirs = jax_fig1.run(out_dir=str(tmp_path / "jax"))
    assert [(r.name, r.unit, r.direction) for r in ours] == [(r.name, r.unit, r.direction) for r in theirs]
    us = {int(k): v for k, v in ours[0].context["per_sample_us"].items()}
    assert sorted(us) == batches and all(math.isfinite(v) and v > 0 for v in us.values())
    assert ours[0].value == us[32] and ours[1].value == pytest.approx(us[1] / us[32])
    assert ours[0].context["seq"] == theirs[0].context["seq"] == 64


def test_the_port_modules_load_no_jax():
    """``repro_torch.experiments.{fig1_util,table1_updates}`` stand with the
    port: importing them (and Table 1's run) loads no JAX."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys, tempfile\n"
            "from repro_torch.experiments import fig1_util, table1_updates\n"
            "table1_updates.run(tempfile.mkdtemp())\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=str(root / "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
