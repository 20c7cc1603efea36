"""The port stands alone: ``src/repro_torch/``, ``chip_smoke.py`` and the
measurement module it shares with the card's bench scripts import neither ``jax`` nor anything of the JAX package ``repro``, importing the
port loads no JAX, and its entry points refuse to fall back to the CPU when
CUDA is asked for and missing."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                    ROOT / "tools" / "cardbench.py",
                                                                    ROOT / "tools" / "sample_bench.py",
                                                                    ROOT / "tools" / "trace_check.py",
                                                                    ROOT / "tools" / "disagg_check.py",
                                                                    ROOT / "tools" / "mesh_check.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "benchmarks"), f"{path.name} imports {name}"


def test_registry_resolves_inside_the_port():
    from repro_torch.configs import registry

    assert all(m.startswith("repro_torch.configs.") for m in registry._MODULES.values())


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.launch.train, repro_torch.bridge\n"
        "import repro_torch.serve, repro_torch.core, repro_torch.train, repro_torch.optim\n"
        "import repro_torch.checkpoint, repro_torch.models.vision, repro_torch.models.zoo\n"
        "import repro_torch.experiments.fig2_optimal_batch, repro_torch.experiments.fig3_stagewise\n"
        "import repro_torch.experiments.adaptive_sebs, repro_torch.experiments.sebs_vs_stagewise\n"
        "import repro_torch.distributed, repro_torch.launch.mesh, repro_torch.experiments.table_comm\n"
        "import repro_torch.analysis.sanitize, repro_torch.sharding, repro_torch.distributed.sharded\n"
        "import repro_torch.distributed.nccl\n"
        "from repro_torch.configs import ARCHS, get_config\n"
        "[get_config(a, 'smoke') for a in ARCHS]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_launcher_without_cpu_flag_needs_cuda(monkeypatch):
    from repro_torch.launch import serve as launcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        launcher.main(["--engine", "paged"])


def test_train_launcher_without_cpu_flag_needs_cuda(monkeypatch):
    from repro_torch.launch import train as launcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        launcher.main([])


def test_train_launcher_runs_on_cpu(tmp_path):
    from repro_torch.launch import train as launcher

    log = launcher.main(["--device", "cpu", "--b1", "2", "--c1", "4", "--rho", "2", "--stages", "2",
                         "--seq", "8", "--steps-log", "1", "--log-json", str(tmp_path / "log.json")])
    assert log.batch_sizes == [2, 2, 4, 4] and log.stages == [0, 0, 1, 1]
    assert all(np.isfinite(log.losses)) and (tmp_path / "log.json").exists()


def test_mesh_launcher_without_cpu_flag_needs_cuda(monkeypatch):
    from repro_torch.launch import train as launcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        launcher.main(["--mesh", "single"])


# the JAX launcher's behaviours: --mesh needs accumulate mode and, for two
# pods, two devices; the elastic options need --dp-elastic, which builds its
# own worker groups
@pytest.mark.parametrize("flags", [(["--mesh", "single", "--mode", "reshape"], "needs --mode accumulate"),
                                   (["--dp-elastic", "--mesh", "single"], "drop --mesh"),
                                   (["--mesh", "multi"], "needs at least 2 devices"),
                                   (["--sync-mode", "local"], "--sync-mode requires --dp-elastic"),
                                   (["--device-budget", "2"], "--device-budget requires --dp-elastic"),
                                   (["--local-interval", "2"], "--local-interval requires --dp-elastic")])
def test_train_launcher_names_the_later_slice(flags, capsys):
    from repro_torch.launch import train as launcher

    args, message = flags
    with pytest.raises(SystemExit):
        launcher.main(["--device", "cpu", *args])
    assert message in capsys.readouterr().err


def test_experiments_default_device_needs_cuda(monkeypatch):
    from repro_torch.experiments import _records

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["fig3_stagewise"])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        _records.cli("the Fig. 3 taker")
    monkeypatch.setattr(sys, "argv", ["fig3_stagewise", "--device", "cpu", "--out", "x"])
    assert _records.cli("the Fig. 3 taker").device == "cpu"


def test_engine_default_device_needs_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.serve import PagedContinuousBatchingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = LanguageModel(get_config("qwen2.5-3b", "smoke"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedContinuousBatchingEngine(model, model.init(seed=0, device="cpu"))


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository (or without CUDA) the smoke run
    exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
