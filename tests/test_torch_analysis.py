"""The port's static rules (``repro_torch/analysis``, ``tools/lint_torch.py``):

- each kept rule (R101-R105, R203, R402) on a fixture that trips it and one
  that does not, linted as if it lived at a path inside the port;
- on framework-agnostic snippets (set iteration, wall-clock and global RNG
  calls) the port's rules flag the same lines as the JAX package's
  ``lint_source`` does with the path mapped from ``repro/`` to
  ``repro_torch/``;
- suppressions with and without a justification, under ``--strict``;
- the port's tree lints clean under ``--strict``.

A few seconds; the rules never import what they analyze.
"""
from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis.core import lint_source as jax_lint_source
from repro_torch.analysis import contracts
from repro_torch.analysis.core import all_rules, lint_source

REPO = Path(__file__).resolve().parent.parent


def fired(source: str, rel: str):
    return sorted({v.rule for v in lint_source(textwrap.dedent(source), rel=rel).violations})


CASES = [
    # (rule, path, fires, silent)
    ("R101", "repro_torch/distributed/x.py",
     "import torch.distributed as dist\ndef f(t):\n    dist.all_reduce(t)\n",
     "import torch.distributed as dist\ndef f(t, out):\n    dist.all_gather_into_tensor(out, t)\n"),
    ("R101", "repro_torch/train/x.py",
     "from torch.distributed import reduce_scatter_tensor\ndef f(a, b):\n    reduce_scatter_tensor(a, b)\n",
     "from torch.distributed import all_to_all_single\ndef f(a, b):\n    all_to_all_single(a, b)\n"),
    ("R102", "repro_torch/models/x.py",
     "def f(xs):\n    return [x for x in set(xs)]\n",
     "def f(xs):\n    return [x for x in sorted(set(xs))]\n"),
    ("R103", "repro_torch/distributed/x.py",
     "import time\ndef f():\n    return time.perf_counter()\n",
     "import time\ndef f(clock=time.perf_counter):\n    return clock()\n"),
    ("R103", "repro_torch/train/x.py",
     "import torch\ndef f():\n    return torch.randn(3)\n",
     "import torch\ndef f(g):\n    return torch.randn(3, generator=g)\n"),
    ("R103", "repro_torch/serve/x.py",
     "import numpy as np\ndef f():\n    return np.random.rand(3)\n",
     "import numpy as np\ndef f():\n    return np.random.default_rng(0).random(3)\n"),
    ("R104", "repro_torch/models/x.py",
     "from repro_torch.utils.prng import fold_in_name\n"
     "def f(key, d):\n    for k, v in d.items():\n        key = fold_in_name(key, k)\n",
     "from repro_torch.utils.prng import fold_in_name\n"
     "def f(key, d):\n    for k in sorted(d):\n        key = fold_in_name(key, k)\n"),
    ("R105", "repro_torch/serve/engine.py",
     "class PagedEngine:\n    def tick(self, block):\n        return block.to(self.device)\n",
     "class DisaggregatedEngine:\n    def _stream(self, block):\n        return block.to(self.device)\n"),
    ("R105", "repro_torch/serve/x.py",
     "def f(t):\n    return t.cuda()\n",
     "import torch\ndef f(t):\n    return t.to(torch.bfloat16)\n"),
    ("R203", "repro_torch/train/step.py",
     "def build_train_step(model):\n    def step(state, batch):\n        loss = model(batch)\n"
     "        return float(loss.mean())\n    return step\n",
     "def build_train_step(model):\n    def step(state, batch):\n        n = int(batch['tokens'].shape[0])\n"
     "        return model(batch), n\n    return step\n"),
    ("R203", "repro_torch/distributed/sharded.py",
     "def build_sharded_train_step(m):\n    def step(state, batch):\n        return m(batch).item()\n    return step\n",
     "def build_sharded_train_step(m):\n    def step(state, batch):\n        return m(batch)\n"
     "    return step\ndef report(x):\n    return x.item()\n"),
]


@pytest.mark.parametrize("rule,rel,fires,silent", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_rule_fires_and_stays_silent(rule, rel, fires, silent):
    assert rule in fired(fires, rel)
    assert rule not in fired(silent, rel)


def test_rules_keep_their_scope():
    """R101 belongs to train/ and distributed/, R103 to the state paths,
    R105 to serve/: the same lines elsewhere pass."""
    assert fired(CASES[0][2], "repro_torch/models/x.py") == []
    assert fired(CASES[3][2], "repro_torch/launch/x.py") == []
    assert fired(CASES[8][2], "repro_torch/models/x.py") == []


def test_r402_kernel_directory_needs_a_plain_version(tmp_path):
    from repro_torch.analysis.core import lint_paths

    for name, with_ref in (("good", True), ("bad", False)):
        d = tmp_path / "repro_torch" / "kernels" / name
        d.mkdir(parents=True)
        (d / "ops.py").write_text("def f(x):\n    return x\n")
        if with_ref:
            (d / "ref.py").write_text("def f(x):\n    return x\n")
    found = lint_paths([tmp_path / "repro_torch"])
    assert [(Path(v.path).parent.name, v.rule) for v in found.violations] == [("bad", "R402")]


SHARED = [
    ("R102", "distributed/x.py", "def f(a, b):\n    out = []\n    for x in {a, b}:\n        out.append(x)\n"
     "    return [y for y in frozenset(out)]\n"),
    ("R103", "train/x.py", "import time, random\nimport numpy as np\n\ndef f():\n    t = time.time()\n"
     "    r = random.random()\n    n = np.random.normal()\n    g = np.random.default_rng(0)\n"
     "    return t, r, n, g, time.monotonic()\n"),
    ("R103", "obs/x.py", "from time import perf_counter\nimport datetime\n\ndef f():\n"
     "    return perf_counter(), datetime.datetime.now()\n"),
]


@pytest.mark.parametrize("rule,sub,source", SHARED, ids=[f"{s[0]}-{s[1]}" for s in SHARED])
def test_shared_snippets_flag_the_jax_rules_lines(rule, sub, source):
    ours = [(v.rule, v.line, v.col) for v in lint_source(source, rel=f"repro_torch/{sub}").violations]
    theirs = [(v.rule, v.line, v.col) for v in jax_lint_source(source, rel=f"repro/{sub}").violations]
    assert ours == theirs and ours and {r for r, _, _ in ours} == {rule}


def test_step_function_registry_names_live_functions():
    """Every entry of ``contracts.STEP_FUNCTIONS`` names a function of its module."""
    from repro_torch.analysis.core import function_table, load_file

    for entry in contracts.STEP_FUNCTIONS:
        mod = load_file(REPO / "src" / entry.module)
        assert entry.function in {q for q, _ in function_table(mod.tree)}, entry


def _cli(*args, cwd=REPO):
    return subprocess.run([sys.executable, str(REPO / "tools" / "lint_torch.py"), *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_strict_needs_justified_suppressions(tmp_path):
    d = tmp_path / "repro_torch" / "distributed"
    d.mkdir(parents=True)
    line = "import time\ndef f():\n    return time.perf_counter()  # repro-lint: disable=R103{}\n"
    (d / "x.py").write_text(line.format(" -- host seconds reported, never stored"))
    ok = _cli("--strict", str(tmp_path / "repro_torch"))
    assert ok.returncode == 0, ok.stdout
    assert _cli(str(tmp_path / "repro_torch")).returncode == 0
    (d / "x.py").write_text(line.format(""))
    bare = _cli("--strict", str(tmp_path / "repro_torch"))
    assert bare.returncode == 1 and "without a justification" in bare.stdout
    assert _cli(str(tmp_path / "repro_torch")).returncode == 0  # report mode accepts it
    (d / "x.py").write_text(line.format("").replace("  # repro-lint: disable=R103", ""))
    assert _cli(str(tmp_path / "repro_torch")).returncode == 1


def test_list_rules_names_the_kept_rules():
    out = _cli("--list-rules")
    assert out.returncode == 0
    assert [r.id for r in all_rules()] == ["R101", "R102", "R103", "R104", "R105", "R203", "R402"]
    assert all(r.id in out.stdout for r in all_rules())


def test_the_ports_tree_lints_clean():
    out = _cli("--strict", "src/repro_torch")
    assert out.returncode == 0, out.stdout
