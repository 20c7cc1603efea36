"""The port's dry run (``repro_torch/launch/dryrun.py``), counted on meta
tensors, against the JAX package's compiled one and against the port's own
runs:

- the rank's argument bytes equal JAX's ``memory_analysis()
  .argument_size_in_bytes`` exactly, for five archs' smoke configs at
  train, prefill and decode, on a (2, 2) mesh of 4 host devices (built with
  ``Auto`` axes in a subprocess: under jax 0.9 ``make_host_mesh``'s default
  ``Explicit`` axes fail the JAX package's own ``constrain``), and for
  dbrx's, arctic's, rwkv6's and zamba2's under ``tensor_parallel``;
- the meta count equals the count of the same step on real CPU tensors;
- the counts at depth 1 and 2, extrapolated, equal the full-depth count;
- the collective bytes it records for a (2, 2) mesh (the layer gathers'
  all-gathers, the gradient slices' all-to-alls) equal what four gloo CPU
  workers running the same sharded step received;
- qwen2.5-3b's full-width ``train_4k`` on the (16, 16) mesh allocates no
  host storage above 1 MiB.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from _torch_dist_cases import sharded_step_worker  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.roofline.run import depth_counts  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)

ARCHS = ("qwen2.5-3b", "rwkv6-1.6b", "dbrx-132b", "zamba2-2.7b", "whisper-tiny")
TP_ARCHS = ("dbrx-132b", "arctic-480b", "rwkv6-1.6b", "zamba2-2.7b")
SHAPES = {"train": InputShape("t", 32, 8, "train"), "prefill": InputShape("p", 32, 4, "prefill"),
          "decode": InputShape("d", 32, 8, "decode")}

JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax
    from jax.sharding import AxisType
    jax.devices()
    from repro.configs import get_config
    from repro.configs.shapes import InputShape
    from repro.launch import dryrun
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    shapes = json.loads(sys.argv[1])
    out = {}
    for arch in json.loads(sys.argv[2]):
        for kind, s in shapes.items():
            _, compiled = dryrun.lower_combo(get_config(arch, "smoke"), InputShape(*s), mesh)
            out[f"{arch}/{kind}"] = int(compiled.memory_analysis().argument_size_in_bytes)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_argument_bytes():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    shapes = {k: dataclasses.astuple(v) for k, v in SHAPES.items()}
    archs = ARCHS + tuple(a for a in TP_ARCHS if a not in ARCHS)
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, json.dumps(shapes), json.dumps(archs)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_jax(jax_argument_bytes, arch, kind):
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    summary = dryrun.count_combo(get_config(arch, "smoke"), SHAPES[kind], mesh)
    assert summary["memory"]["argument_bytes_per_device"] == jax_argument_bytes[f"{arch}/{kind}"]


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tensor_parallel_argument_bytes_equal_jax(jax_argument_bytes, arch, kind):
    """With ``tensor_parallel`` (the MoE family: heads, experts and
    arctic's residual MLP split over ``model``; rwkv6's and Mamba2's heads,
    the packed leaves run whole; the rows spread over the model groups) the
    rank's arguments are still its shards under the rules, as GSPMD's are
    in JAX: equal to JAX's ``argument_size_in_bytes``."""
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    summary = dryrun.count_combo(get_config(arch, "smoke"), SHAPES[kind], mesh, tensor_parallel=True)
    assert summary["work"]["tensor_parallel"] and summary["work"]["computing_ranks"] == 4
    assert summary["memory"]["argument_bytes_per_device"] == jax_argument_bytes[f"{arch}/{kind}"]


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ("qwen2.5-3b", "rwkv6-1.6b", "zamba2-2.7b", "dbrx-132b", "whisper-tiny"))
def test_meta_count_equals_the_cpu_count(arch, kind):
    """Flops, each kernel's calls, operations and bytes (reported in place
    of their plain versions' ops) and the argument bytes: the same on real
    CPU tensors as on meta ones. The bytes accessed agree within 1e-3:
    PyTorch implements a few ops differently by device (a scalar assigned
    into a slice is a fill on the CPU and a copy on meta; ``one_hot`` checks
    its indices' range on the CPU only, reading them to the host)."""
    cfg = get_config(arch, "smoke").replace(compute_dtype="float32")
    counts = []
    for device in ("meta", "cpu"):
        mesh = make_host_mesh(1, 1, devices=[device])
        counts.append(dryrun.count_combo(cfg, SHAPES[kind], mesh, device=device))
    meta, cpu = counts
    assert meta["memory"]["argument_bytes_per_device"] == cpu["memory"]["argument_bytes_per_device"]
    assert meta["cost"]["flops"] == cpu["cost"]["flops"] > 0
    assert meta["cost"]["kernels"] == cpu["cost"]["kernels"]
    assert meta["cost"]["bytes_accessed"] == pytest.approx(cpu["cost"]["bytes_accessed"], rel=1e-3)


@pytest.mark.parametrize("arch,kind", [("qwen2.5-3b", "train"), ("zamba2-2.7b", "prefill"), ("whisper-tiny", "decode"),
                                       ("dbrx-132b", "train")])
def test_depth_extrapolation_equals_the_full_depth_count(arch, kind):
    cfg = get_config(arch, "smoke")
    cfg = cfg.replace(segments=tuple(dataclasses.replace(s, repeat=4) for s in cfg.segments))
    counted = depth_counts(cfg, SHAPES[kind], make_host_mesh(2, 2, devices=["meta"] * 4))
    costs = counted["costs"]
    assert costs["matches"], costs
    assert costs["per_layer"]["flops"] > 0


def test_recorded_collectives_equal_a_gloo_runs_bytes(tmp_path):
    """Four CPU workers on a (2, 2) mesh, one sharded step (every rank two
    rows of 8 tokens): rank 0 receives the bytes the dry run records."""
    torch.multiprocessing.spawn(sharded_step_worker, args=(4, str(tmp_path), (2, 2), 8, 2), nprocs=4, join=True)
    received = json.loads((tmp_path / "received.json").read_text())["received_bytes"]
    cfg = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    summary = dryrun.count_combo(cfg, InputShape("t", 8, 8, "train"), make_host_mesh(2, 2, devices=["meta"] * 4))
    coll = summary["collectives"]
    assert coll["total_bytes"] == received > 0
    assert set(coll["by_type_bytes"]) == {"all-gather", "all-to-all"} and coll["in_while_bytes"] == 0


def test_full_width_train_4k_allocates_no_host_storage():
    summary = dryrun.run_combo("qwen2.5-3b", "train_4k", False)
    assert summary["devices"] == 256 and summary["mesh"] == {"data": 16, "model": 16}
    assert summary["work"]["largest_host_bytes"] <= 1 << 20
    mem = summary["memory"]
    # each layer is gathered whole where it runs: the peak is far above the rank's shards
    assert mem["peak_bytes_per_device"] > 10 * mem["argument_bytes_per_device"] > 0
    assert summary["cost"]["kernels"]["flash_attention_fwd"]["calls"] == 2 * 36
    assert summary["cost"]["kernels"]["flash_attention_bwd"]["calls"] == 36


@pytest.mark.parametrize("senders", [1, 4, 5])
def test_partials_tree_meta_path_counts_the_op_by_op_run(senders):
    """The exchange's combine (``distributed/step.py``) reports its work whole
    on meta tensors: the same bytes accessed, high-water mark and received
    bytes as its op-by-op run on CPU tensors (``senders`` partials each of
    a few leaves, the tree irregular at 5)."""
    from repro_torch.distributed.staging import StagingTimes
    from repro_torch.distributed.step import _combine_across
    from repro_torch.roofline.counter import StepCounter

    shapes = [(3, 5), (7,), (2, 2, 4)]
    seen = []
    for device in ("meta", "cpu"):
        xmesh = dryrun.recording_mesh(max(senders, 2), device, 4 * 16)
        total = {"grads": [torch.ones(s, device=device) for s in shapes], "loss": torch.ones((), device=device),
                 "aux": torch.zeros((), device=device), "sq": torch.ones((), device=device)}
        times = StagingTimes()
        with StepCounter() as c:
            out = _combine_across(total, xmesh, times, senders=senders)
        seen.append((c.bytes_accessed, c.peak_bytes, times.received_bytes, [tuple(g.shape) for g in out["grads"]]))
    assert seen[0] == seen[1]
    assert seen[0][2] == senders * 4 * (15 + 7 + 16 + 3)
