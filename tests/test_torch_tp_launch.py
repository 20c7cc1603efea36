"""The launchers' ``--tensor-parallel`` (``repro_torch/launch/{serve,train}.py``)
on the CPU.

The launchers lay the visible cards out as the production mesh
(``launch/mesh.make_production_mesh``), whose ``model`` axis has more than
one rank from 4 cards on; with ``--device cpu`` that is one CPU worker,
which has nothing to split. So the runs here give the launchers the mesh of
a 4-card host, (2, 2), as four CPU workers (``make_production_mesh``
patched to name four CPU devices): the serve launcher's ``--mesh single
--tensor-parallel`` gives the single-process static engine's greedy tokens,
and the train launcher's the one-process run's losses within bf16's
rounding, for qwen2.5-3b and for the recurrent families (rwkv6-1.6b,
zamba2-2.7b). Then the refusals: ``--tensor-parallel`` without ``--mesh``,
on the family the split does not cover yet (whisper, naming its
``ROADMAP.md`` item), and the serving ``--mesh`` with a sampled or
non-static engine.

~70 s on one worker (four spawns of four gloo workers).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402

LOSS_RTOL = 2.0**-7  # bf16 (the smoke variant's compute dtype): the split sums round otherwise


@pytest.fixture
def four_cards(monkeypatch):
    """The production mesh of a 4-card host, as four CPU workers, and one
    intra-op thread a worker; yields the meshes the launchers made."""
    make, made = launch_mesh.make_production_mesh, []

    def four(multi_pod=False, devices=None):
        made.append(make(multi_pod=multi_pod, devices=["cpu"] * 4))
        return made[-1]

    monkeypatch.setattr(launch_mesh, "make_production_mesh", four)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield made
    torch.set_num_threads(old)


def test_serve_launcher_splits_over_a_four_card_mesh(four_cards, monkeypatch):
    from repro_torch.distributed import mesh_serve

    serve, calls = mesh_serve.serve_on_mesh, []

    def spy(mesh, runs, new_tokens, **kw):
        calls.append(kw["tensor_parallel"])
        return serve(mesh, runs, new_tokens, **kw)

    monkeypatch.setattr(mesh_serve, "serve_on_mesh", spy)
    flags = ["--engine", "static", "--device", "cpu", "--batch", "4", "--prompt-len", "6", "--new-tokens", "4",
             "--cache-len", "32"]
    want = serve_launcher.main(flags)
    got = serve_launcher.main(flags + ["--mesh", "single", "--tensor-parallel"])
    assert [m.shape for m in four_cards] == [{"data": 2, "model": 2}] and calls == [True]
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_train_launcher_splits_over_a_four_card_mesh(four_cards, monkeypatch):
    trainer, made = train_launcher.SEBSTrainer, []

    def spy(*args, **kw):
        made.append(trainer(*args, **kw))
        return made[-1]

    monkeypatch.setattr(train_launcher, "SEBSTrainer", spy)
    flags = ["--device", "cpu", "--b1", "4", "--c1", "16", "--rho", "2", "--seq", "8", "--steps-log", "1"]
    want = train_launcher.main(flags)
    got = train_launcher.main(flags + ["--mesh", "single", "--tensor-parallel"])
    assert [m.shape for m in four_cards] == [{"data": 2, "model": 2}]
    assert [t.tensor_parallel for t in made] == [False, True] and made[1].mesh is four_cards[0]
    assert len(got.losses) == len(want.losses) == 12
    assert got.batch_sizes == want.batch_sizes and got.stages == want.stages
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch,schedule,updates", [("rwkv6-1.6b", ["--c1", "4", "--stages", "1"], 1),
                                                   ("zamba2-2.7b", ["--c1", "16"], 12)])
def test_train_launcher_splits_the_recurrent_families(arch, schedule, updates, four_cards, monkeypatch):
    """``--tensor-parallel --arch`` rwkv6-1.6b or zamba2-2.7b on the 4-card
    host's (2, 2): the model groups split rwkv6's heads and channel mix,
    Mamba2's heads and zamba2's shared block; the losses are the
    data-parallel run's within bf16's rounding. rwkv6 smoke magnifies a
    rounding along its trajectory (in bf16 the second update's loss differs
    by 1.2% between the two runs' sums; in f32 its one-process run differs
    from itself by 1.5e-2 in ``grad_sq_big`` after 5 updates summed in
    another order, ``tests/test_torch_tp_recurrent.py``), so its launcher
    run takes one update."""
    trainer, made = train_launcher.SEBSTrainer, []

    def spy(*args, **kw):
        made.append(trainer(*args, **kw))
        return made[-1]

    monkeypatch.setattr(train_launcher, "SEBSTrainer", spy)
    flags = ["--device", "cpu", "--arch", arch, "--b1", "4", "--rho", "2", "--seq", "8", "--steps-log", "1",
             *schedule]
    want = train_launcher.main(flags)
    got = train_launcher.main(flags + ["--mesh", "single", "--tensor-parallel"])
    assert [m.shape for m in four_cards] == [{"data": 2, "model": 2}]
    assert [t.tensor_parallel for t in made] == [False, True]
    assert len(got.losses) == len(want.losses) == updates
    assert got.batch_sizes == want.batch_sizes and got.stages == want.stages
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)


@pytest.mark.parametrize("launcher,flags,reason", [
    ("serve", ["--engine", "static", "--tensor-parallel"], "it needs --mesh"),
    ("train", ["--tensor-parallel"], "it needs --mesh"),
    ("serve", ["--engine", "static", "--mesh", "single", "--tensor-parallel", "--arch", "whisper-tiny"],
     "ROADMAP.md Queue 1 item 6c"),
    ("train", ["--mesh", "single", "--tensor-parallel", "--arch", "whisper-tiny"], "ROADMAP.md Queue 1 item 6c"),
    ("serve", ["--engine", "paged", "--mesh", "single"], "it needs --engine static and --temperature 0"),
    ("serve", ["--engine", "static", "--mesh", "single", "--temperature", "0.8"],
     "it needs --engine static and --temperature 0"),
])
def test_launchers_refuse_what_they_cannot_split(launcher, flags, reason, capsys):
    main = serve_launcher.main if launcher == "serve" else train_launcher.main
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", *flags])
    assert e.value.code == 2
    assert reason in capsys.readouterr().err
