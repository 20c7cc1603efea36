"""The sharded step's layer-by-layer gather and shard-slice exchange
(``repro_torch/distributed/sharded.py``), on the CPU:

- the dry run's per-rank peak for qwen2.5-3b smoke on a (2, 2) meta mesh
  grows from 2 to 4 layers by no more than two layers' activations and
  shards (the growth of the activations and of the argument bytes), less
  than the two layers' whole f32 weights that whole-leaf gathering held;
- the dry run's train_4k counts on the (16, 16) mesh: qwen2.5-3b's peak
  under 12 GB and its collective bytes under 381 GB (JAX's compiled step's
  figure), dbrx-132b's peak under 80 GB, arctic-480b's under 300 GB, their
  argument bytes as before;
- four gloo workers on a (2, 2) mesh, with fewer computing ranks than
  ranks (1 of 4 at 4 microbatches; 2 of 4 at 2 each, through the host
  slots and through the device exchange's code), equal the elastic step's
  whole run bit for bit at clip 1.0: metrics, shards of the params and of
  the momentum;
- a stored shard is a copy of its slice, never a view of the whole leaf;
- ``TreeFeed`` adds as ``span_tree_sum`` does; the loss's fused backward
  has the bits of autograd's ``logsumexp`` and ``gather`` backwards.

About 45 s on one worker; the card test runs with `pytest --noconftest -m gpu`.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_layer_cases import sharded_vs_whole_worker  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.distributed.step import TreeFeed, span_tree_sum  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.train.loss import _LseAndLabel  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _at_depth(cfg, repeat: int):
    return cfg.replace(segments=tuple(dataclasses.replace(s, repeat=repeat) for s in cfg.segments))


def test_peak_grows_by_layers_activations_and_shards():
    """Two more layers add their activations, their shards of the params
    and the momentum (the arguments) and of the summed gradient (f32, as the
    params): less than their whole f32 weights and gradients, which
    whole-leaf gathering held at once."""
    cfg = get_config("qwen2.5-3b", "smoke")
    shape = InputShape("t", 64, 8, "train")
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    mems, grad_shards = {}, {}
    for r in (2, 4):
        model = LanguageModel(_at_depth(cfg, r))
        mems[r] = dryrun.count_combo(model.cfg, shape, mesh)["memory"]
        params = model.abstract_init()
        grad_shards[r] = dryrun.state_argument_bytes(TrainState(params, {}, 0), mesh, model.param_axes())
    grew = mems[4]["peak_bytes_per_device"] - mems[2]["peak_bytes_per_device"]
    acts = mems[4]["activation_bytes_per_microbatch"] - mems[2]["activation_bytes_per_microbatch"]
    shards = mems[4]["argument_bytes_per_device"] - mems[2]["argument_bytes_per_device"] + grad_shards[4] \
        - grad_shards[2]
    whole = sum(4 * t.numel() for t in tree_leaves(LanguageModel(_at_depth(cfg, 2)).abstract_init()["seg0"]))
    assert 0 < grew <= acts + shards < 2 * whole


@pytest.mark.parametrize("arch,peak_gb,collective_gb", [("qwen2.5-3b", 12, 381), ("dbrx-132b", 80, None),
                                                        ("arctic-480b", 300, None)])
def test_train_4k_fits_its_target(arch, peak_gb, collective_gb):
    summary = dryrun.run_combo(arch, "train_4k", False)
    mem = summary["memory"]
    args = {"qwen2.5-3b": 96_811_024, "dbrx-132b": 4_095_462_416, "arctic-480b": 14_909_956_624}
    assert mem["argument_bytes_per_device"] == args[arch]
    assert mem["peak_bytes_per_device"] < peak_gb * 1e9
    if collective_gb is not None:
        assert 0 < summary["collectives"]["total_bytes"] < collective_gb * 1e9


@pytest.mark.parametrize("width,local_accum,device_exchange", [(1, 4, False), (2, 2, False), (2, 2, True)])
def test_fewer_computing_ranks_equal_the_whole_run(tmp_path, width, local_accum, device_exchange):
    torch.multiprocessing.spawn(sharded_vs_whole_worker, args=(4, str(tmp_path), width, local_accum,
                                                               device_exchange), nprocs=4, join=True)
    assert all((tmp_path / f"ok_{r}").exists() for r in range(4))


def test_a_shard_is_a_copy_of_its_slice():
    """A shard sliced along the leading dimension (contiguous, so a view
    would do) is a copy of it: stored between updates, it does not keep
    the whole leaf's storage alive."""
    from repro_torch.distributed.sharded import own_shard
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.sharding import named_sharding

    full = torch.arange(64.0).reshape(8, 8)
    sharding = named_sharding(make_data_mesh(4, ["cpu"] * 4), ("embed", None), full.shape)
    shard = own_shard(full, sharding, 1)
    assert torch.equal(shard, full[2:4]) and shard.untyped_storage().nbytes() == shard.numel() * 4


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_tree_feed_adds_as_span_tree_sum(n):
    cat = lambda a, b: f"({a}+{b})"  # noqa: E731
    feed = TreeFeed(n, cat)
    out = [feed.push(str(i)) for i in range(n)]
    assert out[:-1] == [None] * (n - 1) and out[-1] == span_tree_sum(str, n, cat)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_fused_loss_backward_keeps_autograds_bits(z_loss):
    gen = torch.Generator().manual_seed(0)
    base = torch.randn((2, 9, 70), generator=gen) * 4
    labels = torch.randint(0, 70, (2, 9), generator=gen)
    mask = torch.ones(2, 9)
    mask[:, -1] = 0.0
    seen = []
    for fused in (False, True):
        logits = base.clone().requires_grad_(True)
        if fused:
            lse, true = _LseAndLabel.apply(logits, labels)
        else:
            lse, true = torch.logsumexp(logits, -1), logits.gather(-1, labels[..., None])[..., 0]
        loss = ((lse - true) * mask).sum() / mask.sum() + z_loss * (lse.square() * mask).sum() / mask.sum()
        loss.backward()
        seen.append((loss.detach(), logits.grad))
    assert torch.equal(seen[0][0], seen[1][0]) and torch.equal(seen[0][1], seen[1][1])


@pytest.mark.gpu
def test_fused_loss_backward_keeps_autograds_bits_on_the_card():
    """As above on the card, at qwen2.5-3b's vocabulary over 4 x 513 positions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the loss's bits are held on the card's kernels")
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = torch.randn((4, 513, 151_936), generator=gen, device="cuda") * 4
    labels = torch.randint(0, 151_936, (4, 513), generator=gen, device="cuda")
    mask = torch.ones(4, 513, device="cuda")
    mask[:, -1] = 0.0
    seen = []
    for fused in (False, True):
        logits = base.clone().requires_grad_(True)
        if fused:
            lse, true = _LseAndLabel.apply(logits, labels)
        else:
            lse, true = torch.logsumexp(logits, -1), logits.gather(-1, labels[..., None])[..., 0]
        loss = ((lse - true) * mask).sum() / mask.sum() + 1e-4 * (lse.square() * mask).sum() / mask.sum()
        loss.backward()
        seen.append((loss.detach(), logits.grad))
        del logits, lse, true, loss
    assert torch.equal(seen[0][0], seen[1][0]) and torch.equal(seen[0][1], seen[1][1])
