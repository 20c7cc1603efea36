"""The remat policies (``repro_torch/models/blocks.py``'s
``REMAT_POLICIES``, JAX's four names): each changes what the backward
pass keeps, never a value. Losses and gradients under every policy equal
``nothing_saveable``'s bit for bit, on qwen2.5-3b, zamba2-2.7b (the shared
block), dbrx-132b (the router's aux) and whisper-tiny (the encoder's
memory); each stays within the f32 tolerance (1e-4 of each leaf's norm)
of JAX's gradients under the same policy; and the bytes a microbatch's
forward leaves for its backward, counted on real CPU tensors, equal the
dry run's count on meta tensors, rising from ``nothing_saveable`` to
``dots_saveable``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.train.step import _grads_over_microbatches as jax_grads  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models.blocks import REMAT_POLICIES  # noqa: E402
from repro_torch.train.step import _grads_over_microbatches  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

TOL = 1e-4
ARCHS = ("qwen2.5-3b", "zamba2-2.7b", "dbrx-132b", "whisper-tiny")
POLICIES = ("dots_saveable", "dots_no_batch", "save_block_outputs")
_CASES: dict = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _case(arch):
    """(JAX's weights as numpy, the batch as numpy, the port's nothing_saveable
    loss and gradients)."""
    if arch not in _CASES:
        jcfg = jax_config(arch, "smoke").replace(compute_dtype="float32")
        tree = jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.key(0))[0])
        rng = np.random.default_rng(5)
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 13)).astype(np.int32)}
        if jcfg.is_encoder_decoder:
            batch["audio_embeds"] = rng.standard_normal((2, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
        _CASES[arch] = (tree, batch, _port_grads(arch, "nothing_saveable", tree, batch))
    return _CASES[arch]


def _port_grads(arch, policy, tree, batch):
    cfg = get_config(arch, "smoke").replace(compute_dtype="float32", remat_policy=policy)
    params = bridge.params_from_numpy(tree, cfg, device="cpu")
    for w in tree_leaves(params):
        w.requires_grad_(True)
    grads, metrics = _grads_over_microbatches(LanguageModel(cfg), params, {k: torch.from_numpy(v) for k, v in
                                                                            batch.items()}, 1, 0.0)
    return metrics["loss"].detach(), metrics["aux"].detach() if torch.is_tensor(metrics["aux"]) else metrics["aux"], grads


def test_every_jax_policy_name_is_a_port_policy():
    from repro.models.blocks import REMAT_POLICIES as JAX_POLICIES

    assert sorted(REMAT_POLICIES) == sorted(JAX_POLICIES)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_gives_nothing_saveables_bits(arch, policy):
    tree, batch, (loss, aux, grads) = _case(arch)
    got_loss, got_aux, got = _port_grads(arch, policy, tree, batch)
    assert torch.equal(got_loss, loss) and (got_aux == aux if not torch.is_tensor(aux) else torch.equal(got_aux, aux))
    assert len(got) == len(grads)
    assert all(torch.equal(a, b) for a, b in zip(got, grads))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_within_tolerance_of_jax_under_it(arch, policy):
    tree, batch, _ = _case(arch)
    jcfg = jax_config(arch, "smoke").replace(compute_dtype="float32", remat_policy=policy)
    jmodel = build_model(jcfg)
    jg, jm = jax.jit(lambda p, b: jax_grads(jmodel, p, b, 1, 0.0))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, got = _port_grads(arch, policy, tree, batch)
    expect = tree_leaves(bridge.params_from_numpy(jax.tree.map(np.asarray, jg), get_config(arch, "smoke"),
                                                  device="cpu"))
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=TOL)
    for g, e in zip(got, expect, strict=True):
        assert torch.linalg.vector_norm(g - e) <= TOL * torch.linalg.vector_norm(e) + 1e-9


@pytest.mark.parametrize("arch", ("qwen2.5-3b", "dbrx-132b", "whisper-tiny"))
def test_activation_bytes_on_cpu_equal_the_dry_runs(arch):
    """What one microbatch's forward keeps for its backward: the same bytes
    on real CPU tensors (the kernels' plain versions, whose inner products
    no policy keeps) as the dry run counts on meta ones."""
    seen = {}
    for policy in ("nothing_saveable",) + POLICIES:
        cfg = get_config(arch, "smoke").replace(compute_dtype="float32", remat_policy=policy)
        model = LanguageModel(cfg)
        counts = []
        for device in ("meta", "cpu"):
            params = model.init(0, device=device)
            batch = {"tokens": torch.zeros((2, 13), dtype=torch.int32, device=device)}
            if cfg.is_encoder_decoder:
                batch["audio_embeds"] = torch.zeros((2, cfg.encoder_seq, cfg.d_model), device=device)
            counts.append(dryrun.activation_bytes(model, params, batch))
        assert counts[0] == counts[1] > 0, (policy, counts)
        seen[policy] = counts[0]
    assert seen["nothing_saveable"] < seen["save_block_outputs"] < seen["dots_no_batch"] <= seen["dots_saveable"]
