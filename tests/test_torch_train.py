"""The port's training path against the JAX package's, on the CPU, on
qwen2.5-3b smoke in float32 with the JAX parameters carried over by
``repro_torch.bridge``: ``LanguageModel.forward`` logits and ``lm_loss``
(also with ``attn_chunk`` below S, so that JAX's ``_sdpa_chunked`` is
compared), gradients per leaf against ``jax.value_and_grad``, the
accumulated microbatch metrics, the optimizer state carried over by the
bridge, the data stream bit for bit, and a short SEBS run step for step.

Tolerances (f32, the same formulas summed in other orders): logits and
loss 1e-4; gradients 1e-4 of each leaf's norm; the SEBS run's losses 1e-4
relative after 12 updates. Stages, batch sizes, update and sample counts
and data rows must be identical.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import SEBS as JSEBS  # noqa: E402
from repro.core import SEBSTrainer as JTrainer  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.data import TokenDataset as JTokenDataset  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.loss import lm_loss as jax_lm_loss  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro.train.step import _grads_over_microbatches as jax_grads  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SEBS, SEBSTrainer  # noqa: E402
from repro_torch.data import DataPipeline, TokenDataset  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train.loss import lm_loss  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import _grads_over_microbatches  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

TOL = 1e-4


def _cfgs(**kw):
    return (jax_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32", **kw),
            get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32", **kw))


@pytest.fixture(scope="module")
def np_params():
    jcfg, _ = _cfgs()
    params, _ = build_model(jcfg).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    # non-zero biases and norm scales, so that the test sees them
    rng = np.random.default_rng(0)
    layer = tree["seg0"]["b0"]
    for name in ("bq", "bk", "bv"):
        layer["attn"][name] = rng.normal(size=layer["attn"][name].shape).astype(np.float32) * 0.1
    for name in ("norm1", "norm2"):
        layer[name]["scale"] = rng.normal(size=layer[name]["scale"].shape).astype(np.float32) * 0.1
    return tree


def _models(np_params, **kw):
    jcfg, tcfg = _cfgs(**kw)
    return (build_model(jcfg), jax.tree.map(jnp.asarray, np_params), LanguageModel(tcfg),
            bridge.params_from_numpy(np_params, tcfg, device="cpu"))


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("attn_chunk", [None, 8])
def test_forward_and_loss_match_jax(np_params, attn_chunk):
    """S = 33 is ragged for the kernel's tiles; with attn_chunk 8 and S = 32
    the JAX reference takes its query-chunked _sdpa_chunked."""
    jmodel, jparams, tmodel, tparams = _models(np_params, attn_chunk=attn_chunk)
    tokens = _tokens(2, 32 if attn_chunk else 33)
    jlogits, jaux = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tlogits, taux = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
        total, metrics = lm_loss(tmodel, tparams, {"tokens": torch.from_numpy(tokens)}, z_loss=1e-4)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    assert float(taux) == float(jaux) == 0.0
    jtotal, jmetrics = jax.jit(lambda p, b: jax_lm_loss(jmodel, p, b, z_loss=1e-4))(
        jparams, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=TOL)
    for key in ("loss", "aux", "tokens"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=TOL, atol=1e-7)


def _grad_leaves(np_grads, tcfg):
    return tree_leaves(bridge.params_from_numpy(jax.tree.map(np.asarray, np_grads), tcfg, device="cpu"))


@pytest.mark.parametrize("accum", [1, 3])
def test_grads_match_jax(np_params, accum):
    """Gradients per leaf (1e-4 of the leaf's norm) and the metrics over
    accumulated microbatches (grad_sq_small, then grad_sq_big of the mean)."""
    jmodel, jparams, tmodel, tparams = _models(np_params)
    tokens = _tokens(2 * accum, 17, seed=2)
    batch = tokens if accum == 1 else tokens.reshape(accum, 2, 17)
    jg, jm = jax.jit(lambda p, b: jax_grads(jmodel, p, b, accum, 0.0))(
        jparams, {"tokens": jnp.asarray(batch)})
    for w in tree_leaves(tparams):
        w.requires_grad_(True)
    tg, tm = _grads_over_microbatches(tmodel, tparams, {"tokens": torch.from_numpy(batch)}, accum, 0.0)
    expect = _grad_leaves(jg, tmodel.cfg)
    assert len(tg) == len(expect) == len(tree_leaves(tparams))
    for got, e in zip(tg, expect):
        assert got.shape == e.shape
        assert torch.linalg.vector_norm(got - e) <= TOL * torch.linalg.vector_norm(e) + 1e-9
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL)
    if accum > 1:
        np.testing.assert_allclose(float(tm["grad_sq_small"]), float(jm["grad_sq_small"]), rtol=TOL)
        big = sum(float(jnp.sum(jnp.square(x))) for x in jax.tree.leaves(jg))
        np.testing.assert_allclose(float(sum((g * g).sum() for g in tg)), big, rtol=TOL)


@pytest.mark.parametrize("name,hp", [("psgd", {"gamma": 1e4}), ("momentum", {}), ("adagrad_da", {})])
def test_bridged_optimizer_state_gives_the_same_next_update(np_params, name, hp):
    """A JAX state after one update (non-zero u, z, s2; an anchor unlike the
    params) crosses over; the next update at the same stage agrees."""
    _, tcfg = _cfgs()
    jopt, topt = jax_make_optimizer(name, **hp), make_optimizer(name, **hp)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jupdate = jax.jit(jopt.update)
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32), np_params)
             for _ in range(2)]
    jparams, jstate = jupdate(jax.tree.map(jnp.asarray, grads[0]), jopt.init(jparams), jparams,
                                  lr=jnp.float32(0.1), stage=jnp.int32(1))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tstate = bridge.opt_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg, device="cpu")
    assert tstate["stage"] == 1 and set(tstate) == set(jstate)
    jparams, jstate = jupdate(jax.tree.map(jnp.asarray, grads[1]), jstate, jparams,
                                  lr=jnp.float32(0.1), stage=jnp.int32(1))
    tparams, tstate = topt.update(_grad_leaves(grads[1], tcfg), tstate, tparams, lr=0.1, stage=1)
    expect = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    for got, e in zip(tree_leaves(tparams), tree_leaves(expect)):
        np.testing.assert_allclose(got.numpy(), e.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("seed,vocab,seq", [(0, 512, 32), (3, 151936, 64), (11, 1000, 7)])
def test_token_dataset_is_bit_exact(seed, vocab, seq):
    jds, tds = JTokenDataset(vocab, seq, seed), TokenDataset(vocab, seq, seed)
    jax_batch = jax.jit(lambda offset: jds.batch(offset, 4)["tokens"])
    for offset in (0, 4, 37, 1_000_003):
        got = tds.batch(offset, 4)["tokens"]
        assert got.dtype == np.int32 and got.shape == (4, seq + 1)
        np.testing.assert_array_equal(got, np.asarray(jax_batch(offset)))
    np.testing.assert_array_equal(tds.batch(0, 8)["tokens"][4:], tds.batch(4, 4)["tokens"])
    np.testing.assert_array_equal(tds.sample(5), tds.batch(5, 1)["tokens"][0])


def test_sebs_run_matches_jax(np_params):
    """The quickstart's shape with a small budget: b1 8, C1 32, rho 2, three
    stages (batches 8, 16, 32 by 1, 2 and 4 microbatches), seq 32, pSGD."""
    jmodel, jparams, tmodel, tparams = _models(np_params)
    sched = dict(b1=8, C1=32, rho=2.0, num_stages=3, eta=0.3)
    jopt, topt = jax_make_optimizer("psgd", gamma=1e4), make_optimizer("psgd", gamma=1e4)
    jtrainer = JTrainer(jmodel, jopt, JSEBS(**sched), JPipeline(JTokenDataset(512, 32, 0)),
                        microbatch=8, mode="accumulate", accum_mode="psum_each")
    _, jlog = jtrainer.run(JTrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32)),
                           log_every=1)
    ttrainer = SEBSTrainer(tmodel, topt, SEBS(**sched), DataPipeline(TokenDataset(512, 32, 0), "cpu"),
                           microbatch=8, mode="accumulate", accum_mode="psum_each")
    _, tlog = ttrainer.run(TrainState(tparams, topt.init(tparams), 0), log_every=1)
    for key in ("steps", "samples", "stages", "batch_sizes", "comm_bytes", "sync_events"):
        assert getattr(tlog, key) == getattr(jlog, key), key
    assert tlog.batch_sizes == [8] * 4 + [16] * 4 + [32] * 4
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=TOL)
    np.testing.assert_allclose(tlog.noise_scales, jlog.noise_scales, rtol=1e-2)
    assert tlog.losses[-1] < tlog.losses[0]


def test_trainer_refuses_a_checkpointer(np_params):
    _, _, tmodel, tparams = _models(np_params)
    opt = make_optimizer("sgd")
    trainer = SEBSTrainer(tmodel, opt, SEBS(b1=2, C1=2, rho=2.0, num_stages=1, eta=0.1),
                          DataPipeline(TokenDataset(512, 8, 0), "cpu"))
    with pytest.raises(NotImplementedError, match="checkpoint slice"):
        trainer.run(TrainState(tparams, opt.init(tparams), 0), checkpointer=object())
