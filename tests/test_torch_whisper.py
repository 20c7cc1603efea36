"""The port's whisper path against the JAX package's, on whisper-tiny smoke
(2 + 2 layers, d 128, 2 heads of 64, 64 audio frames) in float32 on the
CPU, with the JAX parameters carried over by ``repro_torch.bridge``: the
cross-attention layer and block, the non-causal encoder (the port's flash
plain version against JAX's ``_sdpa``, also at whisper's 1,500 frames,
where ``1500 % attn_chunk != 0``), logits, loss and gradients through
remat (the encoder's and the cross-attention's leaves included), the
dense prefill and decode against the forward, the greedy tokens of the
three engines with per-request audio, a SEBS run whose batches carry
``audio_embeds``, checkpoints written by either package and resumed by the
other, the paged engine's pool-pressure and one-page cases, and both
launchers' refusals.

Tolerances (f32, the same formulas summed in other orders): layers, logits
and losses 1e-4; gradients 1e-4 of each leaf's norm; greedy tokens and
engine stats exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_engine_cases import CASES, run_engine_case  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import SEBS as JSEBS  # noqa: E402
from repro.core import SEBSTrainer as JTrainer  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.layers import attention as jattention  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxContinuous  # noqa: E402
from repro.serve import PagedContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro.train.loss import lm_loss as jax_lm_loss  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro.train.step import _grads_over_microbatches as jax_grads  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SEBS, SEBSTrainer  # noqa: E402
from repro_torch.data import DataPipeline, TokenDataset  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.layers import attention  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine, PagedContinuousBatchingEngine, ServeEngine  # noqa: E402
from repro_torch.train.loss import lm_loss  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import _grads_over_microbatches  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

TOL = 1e-4
ARCH = "whisper-tiny"
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, where torch's default of one thread a core oversubscribes
    the host."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _spread(tree, seed=0):
    """Non-default norm scales (the JAX init leaves them at 1)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        for name, sub in node.items():
            if isinstance(sub, dict) and "scale" in sub and name.startswith("norm"):
                sub["scale"] = (1 + 0.1 * rng.standard_normal(sub["scale"].shape)).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub)

    walk(tree)
    return tree


def _models(**cfg_kw):
    """(jax model, jax params, port model, port params, numpy tree), made
    once per configuration."""
    key = tuple(sorted(cfg_kw.items()))
    if key not in _MODELS:
        jcfg = jax_config(ARCH, "smoke").replace(compute_dtype="float32", **cfg_kw)
        tcfg = get_config(ARCH, "smoke").replace(compute_dtype="float32", **cfg_kw)
        jmodel = build_model(jcfg)
        tree = _spread(jax.tree.map(np.asarray, jmodel.init(jax.random.key(0))[0]))
        _MODELS[key] = (jmodel, jax.tree.map(jnp.asarray, tree), LanguageModel(tcfg),
                        bridge.params_from_numpy(tree, tcfg, device="cpu"), tree)
    return _MODELS[key]


def _close(out, expect, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(expect, np.float32),
                               atol=tol, rtol=tol)


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s)).astype(np.int32)


def _audio(b, t=64, d=128, seed=2):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(np.float32)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def test_model_builds_with_the_encoder_and_cross_attention():
    """The whisper tree: an ``encoder`` segment of ``encoder_layers`` layers and
    its norm beside the decoder, each decoder block with ``norm_cross`` and a
    ``cross_attn`` that has no QKV bias; at full width the port's init holds
    the JAX package's parameter count."""
    jmodel, _, tmodel, tparams, tree = _models()
    assert len(tparams["encoder"]["b0"]) == 2 and "encoder_norm" in tparams
    block = tparams["seg0"]["b0"][0]
    assert {"norm1", "attn", "norm_cross", "cross_attn", "norm2", "mlp"} <= set(block)
    assert set(block["cross_attn"]) == {"wq", "wk", "wv", "wo"}
    full = get_config(ARCH, "full")
    port_count = sum(w.numel() for w in tree_leaves(LanguageModel(full).init(0, device="cpu")))
    jax_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax.eval_shape(lambda: build_model(jax_config(ARCH, "full")).init(jax.random.key(0))[0])))
    assert port_count == jax_count


def test_cross_attention_layer_and_block_match_jax():
    """``attention.apply`` with ``memory`` (K and V from the memory, no RoPE,
    an all-true mask) and the cross block (self-attention, then the cross
    attention over the memory, then the FFN); without a memory the block
    skips its cross attention, as in JAX."""
    jmodel, _, tmodel, tparams, tree = _models()
    layer = jax.tree.map(lambda a: a[0], tree["seg0"]["b0"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 128)).astype(np.float32)
    mem = rng.standard_normal((2, 11, 128)).astype(np.float32)
    pos = np.arange(7)[None, :]
    jy, _ = jattention.apply(layer["cross_attn"], jnp.asarray(x), jmodel.cfg, positions=jnp.asarray(pos),
                             causal=False, memory=jnp.asarray(mem))
    tblock = tparams["seg0"]["b0"][0]
    with torch.no_grad():
        ty, _ = attention.apply(tblock["cross_attn"], torch.from_numpy(x), tmodel.cfg,
                                positions=torch.from_numpy(pos), memory=torch.from_numpy(mem))
    _close(ty, jy)
    spec = jmodel.cfg.segments[0].body[0]
    for memory in (mem, None):
        jx, _, _ = jblocks.apply_block(layer, jnp.asarray(x), jmodel.cfg, spec, positions=jnp.asarray(pos),
                                       memory=None if memory is None else jnp.asarray(memory))
        with torch.no_grad():
            tx, _, _ = blocks.apply_block(tblock, torch.from_numpy(x), tmodel.cfg, spec,
                                          positions=torch.from_numpy(pos),
                                          memory=None if memory is None else torch.from_numpy(memory))
        _close(tx, jx)


@pytest.mark.parametrize("frames", [64, 1500])
def test_encoder_matches_jax(frames):
    """The non-causal encoder: the port's flash plain version against the
    JAX package's ``_sdpa``, at the smoke's 64 frames and at whisper's
    1,500 (not a multiple of ``attn_chunk``, so JAX runs ``_sdpa`` over the
    whole sequence). At 1,500 frames the residual stream reaches ~19 and
    both packages stand ~1e-4 from the same encoder run in float64 (JAX
    7.0e-5, the port 1.1e-4 after the second block), so there the
    absolute tolerance is 1e-4 of the output's largest magnitude."""
    jmodel, jparams, tmodel, tparams, _ = _models(encoder_seq=frames)
    audio = _audio(1, frames)
    jmem = jax.jit(jmodel._encode)(jparams, {"audio_embeds": jnp.asarray(audio)})
    with torch.no_grad():
        tmem = tmodel._encode(tparams, {"audio_embeds": torch.from_numpy(audio)})
    assert tmem.shape == (1, frames, 128) and tmem.dtype == torch.float32
    atol = TOL * (float(jnp.abs(jmem).max()) if frames > 64 else 1.0)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), atol=atol, rtol=TOL)


def test_forward_and_loss_match_jax():
    jmodel, jparams, tmodel, tparams, _ = _models()
    tokens, audio = _tokens(2, 17), _audio(2)
    jbatch = {"tokens": jnp.asarray(tokens), "audio_embeds": jnp.asarray(audio)}
    tbatch = {"tokens": torch.from_numpy(tokens), "audio_embeds": torch.from_numpy(audio)}
    jlogits, _ = jax.jit(jmodel.forward)(jparams, jbatch)
    jtotal, _ = jax.jit(lambda p, b: jax_lm_loss(jmodel, p, b, z_loss=1e-4))(jparams, jbatch)
    with torch.no_grad():
        tlogits, _ = tmodel.forward(tparams, tbatch)
        total, _ = lm_loss(tmodel, tparams, tbatch, z_loss=1e-4)
    _close(tlogits, jlogits)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=TOL)


def test_train_step_grads_match_jax():
    """Gradients per leaf (1e-4 of the leaf's norm) over two microbatches
    that carry ``audio_embeds`` beside ``tokens``, through the remat'd
    decoder and encoder blocks: the encoder's leaves get their gradient
    through every decoder block's cross attention."""
    jmodel, jparams, tmodel, tparams, _ = _models()
    assert tmodel.cfg.remat
    tokens, audio = _tokens(4, 17, seed=3).reshape(2, 2, 17), _audio(4, seed=4).reshape(2, 2, 64, 128)
    jg, jm = jax.jit(lambda p, b: jax_grads(jmodel, p, b, 2, 0.0))(
        jparams, {"tokens": jnp.asarray(tokens), "audio_embeds": jnp.asarray(audio)})
    leaves = [w.detach().clone().requires_grad_(True) for w in tree_leaves(tparams)]
    params = _rebuild(tparams, iter(leaves))
    tg, tm = _grads_over_microbatches(
        tmodel, params, {"tokens": torch.from_numpy(tokens), "audio_embeds": torch.from_numpy(audio)}, 2, 0.0)
    expect_tree = bridge.params_from_numpy(jax.tree.map(np.asarray, jg), tmodel.cfg, device="cpu")
    expect = tree_leaves(expect_tree)
    assert len(tg) == len(expect) == len(leaves)
    for got, e in zip(tg, expect):
        assert got.shape == e.shape
        assert torch.linalg.vector_norm(got - e) <= TOL * torch.linalg.vector_norm(e) + 1e-9
    # the leaves only the audio reaches have a gradient
    for leaf in (expect_tree["encoder"]["b0"][0]["attn"]["wq"], expect_tree["seg0"]["b0"][0]["cross_attn"]["wk"]):
        assert torch.linalg.vector_norm(leaf) > 0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL)


def test_prefill_and_decode_match_the_forward():
    """A dense prefill of 6 tokens with the memory, then three decode steps
    with it, give the forward's logits at each position; ``prefill`` encodes
    the batch's audio when it is given no memory, and the result is the
    same."""
    _, _, tmodel, tparams, _ = _models()
    tokens, audio = _tokens(2, 9, seed=5), torch.from_numpy(_audio(2, seed=6))
    with torch.no_grad():
        full, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens), "audio_embeds": audio})
        memory = tmodel._encode(tparams, {"audio_embeds": audio})
        cache = tmodel.init_cache(2, 16, dtype=torch.float32, device="cpu")
        logits, cache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens[:, :6])}, cache, memory=memory)
        _close(logits[:, 0], full[:, 5])
        again, _ = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens[:, :6]), "audio_embeds": audio},
                                  tmodel.init_cache(2, 16, dtype=torch.float32, device="cpu"))
        _close(again, logits, 1e-6)
        for i in range(6, 9):
            logits, cache = tmodel.decode_step(tparams, torch.from_numpy(tokens[:, i:i + 1]), cache, i,
                                               memory=memory)
            _close(logits[:, 0], full[:, i])


def test_forward_requires_audio_embeds():
    _, _, tmodel, tparams, _ = _models()
    with pytest.raises(ValueError, match="audio_embeds"):
        tmodel.forward(tparams, {"tokens": torch.from_numpy(_tokens(1, 4))})


def test_engines_greedy_match_jax():
    """Per-request audio through the static, continuous (a 1 → 2 slot ramp)
    and paged engines: tokens equal JAX's, as tests/test_paged_serve.py
    holds the JAX engines to each other; prefix sharing stays off for an
    encoder-decoder model; a missing memory raises JAX's error."""
    jmodel, jparams, tmodel, tparams, _ = _models()
    prompts = _tokens(3, 5, seed=7)
    mem = _audio(3, seed=8)
    static = JaxServe(jmodel, jparams, cache_len=32).generate(prompts, max_new_tokens=5, memory=jnp.asarray(mem))
    got = ServeEngine(tmodel, tparams, cache_len=32, device="cpu").generate(
        prompts, max_new_tokens=5, memory=torch.from_numpy(mem))
    np.testing.assert_array_equal(got, static)
    with pytest.raises(ValueError, match="requires audio memory"):
        ServeEngine(tmodel, tparams, cache_len=32, device="cpu").generate(prompts, max_new_tokens=5)
    runs = []
    kw = dict(cache_len=32, max_slots=2)
    paged_kw = dict(kw, page_size=4, prefill_chunks=(4,))
    for engines in ((JaxContinuous(jmodel, jparams, b1=1, patience=1, **kw),
                     ContinuousBatchingEngine(tmodel, tparams, b1=1, patience=1, device="cpu", **kw)),
                    (JaxEngine(jmodel, jparams, kernel="xla", seed=0, **paged_kw),
                     PagedContinuousBatchingEngine(tmodel, tparams, seed=0, device="cpu", **paged_kw))):
        streams = []
        for engine, put in zip(engines, (jnp.asarray, torch.from_numpy)):
            ids = [engine.submit(p, max_new_tokens=5, memory=put(mem[i:i + 1])) for i, p in enumerate(prompts)]
            out = engine.run()
            streams.append(np.stack([out[i] for i in ids]))
            with pytest.raises(ValueError, match="requires per-request audio memory"):
                engine.submit(prompts[0], max_new_tokens=2)
        np.testing.assert_array_equal(streams[1], streams[0])
        np.testing.assert_array_equal(streams[1][:, :5], prompts)
        runs.append(engines)
    (jcont, tcont), (jpaged, tpaged) = runs
    assert tcont.stats["peak_width"] == jcont.stats["peak_width"] == 2
    assert not tpaged.prefix_sharing
    for key in ("ticks", "decoded_tokens", "prefill_chunks", "prefill_tokens_computed"):
        assert tpaged.stats[key] == jpaged.stats[key], key


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_engine_cases_match_jax(case):
    jmodel, jparams, tmodel, tparams, _ = _models()
    run_engine_case(case, JaxEngine, PagedContinuousBatchingEngine, jmodel, jparams, tmodel, tparams,
                    memories=[_audio(1, seed=20 + i) for i in range(4)])


class AudioRows:
    """``TokenDataset`` rows with audio embeddings beside them: row ``i``'s
    (T, d) frames from ``default_rng((seed, i))``, pure in the sample
    index like its tokens."""

    def __init__(self, seq_len, frames=64, d=128, seed=0):
        self.tokens = TokenDataset(512, seq_len, seed)
        self.frames, self.d, self.seed = frames, d, seed

    def batch(self, offset, batch_size):
        audio = np.stack([np.random.default_rng((self.seed, offset + i)).standard_normal((self.frames, self.d))
                          for i in range(batch_size)]).astype(np.float32)
        return {**self.tokens.batch(offset, batch_size), "audio_embeds": audio}


def _sebs(pkg):
    return pkg(b1=2, C1=4, rho=2.0, num_stages=2, eta=0.3)  # batches 2, 2, 4, 4


def _jax_trainer():
    jmodel, _, _, _, tree = _models()
    jparams = jax.tree.map(jnp.asarray, tree)  # fresh buffers: the trainer donates them
    jopt = jax_make_optimizer("psgd", gamma=1e4)
    trainer = JTrainer(jmodel, jopt, _sebs(JSEBS), JPipeline(AudioRows(12)),
                       microbatch=2, mode="accumulate", accum_mode="psum_each")
    return trainer, JTrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))


def _port_trainer():
    _, _, tmodel, _, tree = _models()
    params = bridge.params_from_numpy(tree, tmodel.cfg, device="cpu")  # a fresh copy: updates in place
    opt = make_optimizer("psgd", gamma=1e4)
    trainer = SEBSTrainer(tmodel, opt, _sebs(SEBS), DataPipeline(AudioRows(12), "cpu"),
                          microbatch=2, mode="accumulate", accum_mode="psum_each")
    return trainer, TrainState(params, opt.init(params), 0)


_JAX_LOG: list = []


def _jax_log():
    if not _JAX_LOG:
        trainer, state = _jax_trainer()
        _JAX_LOG.append(trainer.run(state, log_every=1)[1])
    return _JAX_LOG[0]


def test_sebs_run_with_audio_matches_jax():
    """Four SEBS updates with pSGD (batches 2, 2, 4, 4; the last two of two
    microbatches): each batch's ``audio_embeds`` split into microbatches
    beside its tokens."""
    jlog = _jax_log()
    trainer, state = _port_trainer()
    _, tlog = trainer.run(state, log_every=1)
    assert tlog.batch_sizes == jlog.batch_sizes == [2, 2, 4, 4] and tlog.stages == jlog.stages
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=TOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_the_packages(writer, tmp_path):
    """A checkpoint after update 2 written by one package, resumed by the
    other: the encoder segment restacks and unstacks by ``encoder_layers``,
    and the resumed losses stay within 1e-4 relative of JAX's uninterrupted
    run."""
    jlog = _jax_log()
    first, second = ((_jax_trainer, JCheckpointManager), (_port_trainer, CheckpointManager))
    if writer == "port":
        first, second = second, first
    trainer, state = first[0]()
    with first[1](str(tmp_path)) as ckpt:
        trainer.run(state, log_every=1, checkpointer=ckpt, save_every=2, stop_after_updates=2)
    trainer, state = second[0]()
    with second[1](str(tmp_path)) as ckpt:
        _, log = trainer.run(state, log_every=1, checkpointer=ckpt, save_every=2, resume=True)
    assert log.stages == jlog.stages and log.batch_sizes == jlog.batch_sizes
    np.testing.assert_allclose(log.losses, jlog.losses, rtol=TOL)


def test_launchers_refuse_whisper_naming_the_audio(capsys):
    """The launchers make no audio, as the JAX launchers make none: each
    engine of the serve launcher and the train launcher stop with an error
    that names the missing input."""
    for engine in ("static", "continuous", "paged"):
        with pytest.raises(SystemExit):
            serve_launcher.main(["--engine", engine, "--device", "cpu", "--arch", ARCH])
        assert "audio memory" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        train_launcher.main(["--device", "cpu", "--arch", ARCH])
    assert "audio_embeds" in capsys.readouterr().err
