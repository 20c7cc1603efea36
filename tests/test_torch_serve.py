"""The port's paged continuous-batching engine against the JAX package's
(``kernel="xla"``) on qwen2.5-3b smoke in float32, on the CPU: greedy token
streams must be equal, and so must the scheduling stats (prefix reuse,
copy-on-write copies, prefill chunks, ticks) and the memory accounting.
The weights are the JAX engine's, carried over by ``repro_torch.bridge``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serve import PagedContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.serve import PagedContinuousBatchingEngine  # noqa: E402

STATS = ("prefix_tokens_reused", "cow_copies", "prefill_chunks", "ticks", "decoded_tokens",
         "prefill_tokens_computed", "peak_width")


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    jmodel = build_model(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    tcfg = get_config("qwen2.5-3b", "smoke").replace(compute_dtype="float32")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, LanguageModel(tcfg), tparams


def _prompts(prefix_len, n=4, vocab=512):
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, prefix_len)
    return [np.concatenate([prefix, rng.integers(0, vocab, 4 + i)]).astype(np.int32)
            for i in range(n)]


def _run(engine, prompts, **req):
    ids = [engine.submit(p, max_new_tokens=6, **req) for p in prompts]
    out = engine.run()
    engine.pool.check()
    return [out[i] for i in ids]


CASES = {
    # the settings of tests/test_paged_decode_kernel.py::_engine_tokens: a
    # page-aligned shared prefix, one chunk bucket
    "aligned_prefix": (8, dict(cache_len=64, max_slots=2, page_size=4, prefill_chunks=(4,))),
    # a prefix ending inside a page (copy-on-write), two chunk buckets and
    # a stagewise admission ramp from one slot
    "cow_ramp": (6, dict(cache_len=64, max_slots=2, b1=1, rho=2.0, patience=2, page_size=4,
                         prefill_chunks=(4, 8))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_greedy_matches_jax(weights, case):
    jmodel, jparams, tmodel, tparams = weights
    prefix_len, kw = CASES[case]
    prompts = _prompts(prefix_len)
    jax_engine = JaxEngine(jmodel, jparams, kernel="xla", seed=0, **kw)
    engine = PagedContinuousBatchingEngine(tmodel, tparams, seed=0, device="cpu", **kw)
    expect, got = _run(jax_engine, prompts), _run(engine, prompts)
    for i, (a, b) in enumerate(zip(expect, got)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
    for key in STATS:
        assert engine.stats[key] == jax_engine.stats[key], key
    assert engine.stats["prefix_tokens_reused"] > 0
    if case == "cow_ramp":
        assert engine.stats["cow_copies"] > 0
    assert engine.memory_stats() == jax_engine.memory_stats()


def test_sampled_stream_follows_the_seed(weights):
    """Sampling noise comes from the engine's generator: the same seed gives
    the same tokens, another seed other tokens; every token is in the
    vocabulary."""
    _, _, tmodel, tparams = weights
    kw = dict(cache_len=64, max_slots=2, page_size=4, prefill_chunks=(4,), device="cpu")
    prompts = _prompts(8)
    runs = [_run(PagedContinuousBatchingEngine(tmodel, tparams, seed=s, **kw), prompts,
                 temperature=1.0, top_k=50) for s in (0, 0, 1)]
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, c) for a, c in zip(runs[0], runs[2]))
    for row in runs[0]:
        assert row.min() >= 0 and row.max() < tmodel.cfg.vocab_size


def test_engine_rejects_params_on_another_device(weights):
    _, _, tmodel, tparams = weights
    with pytest.raises(ValueError, match="params are on"):
        PagedContinuousBatchingEngine(tmodel, tparams, device="meta")


def test_launcher_serves_on_cpu():
    results = launcher.main(["--engine", "paged", "--device", "cpu", "--requests", "3",
                             "--prompt-len", "12", "--shared-prefix", "8", "--new-tokens", "5",
                             "--cache-len", "64", "--chunk", "4", "--page-size", "4"])
    assert sorted(results) == [0, 1, 2]
    assert all(len(row) == 12 + 5 for row in results.values())


@pytest.mark.parametrize("engine", ["static", "continuous", "disagg"])
def test_launcher_names_the_later_slice(engine, capsys):
    with pytest.raises(SystemExit):
        launcher.main(["--engine", engine, "--device", "cpu"])
    assert "comes with" in capsys.readouterr().err
