"""Shared set-up of the disaggregated-serving tests of the port
(tests/test_torch_disagg.py, tests/test_torch_disagg_pressure.py): each
family's smoke config in float32, the JAX weights carried over by
``repro_torch.bridge``, the JAX suite's prompts and pressure pools, and the
host stats the two packages' engines must agree on."""
import jax
import numpy as np

from repro.configs import get_config as jax_config
from repro.models import build_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import LanguageModel

# the stats both packages' engines keep on the host, equal after a run
STATS = ("transfers", "pages_streamed", "pages_adopted", "prefix_tokens_reused", "prompt_tokens_total",
         "prefill_chunks", "prefill_tokens_computed", "cow_copies", "ticks", "decoded_tokens", "peak_width",
         "seam_bytes")

_MODELS: dict = {}


def models(arch):
    """(jax model, jax params, port model, port params) on ``arch`` smoke in
    float32, the port's params the JAX ones carried over; built once a
    process and shared by every test file in it, so a caller that would
    change them (a train step updates in place, JAX's donates) takes copies."""
    if arch not in _MODELS:
        jcfg = jax_config(arch, "smoke").replace(compute_dtype="float32")
        jmodel = build_model(jcfg)
        jparams, _ = jmodel.init(jax.random.key(0))
        tcfg = get_config(arch, "smoke").replace(compute_dtype="float32")
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
        _MODELS[arch] = (jmodel, jparams, LanguageModel(tcfg), tparams)
    return _MODELS[arch]


def shared_prefix_prompts(vocab, n=6, prefix_len=9, suffix_len=3, seed=0):
    """tests/test_disagg_serve.py's ``_shared_prefix_prompts``: ``n`` prompts
    sharing a 9-token prefix, then the prefix alone (a fully cached prompt)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len)
    out = [np.asarray(np.concatenate([prefix, rng.integers(0, vocab, suffix_len)]), np.int32)
           for _ in range(n)]
    out.append(np.asarray(prefix, np.int32))
    return out


# tests/test_disagg_serve.py's ``_pressure_pair`` pools: prefill fits about
# one prompt at a time (admission requeues), decode about one resident
# request (transfers wait at the seam)
PRESSURE = dict(cache_len=32, max_slots=2, page_size=4, prefill_chunks=(4,), prefill_slots=2,
                num_pages=10, prefill_pages=5)


def pressure_workload(seed, vocab):
    """test_disagg_identity_under_pressure_random_workloads' draw for
    ``seed``: 2-6 prompts of a random shared prefix and suffix, budgets 1-5."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, rng.integers(0, 9))
    prompts, budgets = [], []
    for _ in range(int(rng.integers(2, 7))):
        take = int(rng.integers(0, len(prefix) + 1)) if len(prefix) else 0
        suffix = rng.integers(0, vocab, int(rng.integers(1, 9)))
        prompts.append(np.concatenate([prefix[:take], suffix]).astype(np.int32))
        budgets.append(int(rng.integers(1, 6)))
    return prompts, budgets


def serve(engine, prompts, budgets):
    """Submit, run, and the streams in submission order."""
    ids = [engine.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    out = engine.run()
    assert set(out) == set(ids), "a requeued or queued-transfer request was dropped"
    return [out[i] for i in ids]


def host_stats(engine):
    stats = {key: engine.stats[key] for key in STATS}
    stats["stage_history"] = list(engine.stats["stage_history"])
    return stats


def assert_drained(engine):
    """Both pools consistent, and holding only what their indices hold."""
    for worker in (engine.prefill, engine.decode):
        worker.pool.check()
        held = worker.index.num_pages if worker.index is not None else 0
        assert worker.pool.used == held
    assert len(engine.transfers) == 0
