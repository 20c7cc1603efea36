"""The port's disaggregated engine under pool pressure against the JAX
package's (``kernel="xla"``), on the CPU, in float32 with the JAX weights
carried over by ``repro_torch.bridge``: tests/test_disagg_serve.py's
``_pressure_pair`` pools (prefill fits about one prompt at a time, decode
about one resident request), on five fixed seeds of its random workloads,
one engine pair an arch reused across ``run()`` calls. Greedy tokens and the
host stats must be equal.

On the recurrent families (rwkv6, zamba2) a transfer that waits at the seam
while its prefill slot is admitted again (and its state row zeroed) must
still adopt its own state: the export copies the row, it is not a view of
the prefill pool. A separate case makes that happen and checks it did.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_disagg_cases import (  # noqa: E402
    PRESSURE,
    assert_drained,
    host_stats,
    models,
    pressure_workload,
    serve,
)

from repro.serve import DisaggregatedEngine as JaxDisagg  # noqa: E402
from repro_torch.serve import DisaggregatedEngine, PagedContinuousBatchingEngine  # noqa: E402

ARCHS = ["qwen2.5-3b", "rwkv6-1.6b", "zamba2-2.7b"]
# five fixed seeds in the JAX property test's range [0, 10000]
SEEDS = [int(s) for s in np.random.default_rng(23).integers(0, 10_001, 5)]
_PAIRS: dict = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pair(arch):
    """(JAX engine, port engine) with the pressure pools, built once an arch."""
    if arch not in _PAIRS:
        jmodel, jparams, tmodel, tparams = models(arch)
        _PAIRS[arch] = (JaxDisagg(jmodel, jparams, kernel="xla", **PRESSURE),
                        DisaggregatedEngine(tmodel, tparams, device="cpu", **PRESSURE))
    return _PAIRS[arch]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_pressure_matches_jax(arch, seed):
    jax_engine, engine = _pair(arch)
    prompts, budgets = pressure_workload(seed, engine.model.cfg.vocab_size)
    jax_engine.reset_stats()
    engine.reset_stats()
    expect, got = serve(jax_engine, prompts, budgets), serve(engine, prompts, budgets)
    for i, (a, b) in enumerate(zip(expect, got)):
        np.testing.assert_array_equal(
            b, a, err_msg=f"seed {seed} request {i} (len {len(prompts[i])}, budget {budgets[i]})")
    assert host_stats(engine) == host_stats(jax_engine)
    assert engine.memory_stats() == jax_engine.memory_stats()
    assert_drained(engine)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_state_row_survives_a_wait_at_the_seam(arch):
    """Six prompts through one prefill slot and a one-slot decode ring: the
    transfers queue at the seam while the prefill slot is admitted again
    (its state row zeroed, then prefilled with the next prompt). Every
    request's tokens must still equal the port's paged engine's and JAX's
    disaggregated engine's."""
    jmodel, jparams, tmodel, tparams = models(arch)
    kw = dict(cache_len=32, max_slots=1, page_size=4, prefill_chunks=(4,))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tmodel.cfg.vocab_size, n).astype(np.int32) for n in (6, 9, 5, 8, 7, 4)]
    budgets = [6] * len(prompts)
    engine = DisaggregatedEngine(tmodel, tparams, prefill_slots=1, device="cpu", **kw)
    waits = []
    admit = engine._admit_prefill

    def admit_and_record(pslots, i, req, plan):
        waits.append(len(engine.transfers))
        admit(pslots, i, req, plan)

    engine._admit_prefill = admit_and_record
    got = serve(engine, prompts, budgets)
    assert max(waits) >= 2, f"no transfer waited at the seam while the prefill slot was reused: {waits}"
    single = serve(PagedContinuousBatchingEngine(tmodel, tparams, device="cpu", **kw), prompts, budgets)
    expect = serve(JaxDisagg(jmodel, jparams, kernel="xla", prefill_slots=1, **kw), prompts, budgets)
    for i, (a, b, c) in enumerate(zip(expect, got, single)):
        np.testing.assert_array_equal(b, c, err_msg=f"request {i} against the port's paged engine")
        np.testing.assert_array_equal(b, a, err_msg=f"request {i} against JAX's disaggregated engine")
    assert_drained(engine)
