"""Two paged-engine cases that each family's port test file runs against the
JAX package's engine (``kernel="xla"``) on its smoke config in float32:

- ``pool_pressure``: a pool of five usable pages for two slots. Requests
  that find no pages are requeued until a release; the budgets mix a
  one-token prompt, a request that ends at its first token and prompts
  that span pages;
- ``one_page``: a pool of one usable page and a one-token prompt with
  ``max_new_tokens=1``, which ends on the tick that starts it.

Tokens, the engine stats and the memory accounting must be equal.
"""
import numpy as np

STATS = ("prefix_tokens_reused", "prefill_chunks", "ticks", "decoded_tokens",
         "prefill_tokens_computed", "peak_width", "cow_copies")

CASES = {
    "pool_pressure": (dict(num_pages=6), ((1, 3), (6, 1), (8, 4), (5, 2))),
    "one_page": (dict(num_pages=2), ((1, 1),)),
}


def run_engine_case(case, jax_engine_cls, port_engine_cls, jmodel, jparams, tmodel, tparams,
                    vocab=512, memories=None):
    """Runs ``case`` through both engines; ``memories`` (one (1, T, d) array
    a request) is an encoder-decoder model's audio, given to JAX as a jax
    array and to the port as a tensor."""
    import jax.numpy as jnp
    import torch

    pool, budgets = CASES[case]
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, vocab, n).astype(np.int32), new) for n, new in budgets]
    kw = dict(cache_len=32, max_slots=2, page_size=4, prefill_chunks=(4,), seed=0, **pool)
    engines = (jax_engine_cls(jmodel, jparams, kernel="xla", **kw),
               port_engine_cls(tmodel, tparams, device="cpu", **kw))
    streams = []
    for engine, put in zip(engines, (jnp.asarray, torch.from_numpy)):
        extra = [{} if memories is None else {"memory": put(memories[i])} for i in range(len(reqs))]
        ids = [engine.submit(p, max_new_tokens=new, **x) for (p, new), x in zip(reqs, extra)]
        out = engine.run()
        engine.pool.check()
        streams.append([out[i] for i in ids])
    for i, (a, b) in enumerate(zip(*streams)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
        assert len(b) == len(reqs[i][0]) + reqs[i][1]
    for key in STATS:
        assert engines[1].stats[key] == engines[0].stats[key], key
    assert engines[1].memory_stats() == engines[0].memory_stats()
    assert engines[1].memory_stats()["pages_peak"] == pool["num_pages"] - 1  # the pool ran full
