"""The port's runtime sanitizers (``repro_torch.analysis.sanitize``) against
the JAX package's (``repro.analysis.sanitize``), on the CPU: the cases of
tests/test_analysis.py's runtime-sanitizer section run through both modules
with the same outcome and the same message; and the hooks in the port's
engines and trainer under ``REPRO_SANITIZE=1``: a planted page refcount
drift in the paged engine and in each disaggregated worker, a stray decode
width in the continuous engine, a planted NaN loss in ``SEBSTrainer``
(raising at the same update, with the same message, as the JAX package's
hooks), and with the variable unset no audit runs at all.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_disagg_cases import models  # noqa: E402

import repro.serve.engine as jax_engine_module  # noqa: E402
from repro.analysis import sanitize as jax_sanitize  # noqa: E402
from repro.core import SEBS as JSEBS  # noqa: E402
from repro.core import SEBSTrainer as JTrainer  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.data import TokenDataset as JTokenDataset  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.serve import DisaggregatedEngine as JaxDisagg  # noqa: E402
from repro.serve import PagedContinuousBatchingEngine as JaxPaged  # noqa: E402
from repro.serve import pages as jax_pages  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
import repro_torch.serve.engine as engine_module  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.core import SEBS, SEBSTrainer  # noqa: E402
from repro_torch.data import DataPipeline, TokenDataset  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine,
    DisaggregatedEngine,
    PagedContinuousBatchingEngine,
)
from repro_torch.serve import pages  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402

# -- tests/test_analysis.py's cases, through either module -----------------


class _FakeStep:
    def __init__(self, n=1):
        self._n = n

    def _cache_size(self):
        return self._n


class _FakeAdmission:
    def __init__(self, ladder):
        self.ladder = ladder


class _FakeEngine:
    def __init__(self, widths=(2, 4), ladder=(2, 4, 8), chunks=(32,), sizes=()):
        self.admission = _FakeAdmission(list(ladder))
        self._decodes = {w: _FakeStep() for w in widths}
        self.prefill_chunks = tuple(chunks)
        self._chunk_steps = {s: _FakeStep() for s in sizes}
        self.decode_compiles = len(self._decodes)
        self.prefill_compiles = len(self._chunk_steps)


class _FakeTracer:
    def __init__(self, enabled=True, events_total=0, depth=0):
        self.enabled = enabled
        self.events_total = events_total
        self.depth = depth


def _nan_loss(s, p):
    s.check_finite_update({"loss": float("nan")}, update=7, stage=2)


def _inf_grad_norm(s, p):
    s.check_finite_update({"loss": 0.1, "grad_norm": float("inf")}, update=1, stage=0)


def _finite_and_unknown(s, p):
    s.check_finite_update({"loss": 1.25, "grad_norm": 0.5}, update=3, stage=1)
    s.check_finite_update({"other": object()}, update=1, stage=0)


def _consistent_pool(s, p):
    pool = p.PagePool(12, 4)
    index = p.RadixPrefixIndex(pool)
    plan = p.plan_admission(pool, index, [1, 2, 3, 4, 5], 8, share=True)
    s.audit_page_pool(pool, index, [plan], where="(test)")


def _refcount_drift(s, p):
    pool = p.PagePool(12, 4)
    plan = p.plan_admission(pool, None, [1, 2, 3, 4, 5], 8, share=False)
    pool.refs[plan.new_pages[0]] += 1  # seeded corruption: a leaked retain
    s.audit_page_pool(pool, None, [plan], where="(test)")


def _broken_structure(s, p):
    pool = p.PagePool(8, 2)
    pool._free.append(pool._free[-1])  # double entry on the free list
    s.audit_page_pool(pool, None, [], where="(test)")


def _declared_buckets(s, p):
    s.audit_engine_compiles(_FakeEngine(widths=(2, 4), sizes=(32,)))


def _stray_width(s, p):
    s.audit_engine_compiles(_FakeEngine(widths=(2, 3)))


def _recompile_storm(s, p):
    eng = _FakeEngine(widths=(2,))
    eng._decodes[2] = _FakeStep(n=5)
    s.audit_engine_compiles(eng)


def _undeclared_chunk(s, p):
    s.audit_engine_compiles(_FakeEngine(chunks=(32,), sizes=(32, 64)))


def _compile_counter(s, p):
    eng = _FakeEngine(widths=(2,))
    with s.compile_counter(eng) as ctr:
        eng._decodes[4] = _FakeStep()
        eng.decode_compiles += 1
    assert ctr.new_compiles == 1
    eng._decodes[3] = _FakeStep()  # stray width: audited at exit
    with s.compile_counter(eng):
        pass


def _clean_tracers(s, p):
    s.audit_tracer(_FakeTracer(enabled=True, events_total=100, depth=0))
    s.audit_tracer(_FakeTracer(enabled=False, events_total=0, depth=0))


def _disabled_tracer_with_events(s, p):
    s.audit_tracer(_FakeTracer(enabled=False, events_total=3), where="(t)")


def _unbalanced_spans(s, p):
    s.audit_tracer(_FakeTracer(enabled=True, events_total=9, depth=2))


CASES = {f.__name__.lstrip("_"): f for f in (
    _nan_loss, _inf_grad_norm, _finite_and_unknown, _consistent_pool, _refcount_drift, _broken_structure,
    _declared_buckets, _stray_width, _recompile_storm, _undeclared_chunk, _compile_counter, _clean_tracers,
    _disabled_tracer_with_events, _unbalanced_spans)}
# what tests/test_analysis.py expects of each case that raises
RAISES = {"nan_loss": "update 7", "inf_grad_norm": "grad_norm", "refcount_drift": "refcount drift",
          "broken_structure": "structure broken", "stray_width": "outside the admission ladder",
          "recompile_storm": "5 executables", "undeclared_chunk": "prefill_chunks",
          "compile_counter": "outside the admission ladder", "disabled_tracer_with_events":
          "disabled tracer recorded 3", "unbalanced_spans": "2 span"}


def _outcome(case, module, pages_module):
    try:
        CASES[case](module, pages_module)
    except module.SanitizerError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", sorted(CASES))
def test_sanitizer_matches_jax(case):
    expect = _outcome(case, jax_sanitize, jax_pages)
    got = _outcome(case, sanitize, pages)
    assert got == expect
    if case in RAISES:
        assert got is not None and RAISES[case] in got
    else:
        assert got is None


def test_enabled_is_env_gated(monkeypatch):
    for value, on in ((None, False), ("0", False), ("", False), ("1", True), ("yes", True)):
        if value is None:
            monkeypatch.delenv("REPRO_SANITIZE", raising=False)
        else:
            monkeypatch.setenv("REPRO_SANITIZE", value)
        assert sanitize.enabled() is on is jax_sanitize.enabled()


def test_sanitizer_error_is_an_assertion_error():
    assert issubclass(sanitize.SanitizerError, AssertionError)


# -- the hooks --------------------------------------------------------------


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _prompts(vocab=512):
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, vocab, 8)
    return [np.concatenate([prefix, rng.integers(0, vocab, 3 + i)]).astype(np.int32) for i in range(3)]


def _leaky(release, pool_of=None):
    """``release_pages`` that keeps one reference too many, on the first
    release (of the pool ``pool_of()`` names, when given)."""
    state = {"leaked": False}

    def release_pages(pool, page_ids):
        if not state["leaked"] and (pool_of is None or pool is pool_of()):
            state["leaked"] = True
            page_ids = list(page_ids)[:-1]
        release(pool, page_ids)

    return release_pages


def _drift(engine, monkeypatch, module, prompts, pool_of=None):
    """The SanitizerError that ``engine.run()`` raises with one leaked
    reference planted in ``module``'s ``release_pages``."""
    monkeypatch.setattr(module, "release_pages", _leaky(module.release_pages,
                                                        pool_of and (lambda: pool_of(engine))))
    for p in prompts:
        engine.submit(p, max_new_tokens=3)
    with pytest.raises(AssertionError) as info:
        engine.run()
    monkeypatch.undo()
    return info.value


KW = dict(cache_len=32, max_slots=2, page_size=4, prefill_chunks=(4,))


def test_paged_engine_catches_a_leaked_reference(monkeypatch):
    jmodel, jparams, tmodel, tparams = models("qwen2.5-3b")
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    got = _drift(PagedContinuousBatchingEngine(tmodel, tparams, device="cpu", **KW), monkeypatch,
                 engine_module, _prompts())
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    expect = _drift(JaxPaged(jmodel, jparams, kernel="xla", **KW), monkeypatch, jax_engine_module, _prompts())
    assert isinstance(got, sanitize.SanitizerError)
    assert str(got).startswith("page refcount drift after release(slot ")
    assert str(got) == str(expect)


@pytest.mark.parametrize("worker", ["prefill", "decode"])
def test_disagg_workers_catch_a_leaked_reference(worker, monkeypatch):
    jmodel, jparams, tmodel, tparams = models("qwen2.5-3b")
    where = {"prefill": "after export(slot ", "decode": "after decode release(slot "}[worker]
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    got = _drift(DisaggregatedEngine(tmodel, tparams, device="cpu", **KW), monkeypatch, engine_module,
                 _prompts(), pool_of=lambda e: getattr(e, worker).pool)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    expect = _drift(JaxDisagg(jmodel, jparams, kernel="xla", **KW), monkeypatch, jax_engine_module, _prompts(),
                    pool_of=lambda e: getattr(e, worker).pool)
    assert isinstance(got, sanitize.SanitizerError)
    assert str(got).startswith(f"page refcount drift {where}")
    assert str(got) == str(expect)


def test_continuous_engine_audits_its_decode_steps(monkeypatch):
    _, _, tmodel, tparams = models("qwen2.5-3b")
    engine = ContinuousBatchingEngine(tmodel, tparams, cache_len=32, max_slots=2, device="cpu")
    engine._decodes[3] = engine._decode_for(2)  # a step for a width outside the ladder [2]
    engine.submit(_prompts()[0], max_new_tokens=2)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    with pytest.raises(sanitize.SanitizerError, match=r"decode executables \(run end\) for widths \[3\]"):
        engine.run()


def _jax_state(jparams, jopt):
    """A JAX train state on copies of the shared weights (its step donates them)."""
    jparams = jax.tree.map(jnp.copy, jparams)
    return JTrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))


def _state(tparams, topt):
    """A train state on copies of the shared weights (the updates write in place)."""
    tparams = tree_map(torch.clone, tparams)
    return TrainState(tparams, topt.init(tparams), 0)


def _nan_at(trainer, update, nan):
    """Wrap ``trainer._execute``: update ``update`` reports a NaN loss."""
    execute, calls = trainer._execute, []

    def planted(state, batch, plan):
        state, metrics = execute(state, batch, plan)
        calls.append(plan.stage)
        return state, (dict(metrics, loss=nan) if len(calls) == update else metrics)

    trainer._execute = planted
    return calls


def test_trainer_nan_tripwire_fires_where_jax_does(monkeypatch):
    jmodel, jparams, tmodel, tparams = models("qwen2.5-3b")
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    sched = dict(b1=2, C1=4, rho=2.0, num_stages=3, eta=0.3)
    jopt, topt = jax_make_optimizer("psgd", gamma=1e4), make_optimizer("psgd", gamma=1e4)
    jtrainer = JTrainer(jmodel, jopt, JSEBS(**sched), JPipeline(JTokenDataset(512, 8, 0)))
    jcalls = _nan_at(jtrainer, 5, jnp.float32(np.nan))
    with pytest.raises(jax_sanitize.SanitizerError) as expect:
        jtrainer.run(_jax_state(jparams, jopt), log_every=1)
    ttrainer = SEBSTrainer(tmodel, topt, SEBS(**sched), DataPipeline(TokenDataset(512, 8, 0), "cpu"))
    tcalls = _nan_at(ttrainer, 5, torch.tensor(float("nan")))
    with pytest.raises(sanitize.SanitizerError) as got:
        ttrainer.run(_state(tparams, topt), log_every=1)
    assert str(got.value) == str(expect.value)
    assert str(got.value).startswith("non-finite loss=nan at update 5 (stage ")
    assert tcalls == jcalls and len(tcalls) == 5  # stopped at the update that went wrong


def test_unset_variable_runs_no_audit(monkeypatch):
    """With REPRO_SANITIZE unset the hooks cost one ``enabled()`` call: no
    audit runs in the engines or the trainer, even with a leak planted."""
    _, _, tmodel, tparams = models("qwen2.5-3b")
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert not sanitize.enabled()

    def audited(*args, **kwargs):
        raise AssertionError("an audit ran with REPRO_SANITIZE unset")

    for name in ("audit_page_pool", "audit_engine_compiles", "audit_tracer", "check_finite_update"):
        monkeypatch.setattr(sanitize, name, audited)
    for engine in (PagedContinuousBatchingEngine(tmodel, tparams, device="cpu", **KW),
                   DisaggregatedEngine(tmodel, tparams, device="cpu", **KW),
                   ContinuousBatchingEngine(tmodel, tparams, cache_len=32, max_slots=2, device="cpu")):
        for p in _prompts():
            engine.submit(p, max_new_tokens=3)
        assert len(engine.run()) == 3
    topt = make_optimizer("psgd", gamma=1e4)
    trainer = SEBSTrainer(tmodel, topt, SEBS(b1=2, C1=4, rho=2.0, num_stages=2, eta=0.3),
                          DataPipeline(TokenDataset(512, 8, 0), "cpu"))
    _nan_at(trainer, 2, torch.tensor(float("nan")))
    _, log = trainer.run(_state(tparams, topt), log_every=1)
    assert len(log.losses) == 4 and np.isnan(log.losses[1])


def test_hooks_pass_a_clean_run(monkeypatch):
    """Under REPRO_SANITIZE=1 a clean run of each engine and of the trainer
    raises nothing (every audit finds what it expects)."""
    _, _, tmodel, tparams = models("qwen2.5-3b")
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    calls = []
    audit = sanitize.audit_page_pool

    def recorded(*args, **kwargs):
        calls.append(kwargs["where"])
        audit(*args, **kwargs)

    monkeypatch.setattr(sanitize, "audit_page_pool", recorded)
    for engine in (PagedContinuousBatchingEngine(tmodel, tparams, device="cpu", **KW),
                   DisaggregatedEngine(tmodel, tparams, device="cpu", **KW),
                   ContinuousBatchingEngine(tmodel, tparams, cache_len=32, max_slots=2, device="cpu")):
        for p in _prompts():
            engine.submit(p, max_new_tokens=3)
        assert len(engine.run()) == 3
    for where in ("after admit(slot", "after publish(slot", "after release(slot", "after prefill admit(slot",
                  "after export(slot", "after adopt(slot", "after decode release(slot"):
        assert any(w.startswith(where) for w in calls), where
    topt = make_optimizer("psgd", gamma=1e4)
    trainer = SEBSTrainer(tmodel, topt, SEBS(b1=2, C1=4, rho=2.0, num_stages=2, eta=0.3),
                          DataPipeline(TokenDataset(512, 8, 0), "cpu"))
    _, log = trainer.run(_state(tparams, topt), log_every=1)
    assert all(np.isfinite(log.losses))
