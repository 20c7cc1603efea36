"""The card measurements' tracing (``tools/cardbench.py``): a traced run that
comes back with no device record is traced again, its inputs prepared anew
each time, and raises only after its last attempt. The trace itself needs a
card, so these tests stand in for one traced run."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cardbench():
    spec = importlib.util.spec_from_file_location("cardbench_under_test", ROOT / "tools" / "cardbench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stand_in(results):
    """A stand-in for one traced run: runs ``run()``, records it and gives
    the next of ``results``."""
    calls = []

    def trace_once(run, tmp_dir, pad_s=None):
        run()
        calls.append(run)
        return results[len(calls) - 1]

    return trace_once, calls


@pytest.mark.parametrize("empty", [0, 1, 2])
def test_empty_traces_are_taken_again(cardbench, monkeypatch, tmp_path, empty):
    trace = {"busy_ms": 1.0, "by_kernel": {}}
    trace_once, calls = _stand_in([None] * empty + [trace])
    monkeypatch.setattr(cardbench, "_trace_once", trace_once)
    prepared = []

    def run():
        pass

    assert cardbench.device_trace(run, tmp_path, prepare=lambda: prepared.append(len(calls))) is trace
    assert calls == [run] * (empty + 1)
    assert prepared == list(range(empty + 1))  # before each attempt, none after


def test_a_trace_that_stays_empty_raises(cardbench, monkeypatch, tmp_path):
    trace_once, calls = _stand_in([None] * 3)
    monkeypatch.setattr(cardbench, "_trace_once", trace_once)
    with pytest.raises(RuntimeError, match="no device activity in 3 attempts"):
        cardbench.device_trace(lambda: None, tmp_path)
    assert len(calls) == 3


def test_device_ms_reads_the_retried_trace(cardbench, monkeypatch, tmp_path):
    trace = {"busy_ms": 6.0, "by_kernel": {"k": (3.0, 3)}}
    trace_once, calls = _stand_in([None, trace])
    monkeypatch.setattr(cardbench, "_trace_once", trace_once)
    runs = []
    ms, per = cardbench.device_ms(lambda x: runs.append(x), [(1,), (2,)], 3, tmp_path)
    assert (ms, per) == (2.0, {"k": 1.0})
    assert len(calls) == 2
    assert runs == [1, 2] + [1, 2, 1] * 2  # warm-up, then the traced loop on each attempt


def test_device_ms_times_with_events_when_traces_stay_empty(cardbench, monkeypatch, tmp_path):
    trace_once, calls = _stand_in([None] * 3)
    monkeypatch.setattr(cardbench, "_trace_once", trace_once)
    monkeypatch.setattr(cardbench, "timed", lambda fn, arg_sets, iters: 0.25)
    ms, per = cardbench.device_ms(lambda x: None, [(1,)], 4, tmp_path)
    assert (ms, per) == (0.25, {cardbench.EVENTS_ONLY: 0.25})
    assert len(calls) == 3  # every attempt was made first

