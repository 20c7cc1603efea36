"""The elastic trainer's processes on the CPU: the launcher's
``--dp-elastic`` runs to its end with the widths and comm counters of the
ladder, and a worker that raises, or hangs past the run's deadline or past
the process group's collective timeout, makes ``ElasticTrainer.run`` raise
within its deadline, with that worker's error in the message (the others
terminated)."""
import json
import time

import pytest

torch = pytest.importorskip("torch")

from _torch_dist_cases import FailingDataset, finite, port_cfg, port_trainer  # noqa: E402

CFG = port_cfg()


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_train_launcher_dp_elastic_runs_on_cpu(tmp_path, caplog):
    from repro_torch.launch import train as launcher

    with caplog.at_level("INFO", logger="train"):
        log = launcher.main(["--device", "cpu", "--dp-elastic", "--device-budget", "2", "--b1", "4", "--c1", "16",
                             "--rho", "2", "--stages", "3", "--seq", "8", "--steps-log", "1",
                             "--log-json", str(tmp_path / "log.json")])
    assert log.batch_sizes == [4] * 4 + [8] * 4 + [16] * 4 and finite(log.losses)
    # width 1 moves nothing; from stage 1 on every update all-gathers the partials
    assert log.sync_events == [0] * 4 + list(range(1, 9))
    assert log.comm_bytes[3] == 0 and log.comm_bytes[-1] > log.comm_bytes[4] > 0
    assert json.loads((tmp_path / "log.json").read_text())["sync_events"] == log.sync_events
    assert "comm: 8 sync events" in caplog.text and "widths [1, 2]" in caplog.text


@pytest.mark.parametrize("how", ["raises", "hangs_past_the_deadline", "hangs_past_the_collective_timeout"])
def test_failing_worker_makes_run_raise(how):
    ds = FailingDataset(CFG.vocab_size, 8, rank=1, at=8, hang=how != "raises")
    kw = {"raises": dict(deadline=120), "hangs_past_the_deadline": dict(deadline=10),
          "hangs_past_the_collective_timeout": dict(deadline=120, collective_timeout=12)}[how]
    tr, st = port_trainer(2, dataset=ds, **kw)
    t0 = time.monotonic()
    expect = {"raises": (RuntimeError, "planted failure in worker 1"),
              "hangs_past_the_deadline": (TimeoutError, "did not finish within 10"),
              "hangs_past_the_collective_timeout": (RuntimeError, "worker rank 0 failed")}[how]
    with pytest.raises(expect[0], match=expect[1]):
        tr.run(st, log_every=1)
    assert time.monotonic() - t0 < 100
