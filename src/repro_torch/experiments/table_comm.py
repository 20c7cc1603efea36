"""The paper's fewer-synchronizations table: gradient synchronizations under
elastic data parallelism, with the settings and records of the JAX
package's ``benchmarks/table_comm.py``.

Schedule and planner accounting only (no training): it walks every
optimizer update of three schedules at a MATCHED total-sample budget,

- ``sebs``: batch x rho per stage (the paper's Alg. 1),
- ``classical``: constant batch, learning rate / rho per stage,
- ``fixed``: constant batch, constant learning rate (mini-batch SGD),

through :class:`ElasticMeshPlanner` and :class:`SyncScheduler` in both sync
modes, and tabulates parameter updates, sync collectives and per-device
bytes per epoch. The payloads are the smoke model's (the f32 gradient tree
for exact mode; the float train-state leaves for local-SGD averaging).

``run`` asserts the paper's claim: at the same sample budget SEBS makes
STRICTLY fewer gradient synchronizations and updates than the classical
schedule, because stage s packs rho^s microbatches into each update.

    python -m repro_torch.experiments.table_comm [--device cpu] [--out DIR]
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import get_config
from repro_torch.core.schedules import SEBS, ClassicalStagewise, WarmupConstant
from repro_torch.core.stages import StageController
from repro_torch.distributed import CommAccountant, ElasticMeshPlanner, SyncScheduler, float_state_bytes, sync_cost
from repro_torch.experiments._records import Record, cli, print_csv, write_json
from repro_torch.models import LanguageModel
from repro_torch.optim import make_optimizer
from repro_torch.train.state import init_train_state
from repro_torch.utils.tree import tree_size

ARCH = "qwen2.5-3b"
MICRO = 8          # global microbatch b1
B1 = 64            # SEBS stage-0 batch (8 microbatches -> width 8 at budget 8)
RHO = 2.0
STAGES = 4
C1 = 960           # stage-0 sample budget; total = C1 * (1+2+4+8) = 14400
DEVICE_BUDGET = 8
LOCAL_INTERVAL = 4
EPOCHS = 5


def _schedules(eta: float = 0.1) -> dict:
    total = sum(int(round(C1 * RHO**s)) for s in range(STAGES))
    return {
        "sebs": SEBS(b1=B1, C1=C1, rho=RHO, num_stages=STAGES, eta=eta),
        "classical": ClassicalStagewise(b=B1, C1=C1, rho=RHO, num_stages=STAGES, eta1=eta),
        "fixed": WarmupConstant(b=B1, eta=eta, warmup_samples=0, total=total),
    }


def _payload_bytes(device) -> tuple:
    """(f32 gradient bytes, float train-state bytes) of the smoke model."""
    model = LanguageModel(get_config(ARCH, "smoke"))
    state = init_train_state(model, make_optimizer("momentum", beta=0.9), seed=0, device=device)
    return tree_size(state.params) * 4, float_state_bytes(state)


def account(schedule, mode: str, grad_bytes: int, state_bytes: int, epochs: int = 1) -> CommAccountant:
    """Walk every update of ``epochs`` passes over the schedule's sample
    budget, and ledger what each sync mode would move. Each epoch replays
    the schedule from stage 0 with fresh update and sync counters, so per
    epoch x epochs == totals exactly. The per-update costs come from the
    :func:`sync_cost` the trainer records; stage-boundary reshards are left
    out (O(stages), and the same for the schedules compared)."""
    # accounting only: no worker starts, so placeholders stand in for the devices
    planner = ElasticMeshPlanner(device_budget=DEVICE_BUDGET, devices=["cpu"] * DEVICE_BUDGET)
    scheduler = SyncScheduler(mode=mode, local_interval=LOCAL_INTERVAL)
    acct = CommAccountant()
    for _ in range(epochs):
        controller = StageController(schedule, microbatch=MICRO)
        update = last_sync = 0
        for plan in controller.plans():
            mp = planner.plan_for(plan)
            update += 1
            synced = mode == "exact" or mp.width == 1 or scheduler.due(update, last_sync, plan.stage)
            if synced:
                collectives, bytes_moved = sync_cost("exact" if mp.width == 1 else mode, mp.width,
                                                     grad_bytes=grad_bytes, state_bytes=state_bytes)
                acct.record_update(plan.stage, collectives=collectives, bytes_moved=bytes_moved)
                last_sync = update
            else:
                acct.record_update(plan.stage)
    return acct


def run(out_dir: str = "chiprun_out/experiments", device="cuda") -> List[Record]:
    grad_bytes, state_bytes = _payload_bytes(device)
    records: List[Record] = []
    details = {
        "arch": ARCH, "microbatch": MICRO, "b1": B1, "rho": RHO, "stages": STAGES,
        "device_budget": DEVICE_BUDGET, "epochs": EPOCHS, "local_interval": LOCAL_INTERVAL,
        "grad_payload_bytes": grad_bytes, "state_payload_bytes": state_bytes,
        "byte_model": "per-device: ring all-gather (W-1)*B (exact), ring all-reduce 2*(W-1)/W*B (local)",
        "results": {},
    }
    for name, schedule in _schedules().items():
        for mode in ("exact", "local"):
            acct = account(schedule, mode, grad_bytes, state_bytes, epochs=EPOCHS)
            entry = {
                "updates": acct.total("updates"),
                "sync_events": acct.total("sync_events"),
                "bytes_per_device": acct.total("bytes"),
                "per_epoch": {
                    "updates": acct.total("updates") // EPOCHS,
                    "sync_events": acct.total("sync_events") // EPOCHS,
                    "bytes_per_device": acct.total("bytes") // EPOCHS,
                },
                "per_stage": acct.summary(),
            }
            for field in ("updates", "sync_events", "bytes_per_device"):
                assert entry["per_epoch"][field] * EPOCHS == entry[field], (name, mode, field)
            details["results"][f"{name}_{mode}"] = entry
            derived = (f"updates={entry['updates']} syncs={entry['sync_events']} "
                       f"MiB/dev/epoch={entry['per_epoch']['bytes_per_device'] / 2**20:.1f}")
            ctx = {"epochs": EPOCHS, "per_epoch": entry["per_epoch"]}
            for field, unit in (("updates", "count"), ("sync_events", "count"), ("bytes_per_device", "bytes")):
                records.append(Record(f"table_comm_{name}_{mode}_{field}", entry[field], unit,
                                      direction="exact", derived=derived, context=ctx))
    sebs, cls = details["results"]["sebs_exact"], details["results"]["classical_exact"]
    # the paper's claim: fewer updates, hence strictly fewer syncs
    assert sebs["sync_events"] < cls["sync_events"], (sebs, cls)
    assert sebs["updates"] < cls["updates"], (sebs, cls)
    details["sebs_sync_saving_vs_classical"] = 1.0 - sebs["sync_events"] / cls["sync_events"]
    records.append(Record(
        "table_comm_sebs_sync_saving_vs_classical", details["sebs_sync_saving_vs_classical"], "ratio",
        direction="higher",
        derived=(f"sebs syncs {sebs['sync_events']} vs classical {cls['sync_events']} "
                 f"({details['sebs_sync_saving_vs_classical']:.0%} fewer at matched samples)"),
        context={"sebs_syncs": sebs["sync_events"], "classical_syncs": cls["sync_events"]},
    ))
    write_json(out_dir, "table_comm.json", details)
    return records


if __name__ == "__main__":
    args = cli(__doc__.splitlines()[0])
    print_csv(run(args.out, args.device))
