"""The paper's Table 1: parameter updates saved at ImageNet scale, as the
JAX package's ``benchmarks/table1_updates.py``.

The update counts are schedule accounting alone, derived exactly from the
port's schedule objects (``EpochStagewise`` under a ``StageController``):
n = 1,281,167 images, 90 epochs, b1 256, at epochs 30 and 60 the learning
rate divided by 10 (classical) or the batch multiplied by 12 (mSEBS):

    mSGD  : 450k updates          mSEBS : ~160k updates  (64% saved)

and the batch reaches 256 * 12**2 = 36,864 after epoch 60 (the paper: "mSEBS
scales the batch size to 36k"). Nothing runs on a device.

    python -m repro_torch.experiments.table1_updates [--out DIR]
"""
from __future__ import annotations

from typing import List

from repro_torch.core.schedules import EpochStagewise
from repro_torch.core.stages import StageController
from repro_torch.experiments._records import DEFAULT_OUT, Record, cli, print_csv, write_json

N_IMAGENET = 1_281_167
EPOCHS = 90
BOUNDARIES = (30, 60)
B1 = 256
RHO = 12
PAPER_CLAIM = {"classical": 450_000, "msebs": 160_000, "saving": 0.64, "final_batch": 36_864}


def run(out_dir: str = DEFAULT_OUT) -> List[Record]:
    common = dict(b1=B1, eta1=0.1, epoch_size=N_IMAGENET, boundaries_epochs=BOUNDARIES, total_epochs=EPOCHS)
    classical = EpochStagewise(rho=10, mode="classical", **common)
    msebs = EpochStagewise(rho=RHO, mode="sebs", **common)
    u_cls = StageController(classical, mode="reshape").total_updates()
    u_sebs = StageController(msebs, mode="reshape").total_updates()
    final_batch = msebs.info(61 * N_IMAGENET).batch_size
    saving = 1.0 - u_sebs / u_cls
    write_json(out_dir, "table1_updates.json", {"classical_updates": u_cls, "msebs_updates": u_sebs,
                                                "final_batch": final_batch, "saving": saving,
                                                "paper_claim": PAPER_CLAIM})
    derived = (f"classical={u_cls} msebs={u_sebs} final_batch={final_batch} "
               f"saving={saving:.3f} (paper: 450k/160k/36864/0.64)")
    ctx = {"paper_claim": dict(PAPER_CLAIM)}
    return [
        Record("table1_classical_updates", u_cls, "count", direction="exact", derived=derived, context=ctx),
        Record("table1_msebs_updates", u_sebs, "count", direction="exact", derived=derived, context=ctx),
        Record("table1_final_batch", final_batch, "samples", direction="exact", derived=derived, context=ctx),
        Record("table1_update_saving", saving, "ratio", direction="higher", derived=derived, context=ctx),
    ]


if __name__ == "__main__":
    print_csv(run(cli(__doc__.splitlines()[0], device=False).out))
