# The paper's primary contribution: the SEBS batch-size schedule system —
# schedules, stage controller, theory calculators, the noise-scale
# estimators and the SEBS trainer that drives the train step with
# stagewise-enlarged batches.
from repro_torch.core.noise_scale import AdaptiveSEBS, GradientNoiseScale
from repro_torch.core.schedules import (
    DBSGD,
    SEBS,
    ClassicalStagewise,
    EpochStagewise,
    Schedule,
    SmithBatch,
    StageInfo,
    WarmupConstant,
)
from repro_torch.core.stages import StageController, StepPlan
from repro_torch.core.theory import SEBSTheory, optimal_batch, optimal_ratio, psi_bound, psi_min
from repro_torch.core.trainer import SEBSTrainer, TrainLog

__all__ = [
    "SEBS",
    "ClassicalStagewise",
    "DBSGD",
    "EpochStagewise",
    "Schedule",
    "SmithBatch",
    "StageInfo",
    "WarmupConstant",
    "StageController",
    "StepPlan",
    "SEBSTheory",
    "optimal_batch",
    "optimal_ratio",
    "psi_bound",
    "psi_min",
    "SEBSTrainer",
    "TrainLog",
    "AdaptiveSEBS",
    "GradientNoiseScale",
]
