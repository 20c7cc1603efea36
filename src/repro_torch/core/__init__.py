# Only the schedules are ported so far: the serving scheduler's admission
# ramp reads SEBS off them.
from repro_torch.core.schedules import SEBS, Schedule

__all__ = ["SEBS", "Schedule"]
