from repro_torch.roofline.analysis import HW, RooflineTerms, roofline_from_summary
from repro_torch.roofline.collectives import CollectiveLog

__all__ = ["CollectiveLog", "RooflineTerms", "roofline_from_summary", "HW"]
