from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import TokenDataset

__all__ = ["TokenDataset", "DataPipeline"]
