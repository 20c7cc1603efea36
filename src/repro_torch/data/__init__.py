from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import ImageClassDataset, QuadraticProblem, TokenDataset, make_batch_iterator

__all__ = ["TokenDataset", "QuadraticProblem", "ImageClassDataset", "DataPipeline", "make_batch_iterator"]
