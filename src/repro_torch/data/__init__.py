"""The synthetic LM data pipeline (numpy; ``pipeline``)."""
from .pipeline import SyntheticLMData, make_batch_iterator

__all__ = ["SyntheticLMData", "make_batch_iterator"]
