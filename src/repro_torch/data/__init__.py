"""Data pipeline of the port (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import DataConfig, SyntheticLMData

__all__ = ["DataConfig", "SyntheticLMData"]
