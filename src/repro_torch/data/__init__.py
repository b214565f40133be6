"""The data pipeline (the JAX package's ``repro.data``)."""
from repro_torch.data import pipeline
from repro_torch.data.pipeline import SyntheticLM, make_loader

__all__ = ["pipeline", "SyntheticLM", "make_loader"]
