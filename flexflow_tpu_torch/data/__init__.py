"""Data feeding for the port (counterpart of ``flexflow_tpu/data``)."""

from .dataloader import PrefetchLoader, synthetic_dataset

__all__ = ["PrefetchLoader", "synthetic_dataset"]
