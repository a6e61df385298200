"""Data feeding for the port (counterpart of ``flexflow_tpu/data``)."""

from .dataloader import (DataLoader, PrefetchLoader, SingleDataLoader,
                         load_numpy_dataset, synthetic_dataset)

__all__ = ["DataLoader", "PrefetchLoader", "SingleDataLoader",
           "load_numpy_dataset", "synthetic_dataset"]
