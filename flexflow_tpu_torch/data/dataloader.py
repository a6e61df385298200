"""Synthetic data and the double-buffered device feed, the counterpart of
``flexflow_tpu/data/dataloader.py`` (``synthetic_dataset`` and
``PrefetchLoader``'s per-batch iteration).

The dataset lives in host numpy.  ``PrefetchLoader`` uploads batch i+1
before it hands out batch i: on a CUDA device the upload goes from
pinned host memory with ``non_blocking=True``, so it overlaps the step
that runs on batch i.  Window mode (``steps_per_dispatch``) and padded
tail batches wait for the slice that ports fused multi-step dispatch.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def synthetic_dataset(num_samples: int,
                      input_shapes: Sequence[Tuple[int, ...]],
                      label_shape: Tuple[int, ...], num_classes: int = 10,
                      seed: int = 0,
                      input_dtypes: Optional[Sequence[str]] = None,
                      label_dtype: str = "int32"):
    """Random dataset (the reference generates random data when no
    dataset is given).  Same generator and draw order as the JAX
    package's, so one seed gives the same arrays in both."""
    rng = np.random.default_rng(seed)
    xs = []
    for i, shape in enumerate(input_shapes):
        dt = (input_dtypes[i] if input_dtypes else "float32")
        if np.issubdtype(np.dtype(dt), np.integer):
            xs.append(rng.integers(0, num_classes,
                                   (num_samples,) + tuple(shape)).astype(dt))
        else:
            xs.append(rng.standard_normal(
                (num_samples,) + tuple(shape), dtype=np.float32).astype(dt))
    if np.issubdtype(np.dtype(label_dtype), np.integer):
        y = rng.integers(0, num_classes, (num_samples,)
                         + tuple(label_shape)).astype(label_dtype)
    else:
        y = rng.standard_normal(
            (num_samples,) + tuple(label_shape), dtype=np.float32)
    return xs, y


def upload(arrays, device: torch.device) -> tuple:
    """Host arrays to ``device`` tensors.  To a CUDA device the copy is
    issued from pinned memory without waiting for it; the caching host
    allocator keeps each pinned buffer until its copy has run."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out.append(t)
    return tuple(out)


class PrefetchLoader:
    """Double-buffered device feed over full batches.  The tail samples
    that do not fill a batch are dropped (with a warning);
    ``num_samples_used`` counts the samples a pass consumes, the
    THROUGHPUT line's numerator."""

    def __init__(self, model, inputs_data: Sequence[np.ndarray],
                 labels: np.ndarray, batch_size: Optional[int] = None):
        self.model = model
        self.inputs_data = [np.asarray(a) for a in inputs_data]
        self.labels = np.asarray(labels)
        self.batch_size = batch_size or model.config.batch_size
        n = self.labels.shape[0]
        self.num_batches = n // self.batch_size
        dropped = n - self.num_batches * self.batch_size
        self.num_samples_used = self.num_batches * self.batch_size
        if self.num_batches == 0:
            warnings.warn(f"dataset ({n} samples) is smaller than "
                          f"batch_size={self.batch_size}: fit() will run "
                          f"ZERO steps")
        elif dropped:
            warnings.warn(f"dropping {dropped} tail samples not filling a "
                          f"batch of {self.batch_size}")

    def _host_batch(self, it: int):
        sl = slice(it * self.batch_size, (it + 1) * self.batch_size)
        return tuple(a[sl] for a in self.inputs_data) + (self.labels[sl],)

    def __iter__(self):
        if self.num_batches == 0:
            return
        device = self.model.device
        pending = upload(self._host_batch(0), device)
        for it in range(self.num_batches):
            cur = pending
            if it + 1 < self.num_batches:
                # issue the next upload before handing out the current one
                pending = upload(self._host_batch(it + 1), device)
            yield cur
