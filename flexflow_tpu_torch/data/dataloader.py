"""Synthetic data and the double-buffered device feed, the counterpart of
``flexflow_tpu/data/dataloader.py`` (``synthetic_dataset`` and
``PrefetchLoader``).

The dataset lives in host numpy.  ``PrefetchLoader`` uploads batch i+1
(or window i+1) before it hands out batch i: on a CUDA device the upload
goes from pinned host memory with ``non_blocking=True``, so it overlaps
the steps that run on batch i.
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
    """Double-buffered device feed of windows (:meth:`iter_windows`):
    stacked ``(K, batch_size, ...)`` arrays, ``K = steps_per_dispatch``,
    a zero-copy reshape of K contiguous batches, the next window's
    upload issued before the current one is handed out.  ``__iter__``
    yields the full batches one by one through the same staging.

    ``pad_tail=True`` keeps the tail samples that do not fill a batch:
    the last batch is zero-padded to ``batch_size`` and its valid-row
    count rides along so the masked train step leaves the padding out
    of the loss, metrics and gradients.  Off (default), the tail is
    dropped with a warning.  ``num_steps`` counts the steps a pass
    trains, ``tail_valid`` the padded tail's valid rows and
    ``num_samples_used`` the samples a pass consumes (the THROUGHPUT
    line's numerator)."""

    def __init__(self, model, inputs_data: Sequence[np.ndarray],
                 labels: np.ndarray, batch_size: Optional[int] = None,
                 steps_per_dispatch: int = 1, pad_tail: bool = False):
        self.model = model
        self.inputs_data = [np.asarray(a) for a in inputs_data]
        self.labels = np.asarray(labels)
        self.batch_size = batch_size or model.config.batch_size
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.pad_tail = bool(pad_tail)
        n = self.labels.shape[0]
        self.num_batches = n // self.batch_size
        dropped = n - self.num_batches * self.batch_size
        # steps actually trained: full batches, plus the padded tail batch
        self.num_steps = self.num_batches + (1 if self.pad_tail and dropped
                                             else 0)
        self.tail_valid = dropped if self.pad_tail else 0
        self.num_samples_used = (self.num_batches * self.batch_size
                                 + self.tail_valid)
        if self.num_steps == 0:
            warnings.warn(f"dataset ({n} samples) is smaller than "
                          f"batch_size={self.batch_size}: fit() will run "
                          f"ZERO steps")
        elif dropped and not self.pad_tail:
            warnings.warn(f"dropping {dropped} tail samples not filling a "
                          f"batch of {self.batch_size} (pad_tail trains "
                          f"them)")

    def __iter__(self):
        """Per-batch iteration over the full batches: one-step windows
        of the same staging, unpacked."""
        bounds = [(i, i + 1) for i in range(self.num_batches)]
        for window, _ in self._staged(bounds):
            yield tuple(a[0] for a in window)

    # ------------------------------------------------------------------
    # windows (FFConfig.steps_per_dispatch / pad_tail_batches)
    # ------------------------------------------------------------------
    def _window_bounds(self):
        """(first_step, last_step) pairs: every window holds
        ``steps_per_dispatch`` steps except a shorter final one."""
        k = self.steps_per_dispatch
        return [(lo, min(lo + k, self.num_steps))
                for lo in range(0, self.num_steps, k)]

    def _host_window(self, lo: int, hi: int):
        """(window_arrays, nvalid) for steps [lo, hi): each array is
        ``(hi-lo, batch_size, ...)``; nvalid is an int64 vector of valid
        rows per step (None when padding is off)."""
        bs = self.batch_size
        w = hi - lo
        arrays = []
        padded_tail = self.tail_valid and hi == self.num_steps
        for a in tuple(self.inputs_data) + (self.labels,):
            chunk = a[lo * bs:hi * bs]
            short = w * bs - chunk.shape[0]
            if short:  # the padded tail batch closes this window
                chunk = np.concatenate(
                    [chunk, np.zeros((short,) + chunk.shape[1:],
                                     chunk.dtype)])
            arrays.append(chunk.reshape((w, bs) + chunk.shape[1:]))
        if not self.pad_tail:
            return tuple(arrays), None
        nvalid = np.full((w,), bs, np.int64)
        if padded_tail:
            nvalid[-1] = self.tail_valid
        return tuple(arrays), nvalid

    def iter_windows(self):
        """Yield ``(window, nvalid)`` with ``window`` on the device and
        the next window's upload already issued.  ``nvalid`` stays a
        host array."""
        return self._staged(self._window_bounds())

    def _staged(self, bounds):
        """The double-buffered upload of the windows ``bounds``: window
        i+1's upload is issued before window i is handed out."""
        if not bounds:
            return
        device = self.model.device

        def stage(i):
            arrays, nvalid = self._host_window(*bounds[i])
            return upload(arrays, device), nvalid

        pending = stage(0)
        for i in range(len(bounds)):
            cur = pending
            if i + 1 < len(bounds):
                # issue the next upload before handing out this window
                pending = stage(i + 1)
            yield cur
