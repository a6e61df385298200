"""Keras callbacks, the port of ``flexflow_tpu/keras/callbacks.py``
(reference ``python/flexflow/keras/callbacks.py``), including the
metric-verification callbacks the reference uses as its test harness
(callbacks.py:64-82 + examples/python/keras/accuracy.py).

``FFModel.fit`` hands each callback the core model (``set_model``) and
calls ``on_train_begin``, ``on_epoch_begin``, ``on_epoch_end`` with the
epoch's ``PerfMetrics`` and ``on_train_end``; a callback whose
``stop_training`` is True ends the epoch loop.
"""

from __future__ import annotations

import enum


class ModelAccuracy(enum.Enum):
    """Per-model accuracy bounds (reference
    examples/python/keras/accuracy.py)."""

    MNIST_MLP = 90
    MNIST_CNN = 90
    REUTERS_MLP = 90
    CIFAR10_CNN = 90
    CIFAR10_ALEXNET = 90


class Callback:
    def __init__(self):
        self.model = None

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass


class LearningRateScheduler(Callback):
    """reference callbacks.py:44-62: sets optimizer lr per epoch."""

    def __init__(self, schedule):
        super().__init__()
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        lr = float(self.schedule(epoch))
        opt = self.model.optimizer
        if hasattr(opt, "lr"):
            attr = "lr"         # SGD
        elif hasattr(opt, "alpha"):
            attr = "alpha"      # Adam stores its rate as alpha
        else:
            raise ValueError('Optimizer must have a "lr" attribute.')
        if getattr(opt, attr) == lr:
            return  # unchanged schedule value
        # the port's eager step reads the optimizer's rate at every
        # update (dense and sparse), so no step holds the old one
        setattr(opt, attr, lr)
        print("set learning rate ", lr)


class EarlyStopping(Callback):
    """keras-style early stopping: watches a monitored metric (default
    ``val_loss``, from ``fit(validation_data=...)``; any key of
    ``PerfMetrics.scalars()`` or ``.val_scalars`` works) and sets
    ``stop_training`` after ``patience`` epochs without ``min_delta``
    improvement.  ``restore_best_weights`` reloads the best epoch's
    params (captured host-side at each improvement)."""

    def __init__(self, monitor="val_loss", min_delta=0.0, patience=0,
                 mode="auto", restore_best_weights=False):
        super().__init__()
        self.monitor = monitor
        self.min_delta = float(min_delta)
        self.patience = int(patience)
        self.restore_best_weights = bool(restore_best_weights)
        if mode not in ("auto", "min", "max"):
            raise ValueError(f"mode must be auto|min|max, got {mode!r}")
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.stop_training = False
        self.best = None
        self.wait = 0
        self._best_params = None

    def on_train_begin(self, logs=None):
        # a reused instance must not carry a previous fit's verdict
        # (keras resets the same state here)
        self.stop_training = False
        self.best = None
        self.wait = 0
        self._best_params = None

    def _value(self, pm):
        scalars = {**pm.scalars(), **getattr(pm, "val_scalars", {})}
        if self.monitor not in scalars:
            raise KeyError(
                f"EarlyStopping monitors {self.monitor!r} but this "
                f"epoch reported {sorted(scalars)} — pass "
                f"validation_data to fit() for val_* metrics")
        return float(scalars[self.monitor])

    def _improved(self, value):
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        value = self._value(logs)
        if self._improved(value):
            self.best = value
            self.wait = 0
            if self.restore_best_weights:
                # get_weights gathers a mesh's shards to full host
                # arrays (a collective: every rank runs the callback)
                self._best_params = {
                    p.name: self.model.get_weights(p.name)
                    for p in self.model.parameters}
            return
        self.wait += 1
        if self.wait >= max(1, self.patience):
            self.stop_training = True
            print(f"early stopping: {self.monitor} did not improve past "
                  f"{self.best:.6g} for {self.wait} epochs")

    def on_train_end(self, logs=None):
        if self.restore_best_weights and self._best_params is not None:
            for k, v in self._best_params.items():
                self.model.set_weights(k, v)


class ModelCheckpoint(Callback):
    """keras-style checkpointing on FFModel's sharded .npz format:
    saves after each epoch — or only on improvement of ``monitor``
    (``save_best_only``) — via ``save_checkpoint``; ``async_write``
    (default) overlaps serialization with the next epoch.  ``filepath``
    may contain ``{epoch}`` and any reported scalar
    (``{val_loss:.4f}``, ...).  For step-numbered filepaths
    (``..._step{epoch}``-style families) ``keep_last=K`` retains only
    the newest K checkpoints on disk — long elastic runs checkpoint
    every epoch and would otherwise fill shared storage.

    Under fused multi-step dispatch (``FFConfig.steps_per_dispatch``)
    epoch boundaries are always window boundaries, so epoch-end saves
    stay window-aligned by construction (docs/performance.md)."""

    def __init__(self, filepath, monitor="val_loss", save_best_only=False,
                 mode="auto", async_write=True, verbose=0, keep_last=None):
        super().__init__()
        self.filepath = str(filepath)
        self.monitor = monitor
        self.save_best_only = bool(save_best_only)
        self.async_write = bool(async_write)
        self.keep_last = keep_last
        self.verbose = verbose
        if mode not in ("auto", "min", "max"):
            raise ValueError(f"mode must be auto|min|max, got {mode!r}")
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None

    def on_train_begin(self, logs=None):
        self.best = None  # reused instances track the new run

    def on_epoch_end(self, epoch, logs=None):
        scalars = {**logs.scalars(), **getattr(logs, "val_scalars", {})}
        if self.save_best_only:
            if self.monitor not in scalars:
                raise KeyError(
                    f"ModelCheckpoint monitors {self.monitor!r} but this "
                    f"epoch reported {sorted(scalars)} — pass "
                    f"validation_data to fit() for val_* metrics")
            value = float(scalars[self.monitor])
            improved = (self.best is None
                        or (value < self.best if self.mode == "min"
                            else value > self.best))
            if not improved:
                return
            self.best = value
        path = self.filepath.format(epoch=epoch, **scalars)
        self.model.save_checkpoint(path, async_write=self.async_write,
                                   keep_last=self.keep_last)
        if self.verbose:
            print(f"saved checkpoint {path}")


class VerifyMetrics(Callback):
    """Asserts the final training accuracy beats the per-model bound
    (reference callbacks.py:64-72)."""

    def __init__(self, accuracy: ModelAccuracy):
        super().__init__()
        self.accuracy = accuracy.value

    def on_train_end(self, logs=None):
        perf = self.model.perf_metrics
        acc = 100.0 * perf.accuracy
        assert acc >= self.accuracy, \
            f"Accuracy is wrong: {acc:.2f} < {self.accuracy}"


class EpochVerifyMetrics(Callback):
    """Per-epoch accuracy check with optional early stop
    (reference callbacks.py:74-82)."""

    def __init__(self, accuracy: ModelAccuracy, early_stop: bool = True):
        super().__init__()
        self.accuracy = accuracy.value
        self.early_stop = early_stop
        self.reached = False
        self.stop_training = False  # fit() breaks the epoch loop on True

    def on_epoch_end(self, epoch, logs=None):
        perf = logs if logs is not None else self.model.perf_metrics
        acc = 100.0 * perf.accuracy
        if acc >= self.accuracy:
            self.reached = True
            if self.early_stop:
                self.stop_training = True
