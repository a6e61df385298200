"""Keras-style optimizers, the port of ``flexflow_tpu/keras/optimizers.py``
(reference ``python/flexflow/keras/optimizers.py``): thin configs mapped
onto the core SGD and Adam rules (``flexflow_tpu_torch/optimizers.py``)."""

from __future__ import annotations

from ..optimizers import AdamOptimizer, Optimizer, SGDOptimizer


class SGD:
    def __init__(self, learning_rate=0.01, momentum=0.0, nesterov=False,
                 weight_decay=0.0):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay


class Adam:
    def __init__(self, learning_rate=0.001, beta_1=0.9, beta_2=0.999,
                 epsilon=1e-8, weight_decay=0.0):
        self.learning_rate = learning_rate
        self.beta_1, self.beta_2 = beta_1, beta_2
        self.epsilon = epsilon
        self.weight_decay = weight_decay


def to_core_optimizer(opt) -> Optimizer:
    if isinstance(opt, Optimizer):
        return opt
    if isinstance(opt, SGD):
        return SGDOptimizer(lr=opt.learning_rate, momentum=opt.momentum,
                            nesterov=opt.nesterov,
                            weight_decay=opt.weight_decay)
    if isinstance(opt, Adam):
        return AdamOptimizer(alpha=opt.learning_rate, beta1=opt.beta_1,
                             beta2=opt.beta_2, epsilon=opt.epsilon,
                             weight_decay=opt.weight_decay)
    if isinstance(opt, str):
        from ..optimizers import get_optimizer
        return get_optimizer(opt)
    raise ValueError(f"unknown optimizer {opt!r}")
