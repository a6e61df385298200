"""SGD and Adam, the counterpart of ``flexflow_tpu/optimizers.py``.

The update rules are the reference kernels' (optimizer_kernel.cu):

* SGD, pytorch-style: ``g = grad + wd*w; v = m*v + g;
  g = nesterov ? g + m*v : v; w -= lr*g``;
* Adam with the bias correction folded into the step size,
  ``alpha_t = alpha*sqrt(1-beta2^t)/(1-beta1^t)``, then
  ``w -= alpha_t*m/(sqrt(v)+eps)``, L2-style decay folded into the
  gradient.  ``torch.optim.Adam`` puts eps elsewhere, so the rule is
  written out here.

``update(params, grads, state)`` is functional on dicts of tensors, as
the JAX optimizers are on pytrees: it returns new parameter and state
dicts and leaves its arguments untouched.  It runs under
``torch.no_grad()`` on the parameters' device.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class Optimizer:
    #: f32 bytes of optimizer state kept per parameter (the search's
    #: memory check reads it).  Conservative default: one momentum slot.
    slot_bytes_per_param: int = 4

    def init_state(self, params: Tensors) -> Any:
        raise NotImplementedError

    def update(self, params: Tensors, grads: Tensors,
               state) -> Tuple[Tensors, Any]:
        """(params, grads, state) -> (new_params, new_state)."""
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    def __init__(self, model=None, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.lr, self.momentum = float(lr), float(momentum)
        self.nesterov, self.weight_decay = bool(nesterov), float(weight_decay)

    @property
    def slot_bytes_per_param(self) -> int:
        # the velocity exists only when momentum > 0 (optimizer.cc:29-68)
        return 4 if self.momentum > 0.0 else 0

    def init_state(self, params: Tensors):
        if self.momentum > 0.0:
            return {"v": {k: torch.zeros_like(v) for k, v in params.items()}}
        return {}

    @torch.no_grad()
    def update(self, params, grads, state):
        lr, m, wd = self.lr, self.momentum, self.weight_decay
        if m > 0.0:
            new_params, new_v = {}, {}
            for k, w in params.items():
                gt = grads[k] + wd * w
                v = state["v"][k] * m + gt
                step = gt + m * v if self.nesterov else v
                new_params[k] = w - lr * step
                new_v[k] = v
            return new_params, {"v": new_v}
        return ({k: w - lr * (grads[k] + wd * w) for k, w in params.items()},
                {})


class AdamOptimizer(Optimizer):
    slot_bytes_per_param = 8  # m + v, both f32 (optimizer.cc:116-157)

    def __init__(self, model=None, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8):
        self.alpha = float(alpha)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.weight_decay, self.epsilon = float(weight_decay), float(epsilon)

    def init_state(self, params: Tensors):
        return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
                "v": {k: torch.zeros_like(v) for k, v in params.items()},
                "t": 0}

    def alpha_t(self, t: int) -> float:
        """The bias-corrected step size of step ``t`` (1-based), in
        float32 as the JAX rule computes it."""
        tf = torch.tensor(float(t), dtype=torch.float32)
        b1 = torch.tensor(self.beta1, dtype=torch.float32)
        b2 = torch.tensor(self.beta2, dtype=torch.float32)
        return float(self.alpha * torch.sqrt(1.0 - b2 ** tf)
                     / (1.0 - b1 ** tf))

    @torch.no_grad()
    def update(self, params, grads, state):
        b1, b2 = self.beta1, self.beta2
        wd, eps = self.weight_decay, self.epsilon
        t = state["t"] + 1
        alpha_t = self.alpha_t(t)
        new_params, new_m, new_v = {}, {}, {}
        for k, w in params.items():
            gt = grads[k] + wd * w
            mt = b1 * state["m"][k] + (1 - b1) * gt
            vt = b2 * state["v"][k] + (1 - b2) * gt * gt
            new_params[k] = w - alpha_t * mt / (torch.sqrt(vt) + eps)
            new_m[k], new_v[k] = mt, vt
        return new_params, {"m": new_m, "v": new_v, "t": t}


def get_optimizer(name: str, **kw) -> Optimizer:
    name = name.lower()
    if name == "sgd":
        return SGDOptimizer(**kw)
    if name in ("adam", "adamw"):
        return AdamOptimizer(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
