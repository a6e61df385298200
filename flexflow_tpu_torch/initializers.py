"""Weight initializers, the counterpart of ``flexflow_tpu/initializers.py``.

The fan rules are the JAX package's; the values come from a
``torch.Generator``, so they differ from the JAX package's draws for the
same seed (tests carry weights across with ``interop.py``).  Values are
drawn on the CPU and then moved, so one seed gives the same weights on
every device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class Initializer:
    def __call__(self, generator: torch.Generator, shape: Tuple[int, ...],
                 dtype: torch.dtype) -> torch.Tensor:
        raise NotImplementedError


def _uniform(generator, shape, dtype, lo: float, hi: float):
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return (lo + (hi - lo) * u).to(dtype)


class GlorotUniform(Initializer):
    """Xavier/Glorot uniform: for 4-D (O,I,H,W) conv weights
    fan_in = I*H*W, fan_out = O*H*W; for 2-D (out,in) fan_in = in,
    fan_out = out."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def __call__(self, generator, shape, dtype):
        if len(shape) == 4:
            o, i, h, w = shape
            receptive = h * w
            fan_in, fan_out = i * receptive, o * receptive
        elif len(shape) == 2:
            fan_in, fan_out = shape[1], shape[0]
        else:
            fan_in = fan_out = int(np.prod(shape)) // max(1, shape[0])
        scale = float(np.sqrt(6.0 / (fan_in + fan_out)))
        return _uniform(generator, shape, dtype, -scale, scale)


class ZeroInitializer(Initializer):
    def __call__(self, generator, shape, dtype):
        return torch.zeros(tuple(shape), dtype=dtype)


class ConstantInitializer(Initializer):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, generator, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=dtype)


class UniformInitializer(Initializer):
    def __init__(self, seed: int = 0, minv: float = 0.0, maxv: float = 1.0):
        self.seed, self.minv, self.maxv = seed, minv, maxv

    def __call__(self, generator, shape, dtype):
        return _uniform(generator, shape, dtype, self.minv, self.maxv)


class NormInitializer(Initializer):
    def __init__(self, seed: int = 0, mean: float = 0.0, stddev: float = 1.0):
        self.seed, self.mean, self.stddev = seed, mean, stddev

    def __call__(self, generator, shape, dtype):
        z = torch.randn(tuple(shape), generator=generator,
                        dtype=torch.float32)
        return (self.mean + self.stddev * z).to(dtype)


GlorotUniformInitializer = GlorotUniform
