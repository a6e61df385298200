"""Weights made from the seed on the device, in one call: a flat float32
normal draw from a generator on the device, each leaf a scaled and
shifted view of it.  The program and the plain reference are both handed
these values; neither makes its own."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .traffic import derive

# (name, shape, mean, std) of every leaf
Spec = List[Tuple[str, Tuple[int, ...], float, float]]


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    for (name, shape, mean, std), view in zip(spec, flat.split(sizes)):
        out[name] = view.view(shape).mul_(std).add_(mean)
    return out


def install(model, values: Dict[str, torch.Tensor]) -> None:
    """The values into the program through ``FFModel.set_weights``.  It
    takes host arrays, so the flat draw crosses to the host once."""
    names = sorted(p.name for p in model.parameters)
    if names != sorted(values):
        raise RuntimeError(
            f"the program's parameters differ from the benchmark's "
            f"weights: only in the program "
            f"{sorted(set(names) - set(values))[:5]}, only in the "
            f"benchmark {sorted(set(values) - set(names))[:5]}")
    for name, value in values.items():
        cur = model.get_parameter_by_name(name)
        if tuple(cur.shape) != tuple(value.shape):
            raise RuntimeError(f"{name}: program shape {tuple(cur.shape)}, "
                               f"benchmark shape {tuple(value.shape)}")
        model.set_weights(name, value.cpu().numpy())
