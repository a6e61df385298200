"""Carry parameters from the JAX package's model into the port's.

The two packages draw initial weights from different generators, so a
parity check builds the same graph in both, reads the JAX model's
parameters as numpy (``{name: model.get_weights(name)}``) and loads them
here.  Only numpy crosses the boundary: this module imports neither
package's model code.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def params_from_jax_numpy(model, weights: Mapping[str, np.ndarray]) -> None:
    """Load ``weights`` (parameter name -> full array) into the port's
    compiled and initialized ``model``.  The two sets of names must be
    equal: a missing or extra name means the graphs differ, and the copy
    is refused before anything is loaded.  Each array is a parameter's
    full value, whatever mesh the JAX model ran on; on a model compiled
    on a ``MachineMesh`` every rank passes the same arrays and keeps its
    own shard of each (``FFModel.set_weights``)."""
    have = {p.name for p in model.parameters}
    got = set(weights)
    if have != got:
        raise ValueError(
            f"parameter names differ: only in the port "
            f"{sorted(have - got)}, only in the JAX model "
            f"{sorted(got - have)}")
    for name in sorted(have):
        model.set_weights(name, weights[name])
