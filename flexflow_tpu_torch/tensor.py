"""Symbolic tensor and parameter handles for the FFModel graph.

Counterpart of ``flexflow_tpu/tensor.py``: a Tensor is a symbolic handle
(shape, dtype name, producing op); the values live in the model's
parameter dict and in the per-forward value map.  Shapes are natural
(sample dim first); 4-D image tensors are logical NCHW whatever memory
format the ops keep them in.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np

_uid = itertools.count()


@dataclasses.dataclass
class Tensor:
    """A node value in the op graph."""

    shape: Tuple[int, ...]
    dtype: str = "float32"
    name: str = ""
    owner_op: Optional[object] = None  # Op that produces this tensor
    owner_idx: int = 0
    uid: int = dataclasses.field(default_factory=lambda: next(_uid))

    @property
    def num_dims(self) -> int:
        return len(self.shape)

    @property
    def volume(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def sub_shape(self, dims: Tuple[int, ...]) -> Tuple[int, ...]:
        """Per-part shape when partitioned with degree ``dims[i]`` on
        dim i."""
        assert len(dims) == len(self.shape), (dims, self.shape)
        out = []
        for s, d in zip(self.shape, dims):
            assert s % d == 0, f"dim {s} not divisible by degree {d}"
            out.append(s // d)
        return tuple(out)

    def __hash__(self) -> int:
        return self.uid

    def __eq__(self, other) -> bool:
        return isinstance(other, Tensor) and other.uid == self.uid

    def __repr__(self) -> str:
        return (f"Tensor(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype})")


@dataclasses.dataclass
class Parameter(Tensor):
    """A trainable weight.  ``pcname`` names the op whose strategy
    governs it; ``trainable`` is False for op state.

    The sharding hints are the JAX package's, read by the strategy
    analysis (``parallel/sharding.param_spec``, the memory model):
    ``sharded_dim`` is the dim a channel-parallel strategy splits over
    mesh axis ``shard_axis`` ("c", or "e" for expert-stacked weights);
    ``inner_sharded_dim``/``inner_shard_axis`` a second split inside a
    stage-stacked weight.  They change no forward."""

    pcname: str = ""
    initializer: Optional[object] = None
    sharded_dim: Optional[int] = None
    shard_axis: str = "c"
    inner_sharded_dim: Optional[int] = None
    inner_shard_axis: str = "c"
    trainable: bool = True

    def __hash__(self) -> int:
        return self.uid

    def __eq__(self, other) -> bool:
        return isinstance(other, Parameter) and other.uid == self.uid
