"""ParallelConfig -> per-dim placement: the spec functions of the JAX
package's ``parallel/sharding.py``.

Each op's resolved ParallelConfig becomes a spec for its output and each
parameter a spec of its own: a plain tuple with one entry per dim, None
(replicated), a canonical axis name, or a tuple of prime sub-axis names
(:class:`~flexflow_tpu_torch.parallel.mesh._MeshAxes`).  The tuple stands
in for jax's ``PartitionSpec``; the multi-device layer maps it onto
DTensor placements.

A degree that divides the dim's extent and maps onto a sub-axis subset
splits; any other degree falls back to replication, and the fallback is
recorded through the verifier's hook
(``analysis.record_replicate_fallback``) or a caller's collector, so the
static prediction (FF120) and a run's record (FF106) come from one
predicate (``analysis.legality.degree_executable``).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..config import ParallelConfig
from ..tensor import Parameter, Tensor
from .mesh import dim_axis_names

Spec = Tuple[object, ...]


def _record_fallback(name: str, dim: int, degree: int, axis,
                     axis_size: int, reason: str) -> None:
    # imported here: the analysis package imports the op layer, which
    # loads before it
    from ..analysis.verifier import record_replicate_fallback
    record_replicate_fallback(name, dim, degree, axis, axis_size, reason)


def dim_entry(extent: int, dim: int, degree: int, axis, mesh,
              name: str, on_fallback) -> object:
    """THE per-dim placement decision: the spec entry one logical dim
    gets for a requested ``degree`` on ``axis``, or None with
    ``on_fallback(name, dim, degree, axis, axis_size, reason)`` fired
    when it replicates instead.  ``mesh`` is any
    :class:`~flexflow_tpu_torch.parallel.mesh._MeshAxes`."""
    if degree <= 1:
        return None
    size = mesh.axis_size(axis) if axis else 1
    sub = mesh.axis_spec(axis, degree) if axis else None
    from ..analysis.legality import degree_executable
    # the mesh's own answer is passed in, so expressibility is decided
    # (and searched) once per dim
    reason = degree_executable(extent, degree, size, axis,
                               expressible=sub is not None)
    if reason is not None:
        on_fallback(name, dim, degree, axis, size, reason)
        return None
    return axis if degree == size else sub


def output_spec(tensor: Tensor, pc: Optional[ParallelConfig],
                mesh, on_fallback=None) -> Spec:
    """The spec of an op output under its ParallelConfig.
    ``on_fallback`` overrides the replicate-fallback recorder (FF106);
    the static pass passes its own collector."""
    if on_fallback is None:
        on_fallback = _record_fallback
    rank = tensor.num_dims
    axes = dim_axis_names(rank)
    if pc is None:
        # replicated, but for the sample dim over 'n'
        return tuple("n" if (rank > 1 and i == 0
                             and mesh.axis_size("n") > 1
                             and tensor.shape[0] % mesh.axis_size("n") == 0)
                     else None for i in range(rank))
    dims = pc.dims
    if len(dims) != rank:
        dims = tuple(dims[:rank]) + (1,) * max(0, rank - len(dims))
    return tuple(dim_entry(tensor.shape[i], i, deg, ax, mesh, tensor.name,
                           on_fallback)
                 for i, (deg, ax) in enumerate(zip(dims, axes)))


def param_spec(param: Parameter, pc: Optional[ParallelConfig],
               mesh, on_fallback=None) -> Spec:
    """The spec of a weight.  Data-parallel weights are replicated; a
    channel-parallel op splits its weight's ``sharded_dim`` over axis
    'c'; stage- and expert-stacked weights (``shard_axis`` 'p' or 'e')
    split their stack dim over that axis, and may split a second dim
    inside it (``inner_sharded_dim``).  ``on_fallback`` as in
    :func:`output_spec`.  An empty tuple is fully replicated."""
    if on_fallback is None:
        on_fallback = _record_fallback
    if param.shard_axis in ("p", "e"):
        entries = [None] * len(param.shape)
        if (param.sharded_dim is not None
                and mesh.axis_size(param.shard_axis) > 1):
            entries[param.sharded_dim] = param.shard_axis
        idim = param.inner_sharded_dim
        if (idim is not None and idim < len(param.shape)
                and mesh.axis_size(param.inner_shard_axis) > 1
                and param.shape[idim] % mesh.axis_size(
                    param.inner_shard_axis) == 0
                and entries[idim] is None):
            entries[idim] = param.inner_shard_axis
        if any(e is not None for e in entries):
            return tuple(entries)
        return ()
    if (pc is None or param.sharded_dim is None
            or mesh.axis_size("c") <= 1):
        return ()
    # the channel degree sits at the canonical 'c' position of the output
    c_deg = 1
    for deg, ax in zip(pc.dims, dim_axis_names(len(pc.dims))):
        if ax == "c":
            c_deg = deg
    if c_deg <= 1:
        return ()
    entry = dim_entry(param.shape[param.sharded_dim], param.sharded_dim,
                      c_deg, "c", mesh, param.name, on_fallback)
    if entry is None:
        return ()
    entries = [None] * len(param.shape)
    entries[param.sharded_dim] = entry
    return tuple(entries)


def batch_spec(rank: int, mesh, seq_sharded: bool = False) -> Spec:
    """An input batch's spec: the sample dim over 'n', and with
    ``seq_sharded`` the sequence dim over 's'."""
    entries: list = [None] * rank
    if rank >= 1 and mesh.axis_size("n") > 1:
        entries[0] = "n"
    if seq_sharded and rank >= 2 and mesh.axis_size("s") > 1:
        entries[1] = "s"
    return tuple(entries)
