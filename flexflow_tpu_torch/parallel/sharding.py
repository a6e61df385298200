"""ParallelConfig -> per-dim placement: the spec functions of the JAX
package's ``parallel/sharding.py``.

Each op's resolved ParallelConfig becomes a spec for its output and each
parameter a spec of its own: a plain tuple with one entry per dim, None
(replicated), a canonical axis name, or a tuple of prime sub-axis names
(:class:`~flexflow_tpu_torch.parallel.mesh._MeshAxes`).  The tuple stands
in for jax's ``PartitionSpec``; :meth:`MachineMesh.sharding
<flexflow_tpu_torch.parallel.mesh.MachineMesh.sharding>` maps it onto
DTensor placements.

The runtime half places values by those placements.  GSPMD maps onto
DTensor: a ``NamedSharding`` is a list of placements on the mesh's
DeviceMesh, ``with_sharding_constraint`` at an op's output is a
``redistribute`` at the same point (``FFModel._run_ops``), and
``shard_map`` around a kernel is :func:`shard_map` here, which hands a
function this rank's local shards.

A degree that divides the dim's extent and maps onto a sub-axis subset
splits; any other degree falls back to replication, and the fallback is
recorded through the verifier's hook
(``analysis.record_replicate_fallback``) or a caller's collector, so the
static prediction (FF120) and a run's record (FF106) come from one
predicate (``analysis.legality.degree_executable``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

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


# ----------------------------------------------------------------------
# runtime: values placed on a MachineMesh
# ----------------------------------------------------------------------
def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def refuse_dtensor(fn: str, *tensors) -> None:
    """A kernel wrapper takes local tensors: a DTensor reaching one has
    not been taken to its rank's shard (``shard_map``), and the wrapper
    raises rather than gather it and run elsewhere."""
    for t in tensors:
        if is_dtensor(t):
            raise TypeError(
                f"{fn}: got a DTensor; a kernel runs on this rank's local "
                f"shard (parallel.sharding.shard_map)")


def local_block(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``full`` under ``placements``: each sharded
    dim cut into equal blocks, mesh dim by mesh dim in mesh order, so a
    dim sharded over several mesh dims is split major to minor.  Every
    rank holds the same full value (the multi-controller contract), so
    no data moves."""
    from torch.distributed.tensor import Shard
    coord = mesh.coordinate()
    loc = full
    for md, p in enumerate(placements):
        if isinstance(p, Shard):
            k = mesh.device_mesh.size(md)
            if loc.shape[p.dim] % k:
                raise ValueError(
                    f"dim {p.dim} of extent {loc.shape[p.dim]} does not "
                    f"split into {k} equal blocks")
            loc = loc.chunk(k, dim=p.dim)[coord[md]]
    return loc


def distribute(full: torch.Tensor, mesh, placements):
    """A full value (the same on every rank) as a DTensor under
    ``placements``, each rank keeping its own block."""
    from torch.distributed.tensor import DTensor
    full = full.contiguous()
    return DTensor.from_local(
        local_block(full, mesh, placements).contiguous(),
        mesh.device_mesh, placements, run_check=False,
        shape=full.shape, stride=full.stride())


def gather(t) -> torch.Tensor:
    """The full value of a DTensor on every rank (a collective: every
    rank calls it); a plain tensor comes back as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def redistribute(t, placements):
    """The DTensor ``t`` under ``placements`` on its mesh (no move when it
    is already there)."""
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def grad_placements(placements, out_placements) -> list:
    """The placements of the local gradient of an input held under
    ``placements`` and used by a per-shard function whose output is
    held under ``out_placements``: on a mesh dim where the input is
    replicated and the output sharded, each rank's gradient is its
    shard's share of the sum (``Partial``); elsewhere the gradient is
    placed as the input is."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [Partial() if isinstance(p, Replicate) and isinstance(o, Shard)
            else p for p, o in zip(placements, out_placements)]


def shard_map(fn: Callable, args: Sequence, in_placements: Sequence,
              out_placements):
    """The counterpart of ``jax.shard_map`` around a kernel: each DTensor
    of ``args`` is redistributed to its entry of ``in_placements`` and
    taken to this rank's local tensor, ``fn`` runs on the local tensors
    (and on the non-DTensor args as they are), and its tensor result
    becomes a DTensor under ``out_placements`` on the args' mesh.
    Autograd flows through: the local gradient of a replicated input on
    a mesh dim where the output is sharded is a partial sum
    (:func:`grad_placements`)."""
    from torch.distributed.tensor import DTensor
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    local = []
    for a, pl in zip(args, in_placements):
        if not is_dtensor(a):
            local.append(a)
            continue
        a = redistribute(a, pl)
        local.append(a.to_local(
            grad_placements=grad_placements(pl, out_placements)))
    out = fn(*local)
    return DTensor.from_local(out, mesh, out_placements, run_check=False)


def keep_shards(placements, dims: Sequence[int]) -> list:
    """``placements`` with the shards of tensor dims outside ``dims``
    gathered: every other ``Shard`` and every ``Partial`` becomes
    ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in placements]


def linear(x, w, bias=None, epilogue: Optional[Callable] = None):
    """``epilogue(x @ w.T + bias)`` of DTensors x (..., in), w (out, in)
    and bias (out,), each rank multiplying its local blocks, the
    counterpart of the product GSPMD partitions: a mesh dim that splits
    w's rows (a column-parallel Linear, q/k/v) splits the output's last
    dim; one that splits w's columns (the attention's row-parallel
    output projection) leaves each rank a partial sum, which is
    all-reduced before the bias and the epilogue; a mesh dim that splits
    x's batch or sequence dims keeps them split (w is gathered on it if
    it was split there too), and a split of x's last dim that w does
    not share is gathered first.  ``epilogue`` (the activation and the
    cast) maps element by element.  A plain x runs the plain product."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def local(xl, wl, bl, finish):
        y = torch.nn.functional.linear(xl, wl)
        if finish:
            if bl is not None:
                y = y + bl.to(y.dtype)
            if epilogue is not None:
                y = epilogue(y)
        return y

    if not is_dtensor(x):
        return local(x, w, bias, True)
    last = x.dim() - 1
    x_pl, w_pl, out_pl = [], [], []
    for xp, wp in zip(x.placements, w.placements):
        batch = isinstance(xp, Shard) and xp.dim < last
        if batch:
            x_pl.append(xp)
            w_pl.append(Replicate())
            out_pl.append(xp)
        elif isinstance(wp, Shard) and wp.dim == 1:
            x_pl.append(Shard(last))
            w_pl.append(wp)
            out_pl.append(Partial())
        elif isinstance(wp, Shard):
            x_pl.append(Replicate())
            w_pl.append(wp)
            out_pl.append(Shard(last))
        else:
            x_pl.append(Replicate())
            w_pl.append(Replicate())
            out_pl.append(Replicate())
    b_pl = [Shard(0) if isinstance(p, Shard) and p.dim == last
            else Replicate() for p in out_pl]
    partial = any(isinstance(p, Partial) for p in out_pl)
    y = shard_map(lambda xl, wl, bl: local(xl, wl, bl, not partial),
                  [x, w, bias], [x_pl, w_pl, b_pl], out_pl)
    if not partial:
        return y
    done = [Replicate() if isinstance(p, Partial) else p for p in out_pl]
    y = redistribute(y, done)
    b_pl = [Shard(0) if isinstance(p, Shard) and p.dim == last
            else Replicate() for p in done]

    def finish(yl, bl):
        if bl is not None:
            yl = yl + bl.to(yl.dtype)
        return epilogue(yl) if epilogue is not None else yl

    return shard_map(finish, [y, bias], [done, b_pl], done)
