"""Mesh axes without devices: the device-free half of the JAX package's
``parallel/mesh.py``.

Strategies bind the logical dims of each op's output to named mesh
axes, the SOAP dimensions:

====  ==========================================================
axis  meaning
====  ==========================================================
n     sample / batch (data parallelism)
c     channel (tensor parallelism)
h,w   spatial attribute parallelism (conv h/w splits)
s     sequence
e     experts (MoE expert-stacked weights)
p     pipeline stages
====  ==========================================================

Each axis is factored into prime sub-axes, so any divisor of an axis
size is a realizable degree.  :class:`AbstractMesh` answers every axis
question the static verifier asks; :class:`MachineMesh` lays the same
axes over the ranks of a ``torch.distributed`` process group as a
``DeviceMesh`` whose dimensions are the prime sub-axes (``n0, n1, c0,
...``), in the JAX package's order.

The JAX package's mesh holds the devices of one process (or of every
host, one process each).  The port runs one process per device (see
``parallel/distributed.py``), so a MachineMesh spans every rank of the
world: its product equals the world size.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

AXES: Tuple[str, ...] = ("n", "c", "h", "w", "s", "e", "p")

# readable aliases accepted in mesh shapes.  "p" (pipeline stages) and
# "e" (experts) map to no logical tensor dim (dim_axis_names never
# yields them): they shard stage- and expert-stacked weights.
_ALIAS = {"data": "n", "batch": "n", "model": "c", "tensor": "c",
          "seq": "s", "sequence": "s", "expert": "e", "pipeline": "p",
          "stage": "p"}


def prime_factors(n: int) -> Tuple[int, ...]:
    """Ascending prime factorization (with multiplicity)."""
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return tuple(out)


def subset_for_degree(factors: Sequence[int], degree: int):
    """Indices of a sub-multiset of ``factors`` whose product == degree,
    preferring a prefix (keeps producer/consumer shardings aligned).
    Returns None when no subset works."""
    if degree == 1:
        return ()
    prod, pref = 1, []
    for i, f in enumerate(factors):
        prod *= f
        pref.append(i)
        if prod == degree:
            return tuple(pref)
        if prod > degree:
            break
    # general subset DFS
    def dfs(i, rem, picked):
        if rem == 1:
            return tuple(picked)
        if i >= len(factors):
            return None
        if rem % factors[i] == 0:
            r = dfs(i + 1, rem // factors[i], picked + [i])
            if r is not None:
                return r
        return dfs(i + 1, rem, picked)

    return dfs(0, degree, [])


def expressible_degrees(size: int) -> Tuple[int, ...]:
    """All degrees realizable as sub-multiset products of size's primes
    (== all divisors of ``size``), ascending."""
    factors = prime_factors(size)
    degs = {1}
    for f in factors:
        degs |= {d * f for d in degs}
    return tuple(sorted(degs))


def degree_expressible(axis_size: int, degree: int) -> bool:
    """THE mesh-expressibility predicate: can ``degree`` shards map onto
    a sub-axis subset of an axis of ``axis_size``?  It is the decision
    :meth:`_MeshAxes.axis_spec` makes, exported so the static verifier
    and the search judge legality with one predicate."""
    if degree <= 1:
        return True
    return subset_for_degree(prime_factors(axis_size), degree) is not None


class _MeshAxes:
    """The axis math of a mesh: canonical-axis sizes, their prime
    sub-axis factorization, and the degree -> sub-axis-subset decision
    (:meth:`axis_spec`), shared by every view of a mesh so the static
    sharding pass and the executor cannot diverge on which degrees are
    realizable."""

    def _init_axes(self, sizes: Dict[str, int]) -> None:
        self.sizes = sizes
        self._subaxes: Dict[str, Tuple[str, ...]] = {}
        self._subfactors: Dict[str, Tuple[int, ...]] = {}
        for a in AXES:
            fs = prime_factors(sizes[a]) if sizes[a] > 1 else ()
            self._subaxes[a] = tuple(f"{a}{i}" for i in range(len(fs)))
            self._subfactors[a] = fs
        # the MESH product — distinct from num_devices on an
        # AbstractMesh whose machine is larger than the mesh
        self.mesh_product = math.prod(int(v) for v in sizes.values())
        self.num_devices = self.mesh_product

    @property
    def is_distributed(self) -> bool:
        # keyed on the mesh product, NOT the machine size: a {'n': 1}
        # mesh on an 8-device machine places nothing
        return self.mesh_product > 1

    def axis_size(self, axis: str) -> int:
        return self.sizes[_ALIAS.get(axis, axis)]

    def subaxes(self, axis: str) -> Tuple[str, ...]:
        """The prime sub-axis names materializing a canonical axis."""
        return self._subaxes.get(_ALIAS.get(axis, axis), ())

    def axis_spec(self, axis: str, degree: int):
        """Sub-axis name tuple realizing ``degree`` shards on ``axis``;
        the full canonical name when degree == axis size; None when the
        degree is not a realizable divisor."""
        a = _ALIAS.get(axis, axis)
        if degree <= 1:
            return ()
        if degree == self.sizes[a]:
            return self._subaxes[a]
        idx = subset_for_degree(self._subfactors[a], degree)
        if idx is None:
            return None
        return tuple(self._subaxes[a][i] for i in idx)


def _canonical_sizes(shape: Optional[Dict[str, int]]) -> Dict[str, int]:
    """Every canonical axis's size from a shape that may use aliases; an
    unknown axis raises (a typo'd axis must not give a confidently wrong
    mesh with every canonical axis silently of size 1)."""
    sizes = {a: 1 for a in AXES}
    for k, v in (shape or {}).items():
        a = _ALIAS.get(k, k)
        if a not in sizes:
            raise ValueError(
                f"unknown mesh axis {k!r} (canonical axes: "
                f"{', '.join(AXES)}; aliases: "
                f"{', '.join(sorted(_ALIAS))})")
        sizes[a] = int(v)
    return sizes


class AbstractMesh(_MeshAxes):
    """A mesh SHAPE without devices: the static verifier's machine view
    and, on one device, the port's own mesh.  A 64-device mesh can be
    interpreted on a CPU-only machine.  ``num_devices`` may exceed the
    mesh product (a machine bigger than the strategy uses)."""

    def __init__(self, shape: Optional[Dict[str, int]] = None,
                 num_devices: Optional[int] = None):
        sizes = _canonical_sizes(shape)
        self._init_axes(sizes)
        if num_devices is not None:
            if num_devices < self.num_devices:
                raise ValueError(
                    f"mesh {sizes} needs {self.num_devices} devices, "
                    f"machine has {num_devices}")
            self.num_devices = int(num_devices)

    def __repr__(self) -> str:
        live = {a: s for a, s in self.sizes.items() if s > 1}
        return (f"AbstractMesh({live or {'n': 1}}, "
                f"devices={self.num_devices})")


class MachineMesh(_MeshAxes):
    """A ``torch.distributed`` DeviceMesh over the world's ranks.

    Each canonical axis is materialized as its prime-factor sub-axes
    (axis "n" of size 4 -> mesh dims n0, n1 of size 2 each), so an op may
    shard a dim with any divisor degree of the axis size: a degree maps
    onto a subset of the sub-axes.  A spec entry that names a canonical
    axis expands to all its sub-axes (:meth:`sharding`), and a dim split
    over several sub-axes is split over them major to minor, the block
    order of jax's ``PartitionSpec(("n0", "n1"))``.

    With no shape the mesh is pure data parallelism over every rank.
    ``device`` is the rank's device: the card by default
    (``cuda:{local_rank % device_count()}``; raises where there is none),
    ``"cpu"`` when the caller asks.  A one-process program without a
    process group gets a one-device mesh with no DeviceMesh
    (``device_mesh`` None); any larger mesh needs the process group
    (``parallel.distributed.initialize_distributed``) and a product equal
    to its world size."""

    def __init__(self, shape: Optional[Dict[str, int]] = None,
                 device=None):
        from . import distributed
        sizes = _canonical_sizes(shape)
        world = distributed.world_size()
        used = math.prod(sizes.values())
        if used == 1 and world > 1 and not shape:
            sizes["n"] = world  # default: pure data parallel
            used = world
        if used > world:
            raise ValueError(f"mesh {sizes} needs {used} devices, have "
                             f"{world}")
        if used < world:
            raise ValueError(
                f"mesh {sizes} uses {used} of the {world} ranks; a "
                f"MachineMesh spans every rank of the process group")
        self._init_axes(sizes)
        self.device = (distributed.rank_device() if device is None
                       else torch.device(device))
        names: List[str] = []
        dims: List[int] = []
        for a in AXES:
            names.extend(self._subaxes[a])
            dims.extend(self._subfactors[a])
        if not names:  # a one-device mesh still has one dim
            names, dims = ["n0"], [1]
            self._subaxes["n"] = ("n0",)
            self._subfactors["n"] = (1,)
        self.dim_names: Tuple[str, ...] = tuple(names)
        self.device_mesh = None
        if _group_up():
            from torch.distributed.device_mesh import DeviceMesh
            self.device_mesh = DeviceMesh(
                self.device.type, torch.arange(used).reshape(dims),
                mesh_dim_names=self.dim_names)

    def _expand(self, entry) -> Tuple[str, ...]:
        """A spec entry as the sub-axis names it shards over."""
        if entry is None:
            return ()
        if isinstance(entry, str):
            subs = self._subaxes.get(_ALIAS.get(entry, entry))
            return tuple(subs) if subs is not None else (entry,)
        return tuple(entry)

    def sharding(self, spec) -> list:
        """DTensor placements of a spec tuple: ``Shard(d)`` on each mesh
        dim that dim ``d``'s entry names, ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard
        out: list = [Replicate() for _ in self.dim_names]
        for d, entry in enumerate(spec):
            for name in self._expand(entry):
                out[self.dim_names.index(name)] = Shard(d)
        return out

    def replicated(self) -> list:
        from torch.distributed.tensor import Replicate
        return [Replicate() for _ in self.dim_names]

    def coordinate(self) -> Tuple[int, ...]:
        """This rank's index along each mesh dim."""
        if self.device_mesh is None:
            return (0,) * len(self.dim_names)
        return tuple(self.device_mesh.get_coordinate())

    def axis_ring(self, axis: str) -> Tuple[List[int], int]:
        """The global ranks that share this rank's coordinates on every
        mesh dim but ``axis``'s sub-axes, in the order of ``axis``'s
        index (its sub-axes major to minor), and this rank's place in
        that list: the ring of a ring collective over ``axis``."""
        subs = self.subaxes(axis)
        dims = [self.dim_names.index(s) for s in subs]
        coord = list(self.coordinate())
        grid = self.device_mesh.mesh
        ranks = []
        for j in range(math.prod(self._subfactors[_ALIAS.get(axis, axis)])):
            rem = j
            c = list(coord)
            for d in reversed(dims):
                c[d] = rem % grid.shape[d]
                rem //= grid.shape[d]
            ranks.append(int(grid[tuple(c)]))
        me = int(grid[tuple(coord)])
        return ranks, ranks.index(me)

    def __repr__(self) -> str:
        live = {a: s for a, s in self.sizes.items() if s > 1}
        return (f"MachineMesh({live or {'n': 1}}, "
                f"devices={self.num_devices})")


def _group_up() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def scaled_shape(sizes: Dict[str, int], num_devices: int) -> Dict[str, int]:
    """Rescale a mesh's axis sizes to a new device count by resizing the
    data axis ``n`` and keeping every other live axis — the default
    grow/shrink policy of the elastic reshard path (``FFModel.reshard``
    and the ``grow_at_step``/``shrink_at_step`` fault kinds): model/
    sequence/expert parallel degrees are properties of the strategy, so
    a capacity change lands on the data axis unless a re-search says
    otherwise.  Raises when the surviving non-``n`` product does not
    divide ``num_devices`` (e.g. shrinking a {n:2, c:4} mesh to 2
    devices needs a real re-search, not an axis rescale)."""
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    other = 1
    for a, s in sizes.items():
        if a != "n" and s > 1:
            other *= int(s)
    if num_devices % other:
        raise ValueError(
            f"cannot rescale mesh {dict(sizes)} to {num_devices} "
            f"device(s): the non-'n' axes use {other} which does not "
            f"divide it — reshard with an explicit mesh (or re-search)")
    shape = {a: int(s) for a, s in sizes.items() if a != "n" and s > 1}
    shape["n"] = num_devices // other
    return shape


def dim_axis_names(rank: int) -> Tuple[Optional[str], ...]:
    """Canonical logical-dim -> mesh-axis assignment by tensor rank.

    rank 4 = conv activations (n,c,h,w); rank 3 = sequence activations
    (n,s,c); rank 2 = (n,c); rank 1 = (c,).
    """
    if rank == 4:
        return ("n", "c", "h", "w")
    if rank == 3:
        return ("n", "s", "c")
    if rank == 2:
        return ("n", "c")
    if rank == 1:
        return ("c",)
    return tuple([None] * rank)
