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
question the static verifier asks; the mesh over real devices and its
mapping onto ``torch.distributed`` come with the multi-device layer.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

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


class AbstractMesh(_MeshAxes):
    """A mesh SHAPE without devices: the static verifier's machine view
    and, on one device, the port's own mesh.  A 64-device mesh can be
    interpreted on a CPU-only machine.  ``num_devices`` may exceed the
    mesh product (a machine bigger than the strategy uses)."""

    def __init__(self, shape: Optional[Dict[str, int]] = None,
                 num_devices: Optional[int] = None):
        sizes = {a: 1 for a in AXES}
        for k, v in (shape or {}).items():
            a = _ALIAS.get(k, k)
            if a not in sizes:
                # fail like the runtime would, with a better message: a
                # typo'd axis must not produce a confidently wrong
                # static report (every canonical axis silently size 1)
                raise ValueError(
                    f"unknown mesh axis {k!r} (canonical axes: "
                    f"{', '.join(AXES)}; aliases: "
                    f"{', '.join(sorted(_ALIAS))})")
            sizes[a] = int(v)
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
