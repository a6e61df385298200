"""Whole-strategy passes, the JAX package's
``analysis/strategy_passes.py``: machine fit, host placement, memory
budget, resharding hotspots.

Per-op config legality lives in :mod:`analysis.legality`; these passes
need the whole (graph, strategy, machine): the mesh the degrees must
factor into, the per-device memory budget (through the cost model's
accounting, ``Simulator.peak_memory_bytes`` times the measured
compiler-temp factor, so lint and the search agree), and the
producer/consumer seams that become collectives.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from ..config import DeviceType, MemoryType, ParallelConfig
from ..op import Op, pad_degrees, snap_degrees
from ..parallel.mesh import AXES, dim_axis_names
from .diagnostics import Diagnostic, make

MeshShape = Dict[str, int]


def infer_mesh_shape(strategies: Dict[str, ParallelConfig],
                     layers: List[Op], num_devices: int
                     ) -> tuple:
    """Static mirror of ``FFModel._infer_mesh_shape``: size each canonical
    axis to the LCM of the degrees ops assign to it, falling back to the
    max when the LCM overshoots the machine.  Returns ``(mesh_shape,
    overcommit_diag_or_None)`` instead of raising, so lint can report
    FF112 and keep going."""
    lcm = {a: 1 for a in AXES}
    mx = dict(lcm)
    any_cfg = False
    for op in layers:
        pc = strategies.get(op.name)
        if pc is None or not op.outputs:
            continue
        any_cfg = True
        rank = op.outputs[0].num_dims
        axes = dim_axis_names(rank)
        for deg, ax in zip(pad_degrees(pc.dims, rank), axes):
            if ax and deg > 1:
                lcm[ax] = math.lcm(lcm[ax], deg)
                mx[ax] = max(mx[ax], deg)
    if not any_cfg:
        return {"n": max(1, num_devices)}, None
    if math.prod(lcm.values()) <= max(1, num_devices):
        return lcm, None
    used = math.prod(mx.values())
    if used > max(1, num_devices):
        return mx, make(
            "FF112", "",
            f"strategy degrees need a mesh of {used} devices "
            f"({ {a: s for a, s in mx.items() if s > 1} }), machine has "
            f"{num_devices}",
            hint="lower the degrees or run on more devices")
    return mx, None


def memory_diagnostics(layers: List[Op],
                       strategies: Dict[str, ParallelConfig],
                       mesh_shape: MeshShape, num_devices: int,
                       spec=None, opt_slot_bytes: int = 4,
                       sparse_tables=frozenset(),
                       xla_temp_factor: Optional[float] = None,
                       extra_state_bytes: float = 0.0
                       ) -> List[Diagnostic]:
    """FF108 — per-device peak memory vs the device-memory budget,
    through the accounting the search's legality check uses
    (``Simulator.peak_memory_bytes`` times the compiler-temp factor).
    ``xla_temp_factor`` overrides the spec's factor
    (``DeviceSpec.temp_factor``, measured on the card); the JAX
    package's keyword keeps its name so one call drives both.
    ``extra_state_bytes``: always-resident per-device state (a
    preallocated cache) added to BOTH the FF108 scalar and the FF121
    timeline after the factor, which it does not take."""
    from ..search.cost_model import spec_for_device
    from ..search.simulator import Simulator

    spec = spec or spec_for_device()
    factor = (float(xla_temp_factor) if xla_temp_factor
              else spec.temp_factor)
    sim = Simulator(spec=spec, num_devices=max(1, num_devices),
                    opt_slot_bytes=opt_slot_bytes,
                    sparse_tables=sparse_tables)
    peak = sim.peak_memory_bytes(layers, strategies, mesh_shape,
                                 assume_remat=False
                                 ) * factor + extra_state_bytes
    # the liveness timeline (Simulator.memory_timeline): same
    # components, interval analysis on top — its high-water is >= the
    # scalar sum by construction, and it NAMES the peak (FF121).  The
    # FF108 gate stays pinned to the scalar the search's inf gate uses,
    # so lint gating and search legality cannot disagree; FF121 (WARN)
    # reports the strictly-stronger liveness bound with the offending
    # interval when IT overflows.
    # the timeline likewise carries the extra state unscaled
    tl = sim.memory_timeline(layers, strategies, mesh_shape,
                             assume_remat=False)
    kv_note = (f", {extra_state_bytes / 1e9:.2f} GB KV cache"
               if extra_state_bytes else "")
    diags: List[Diagnostic] = []
    if peak > spec.hbm_capacity:
        owners = ", ".join(o["op"] for o in tl["peak_owners"][:3]) \
            or "(parameter state)"
        diags.append(make(
            "FF108", "",
            f"estimated per-device peak {peak / 1e9:.2f} GB (incl. "
            f"{factor}x compiler-temp factor{kv_note}) exceeds the "
            f"{spec.hbm_capacity / 1e9:.1f} GB HBM budget; the search "
            f"scores this strategy infeasible (inf); largest resident "
            f"activations: {owners}",
            hint="raise the sharding degrees, shard the optimizer, or "
                 "lower the batch size"))
    tl_peak = tl["peak_bytes"] * factor + extra_state_bytes
    if tl_peak > spec.hbm_capacity:
        ev = tl["peak_event"]
        owners = ", ".join(
            f"{o['op']} ({o['act_bytes'] / 1e6:.1f} MB)"
            for o in tl["peak_owners"][:3]) or "(parameter state)"
        state_total = tl["state_bytes"] * factor + extra_state_bytes
        diags.append(make(
            "FF121", ev["op"],
            f"liveness high-water {tl_peak / 1e9:.2f} GB (incl. "
            f"{factor}x compiler-temp factor{kv_note}) exceeds the "
            f"{spec.hbm_capacity / 1e9:.1f} GB HBM budget at the "
            f"{ev['phase']} of {ev['op']!r} (state "
            f"{state_total / 1e9:.2f} GB resident); "
            f"peak owners: {owners}",
            hint="re-shard or rematerialize the peak-owning ops first "
                 "(flexflow-tpu explain shows the full timeline)"))
    return diags


def host_placement_diagnostics(op: Op, pc: ParallelConfig
                               ) -> List[Diagnostic]:
    """FF107 — host-memory placement rules (reference hetero strategies,
    dlrm_strategy_hetero.cc): HOST placement means ZCM memory and only
    makes sense for ops with parameters to pin host-side."""
    diags: List[Diagnostic] = []
    mts = tuple(pc.memory_types)
    if pc.device_type == DeviceType.HOST:
        if not op.weights:
            diags.append(make(
                "FF107", op.name,
                "HOST placement on an op with no parameters has no "
                "effect (host placement pins parameter memory)",
                hint="place the op's producer table/weight instead"))
        if mts and MemoryType.ZCM not in mts:
            diags.append(make(
                "FF107", op.name,
                f"HOST device_type with device-only memory_types {mts}; "
                f"the executor pins to pinned_host regardless",
                hint="use memory_types=(ZCM, ...) for host placement"))
    elif MemoryType.ZCM in mts:
        # DEVICE + ZCM is the reference's zero-copy spelling, honored as
        # host placement (ops/linear.host_placed); flag the mix so a
        # .pb author knows both fields steer the same decision
        if MemoryType.FBM in mts:
            diags.append(make(
                "FF107", op.name,
                f"mixed FBM+ZCM memory_types {mts}: any ZCM entry "
                f"places ALL of this op's parameters host-side",
                hint="use all-ZCM (host) or all-FBM (device)"))
    return diags


def resharding_diagnostics(layers: List[Op],
                           strategies: Dict[str, ParallelConfig],
                           num_devices: int,
                           dtype_bytes: int = 2) -> List[Diagnostic]:
    """FF109 — producer/consumer partition seams.  Mirrors the simulator's
    edge construction (simulate_py's input-projection + snap): when the
    consumer's projected input partitioning differs from the producer's
    output partitioning, the executor inserts resharding collectives on that
    edge every step.  INFO-level: seams are often intentional (DP->TP
    boundaries), but the ranked report shows where the bytes go."""
    diags: List[Diagnostic] = []
    owner = {t.uid: op for op in layers for t in op.outputs}

    def dims_for(op: Op) -> tuple:
        pc = strategies.get(op.name)
        out = op.outputs[0]
        if pc is None:
            return tuple(ParallelConfig.data_parallel(
                min(max(1, num_devices), out.shape[0]), out.num_dims).dims)
        return pad_degrees(pc.dims, out.num_dims)

    hot = []
    for op in layers:
        cdims = dims_for(op)
        for t_in in op.inputs:
            prod = owner.get(t_in.uid)
            if prod is None or prod.outputs[0].uid != t_in.uid:
                continue  # secondary outputs: projection rule is op-specific
            pdims = snap_degrees(
                pad_degrees(dims_for(prod), t_in.num_dims), t_in.shape)
            in_dims = snap_degrees(
                pad_degrees(cdims, t_in.num_dims), t_in.shape)
            if tuple(pdims) != tuple(in_dims):
                hot.append((t_in.volume * dtype_bytes, prod.name, op.name,
                            tuple(pdims), tuple(in_dims)))
    hot.sort(reverse=True)
    for nbytes, pname, cname, pd, cd in hot:
        diags.append(make(
            "FF109", cname,
            f"edge {pname} -> {cname} reshards {nbytes / 1e6:.2f} MB "
            f"per step (producer split {pd}, consumer reads {cd})",
            hint="align the two configs to remove the collective"))
    return diags
