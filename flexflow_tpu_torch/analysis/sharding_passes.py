"""Static sharding propagation, the JAX package's
``analysis/sharding_passes.py`` up to its communication plan.

A run decides every tensor's placement in two functions,
``parallel/sharding.output_spec`` (each op output) and
``parallel/sharding.param_spec`` (each parameter).  This module runs
THOSE functions over the whole graph against a device-free
:class:`~flexflow_tpu_torch.parallel.mesh.AbstractMesh`:

* **FF120** — every replicate fallback a run would record as FF106, with
  the same ``(name, dim, degree, axis, axis_size, reason)`` site payload
  (:func:`predict_fallbacks`);
* **communication plan** — per-edge reshard/allgather volumes from
  producer/consumer spec mismatches plus per-parameter gradient
  allreduce volumes (:func:`communication_plan`), and its digest.

The ``explain`` report needs the time simulation and the KV-cache
accounting, which come with the search and the generation engine.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Tuple

from ..config import ParallelConfig
from ..op import Op, pad_degrees, snap_degrees
from ..parallel.mesh import AbstractMesh, dim_axis_names
from .diagnostics import Diagnostic
from .verifier import fallback_site_diagnostics

MeshShape = Dict[str, int]

# a fallback site: the exact key the runtime recorder aggregates on
# (analysis.verifier.record_replicate_fallback)
Site = Tuple[str, int, int, Optional[str], int, str]


# ---------------------------------------------------------------------
# spec propagation + FF120 fallback prediction
# ---------------------------------------------------------------------

def propagate_specs(layers: List[Op],
                    strategies: Dict[str, ParallelConfig],
                    mesh) -> Tuple[Dict[int, tuple], Dict[Site, int]]:
    """Abstract interpretation of a run's placement pass: for a given
    (graph, strategy, mesh) return ``(specs, fallbacks)`` where ``specs``
    maps tensor uid -> spec entry tuple and ``fallbacks`` is the
    aggregated fallback-site dict a run would record.

    * op outputs: ``output_spec(t, pc, mesh)`` for every output of every
      op with a resolved config; configless outputs get the
      replicate-by-default spec, recording nothing;
    * parameters: ``param_spec(w, pc, mesh)`` once per unique Parameter
      with its FIRST owning op's config;
    * nothing is recorded on a single-device mesh, which places
      nothing.
    """
    from ..parallel.sharding import output_spec, param_spec

    fallbacks: Dict[Site, int] = {}

    def collect(name, dim, degree, axis, axis_size, reason):
        key = (name, dim, degree, axis, axis_size, reason)
        fallbacks[key] = fallbacks.get(key, 0) + 1

    distributed = mesh.is_distributed
    specs: Dict[int, tuple] = {}
    seen_params = set()
    for op in layers:
        pc = strategies.get(op.name)
        for t in op.outputs:
            if pc is not None and distributed:
                spec = output_spec(t, pc, mesh, on_fallback=collect)
            else:
                spec = output_spec(t, None, mesh)
            specs[t.uid] = tuple(spec)
        if not distributed:
            continue
        for w in op.weights:
            if w.uid in seen_params:
                continue  # shared weight: first owner's config governs
            seen_params.add(w.uid)
            param_spec(w, pc, mesh, on_fallback=collect)
    return specs, fallbacks


def predict_fallbacks(layers: List[Op],
                      strategies: Dict[str, ParallelConfig],
                      mesh) -> Dict[Site, int]:
    """The FF120 site set: every replicate fallback a run would record
    (FF106) for this (graph, strategy, mesh), as raw site tuples."""
    _, fallbacks = propagate_specs(layers, strategies, mesh)
    return fallbacks


def fallback_prediction_diagnostics(layers: List[Op],
                                    strategies: Dict[str, ParallelConfig],
                                    mesh_shape: MeshShape,
                                    num_devices: int) -> List[Diagnostic]:
    """FF120 — the verifier pass: statically predicted replicate
    fallbacks, one diagnostic per site with the same payload a run's
    FF106 would carry."""
    try:
        mesh = AbstractMesh(mesh_shape, num_devices=max(
            num_devices, 1))
    except ValueError:
        # machine smaller than the mesh: FF112 already reports it; the
        # fallback prediction still runs against the mesh itself
        mesh = AbstractMesh(mesh_shape)
    sites = predict_fallbacks(layers, strategies, mesh)
    return fallback_site_diagnostics(sites, code="FF120")


# ---------------------------------------------------------------------
# static communication plan
# ---------------------------------------------------------------------

def _edge_kind(pdims: tuple, cdims: tuple) -> str:
    """Classify a producer/consumer partition seam: ``allgather`` when
    the consumer reads at coarser (or equal) degrees everywhere —
    devices gather shards they do not hold; ``slice`` when strictly
    finer everywhere — a local dynamic-slice, no collective (the
    prefix-aligned sub-axis subsets of ``_MeshAxes`` make the finer
    shard a subset of the held one); ``reshard`` for mixed seams
    (an all-to-all-class exchange)."""
    if all(c <= p for c, p in zip(cdims, pdims)):
        return "allgather"
    if all(c >= p for c, p in zip(cdims, pdims)):
        return "slice"
    return "reshard"


def communication_plan(layers: List[Op],
                       strategies: Dict[str, ParallelConfig],
                       mesh, dtype_bytes: int = 2,
                       sparse_tables=frozenset()) -> Dict:
    """The per-step collective traffic a strategy implies, derived
    statically from spec mismatches — no devices.

    * **edges**: for every producer->consumer edge whose partitionings
      disagree (the same snap/projection rule the simulator's edge
      construction and the FF109 pass use), one row with the seam kind
      (`allgather`/`reshard`/`slice`), the full-tensor bytes moved per
      step (the FF109 accounting — an upper bound; `slice` seams move
      nothing), and the per-step collective count (forward + the
      mirrored backward gradient exchange);
    * **weight_sync**: per trainable parameter, the gradient allreduce
      the executor runs every step — bytes and replica-group size
      mirror the simulator's weight-sync costing (c-sharded
      weights move 1/c of the bytes across the non-c replica group;
      replicated weights allreduce across every degree; sparse-update
      tables exchange only the touched row gradients).

    Returns a JSON-ready dict; :func:`comm_plan_digest` stamps it.
    """
    from ..ops.linear import host_placed

    num_devices = mesh.num_devices
    owner = {t.uid: op for op in layers for t in op.outputs}

    def dims_for(op: Op) -> tuple:
        pc = strategies.get(op.name)
        out = op.outputs[0]
        if pc is None:
            return tuple(ParallelConfig.data_parallel(
                min(max(1, num_devices), out.shape[0]), out.num_dims).dims)
        return pad_degrees(pc.dims, out.num_dims)

    edges: List[Dict] = []
    for op in layers:
        cdims = dims_for(op)
        for t_in in op.inputs:
            prod = owner.get(t_in.uid)
            if prod is None or prod.outputs[0].uid != t_in.uid:
                continue  # secondary outputs: projection is op-specific
            pdims = snap_degrees(
                pad_degrees(dims_for(prod), t_in.num_dims), t_in.shape)
            in_dims = snap_degrees(
                pad_degrees(cdims, t_in.num_dims), t_in.shape)
            if tuple(pdims) == tuple(in_dims):
                continue
            kind = _edge_kind(tuple(pdims), tuple(in_dims))
            nbytes = (0 if kind == "slice"
                      else t_in.volume * dtype_bytes)
            edges.append({
                "src": prod.name, "dst": op.name,
                "tensor": t_in.name, "kind": kind,
                "producer_dims": list(pdims),
                "consumer_dims": list(in_dims),
                "bytes_per_step": int(nbytes),
                "collectives_per_step": 0 if kind == "slice" else 2,
            })

    weight_sync: List[Dict] = []
    for op in layers:
        if not op.weights:
            continue
        pc = strategies.get(op.name)
        out = op.outputs[0]
        dims = dims_for(op)
        axes = dim_axis_names(out.num_dims)
        # as the simulator costs it: host-placed candidates run the
        # dense gather path, so no sparse row-grad discount
        sparse = frozenset() if host_placed(pc) else frozenset(sparse_tables)
        c_deg, repl = 1, 1
        for deg, ax in zip(dims, axes):
            if ax == "c":
                c_deg *= deg
            else:
                repl *= deg
        for w in op.weights:
            if not w.trainable:
                continue
            wb = w.volume * 4
            if w.name in sparse:
                wb = op.inputs[0].volume * w.shape[-1] * 4
            if (w.sharded_dim is not None and c_deg > 1
                    and w.shape[w.sharded_dim] % c_deg == 0):
                nbytes, group = wb // c_deg, min(repl, num_devices)
            else:
                nbytes, group = wb, min(repl * c_deg, num_devices)
            if group <= 1 or nbytes <= 0:
                continue  # no replicas: nothing to reduce
            weight_sync.append({
                "op": op.name, "param": w.name, "kind": "allreduce",
                "bytes_per_step": int(nbytes), "replicas": int(group),
                "sparse_rows_only": w.name in sparse,
            })

    totals = {
        "edge_bytes_per_step": sum(e["bytes_per_step"] for e in edges),
        "allreduce_bytes_per_step": sum(w["bytes_per_step"]
                                        for w in weight_sync),
        "collectives_per_step": (
            sum(e["collectives_per_step"] for e in edges)
            + len(weight_sync)),
        "edges": len(edges),
        "allreduces": len(weight_sync),
    }
    edges.sort(key=lambda e: (-e["bytes_per_step"], e["src"], e["dst"]))
    weight_sync.sort(key=lambda w: (-w["bytes_per_step"], w["param"]))
    return {"edges": edges, "weight_sync": weight_sync, "totals": totals}


def comm_plan_digest(plan: Dict) -> str:
    """Stable content digest of a communication plan (sorted-key JSON,
    sha256, 16 hex chars): rows measured under different sharding plans
    carry different stamps."""
    blob = json.dumps(plan, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def comm_plan_digest_for_model(model) -> str:
    """The digest of a compiled model's plan: resolved per-op
    strategies on the mesh the model runs on (only the mesh's shape is
    read).  Computed over the DENSE plan (no sparse-table discount):
    sparse-update eligibility is a property of the run's optimizer,
    which an offline tool given (model, strategy, mesh) cannot know.
    Equal to the JAX package's digest for the same model and plan."""
    strategies = {op.name: op.parallel_config for op in model.layers
                  if op.parallel_config is not None}
    sizes = dict(model.mesh.sizes) if model.mesh is not None else {}
    mesh = AbstractMesh(sizes)
    return comm_plan_digest(communication_plan(
        model.layers, strategies, mesh))
