"""The verifier entry points, the JAX package's ``analysis/verifier.py``:
run every pass, return a DiagnosticReport.

``verify()`` is the static, device-free core: it builds no mesh of
devices, so a 1024-device strategy lints on a laptop.
``verify_compile()`` is the ``FFModel.compile(verify=...)`` hook, taking
the machine view from the model's resolved mesh.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..config import ParallelConfig
from ..obs import lockwatch
from ..op import Op
from .diagnostics import Diagnostic, DiagnosticReport, make
from .graph_passes import graph_diagnostics
from .legality import config_diagnostics, precision_diagnostics
from .strategy_passes import (host_placement_diagnostics, infer_mesh_shape,
                              memory_diagnostics, resharding_diagnostics)

MeshShape = Dict[str, int]


def verify(layers: List[Op],
           strategies: Optional[Dict[str, ParallelConfig]] = None,
           mesh_shape: Optional[MeshShape] = None,
           num_devices: Optional[int] = None,
           input_tensors: Iterable = (),
           final_tensors: Iterable = (),
           parameters: Iterable = (),
           spec=None, opt_slot_bytes: int = 4,
           sparse_tables=frozenset(),
           xla_temp_factor: Optional[float] = None,
           check_memory: bool = True,
           check_resharding: bool = True,
           extra_state_bytes: float = 0.0) -> DiagnosticReport:
    """Static verification of a graph + strategy.

    ``mesh_shape`` defaults to the static inference the executor would
    run (LCM of per-axis degrees, FF112 when it overcommits);
    ``num_devices`` defaults to the mesh product.  Graph-only calls
    (``strategies=None``) run just the graph passes.
    """
    report = DiagnosticReport()
    strategies = strategies or {}
    report.extend(graph_diagnostics(
        layers, input_tensors=input_tensors, final_tensors=final_tensors,
        parameters=parameters))

    if not strategies:
        return report

    if mesh_shape is None:
        ndev_hint = num_devices or 0
        mesh_shape, over = infer_mesh_shape(strategies, layers,
                                            ndev_hint or 10 ** 9)
        if num_devices is None:
            num_devices = max(1, _prod(mesh_shape.values()))
        if over is not None:
            report.add(over)
    else:
        mesh_shape = dict(mesh_shape)
        if num_devices is None:
            num_devices = max(1, _prod(mesh_shape.values()))
        used = _prod(mesh_shape.values())
        if used > num_devices:
            report.add(make(
                "FF112", "",
                f"mesh {mesh_shape} needs {used} devices, machine has "
                f"{num_devices}",
                hint="shrink the mesh or add devices"))

    known = {op.name for op in layers}
    for name in strategies:
        if name not in known:
            report.add(make(
                "FF110", name,
                f"strategy entry {name!r} matches no op in the graph "
                f"(strategies attach by exact op name)",
                hint="check the op name spelling in the .pb/dict"))

    n_bf16 = n_f32 = 0
    for op in layers:
        pc = strategies.get(op.name)
        if pc is None or not op.outputs:
            continue
        report.extend(config_diagnostics(op, pc, mesh_shape, num_devices))
        report.extend(host_placement_diagnostics(op, pc))
        # FF140 — precision legality: bf16 pins on
        # loss/norm-statistics ops are rejected with the same predicate
        # the search's precision proposals draw from
        report.extend(precision_diagnostics(op, pc))
        prec = getattr(pc, "precision", "")
        if prec == "bf16":
            n_bf16 += 1
        elif prec == "f32":
            n_f32 += 1
    if n_bf16 or n_f32:
        # FF141 — one INFO row summarizing the mixed-precision policy,
        # so `lint --json` (and explain) surface WHAT the strategy pins
        # without a per-op flood; absent entirely for default-precision
        # strategies (every shipped .pb reads unchanged)
        report.add(make(
            "FF141", "",
            f"per-op precision overrides: {n_bf16} op(s) bf16, "
            f"{n_f32} op(s) f32 (unpinned ops follow "
            f"FFConfig.compute_dtype)"))

    # FF120 — the static sharding-propagation pass: run the executor's
    # placement functions against a device-free AbstractMesh and report
    # every replicate fallback a run would record as FF106, before
    # anything executes
    from .sharding_passes import fallback_prediction_diagnostics
    report.extend(fallback_prediction_diagnostics(
        layers, strategies, mesh_shape, num_devices))

    if check_memory:
        report.extend(memory_diagnostics(
            layers, strategies, mesh_shape, num_devices, spec=spec,
            opt_slot_bytes=opt_slot_bytes, sparse_tables=sparse_tables,
            xla_temp_factor=xla_temp_factor,
            extra_state_bytes=extra_state_bytes))
    if check_resharding:
        report.extend(resharding_diagnostics(layers, strategies,
                                             num_devices))
    return report


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def verify_compile(model) -> DiagnosticReport:
    """The compile-time pass: machine view from the model's resolved mesh,
    strategies from the per-op resolution, slot bytes from the real
    optimizer — so compile, lint and search all judge the same program."""
    strategies = {op.name: op.parallel_config for op in model.layers
                  if op.parallel_config is not None}
    # orphan detection against the CONFIG dict too: compile copies
    # resolved entries onto ops, so name typos only survive in cfg
    for name, pc in getattr(model.config, "strategies", {}).items():
        strategies.setdefault(name, pc)
    mesh = model.mesh
    mesh_shape = dict(mesh.sizes) if mesh is not None else None
    ndev = mesh.num_devices if mesh is not None else 1
    slot_bytes = getattr(model.optimizer, "slot_bytes_per_param", 4)
    sparse = frozenset(
        t for _, t, _ in model._sparse_embedding_specs())
    final = [model._final_tensor] if getattr(model, "_final_tensor", None) \
        is not None else []
    return verify(model.layers, strategies or None, mesh_shape=mesh_shape,
                  num_devices=ndev, input_tensors=model.input_tensors,
                  final_tensors=final, parameters=model.parameters,
                  opt_slot_bytes=slot_bytes, sparse_tables=sparse,
                  check_resharding=False)


# ---------------------------------------------------------------------
# runtime replicate-fallback aggregation (parallel/sharding.py feeds this
# instead of one warnings.warn per traced tensor)
# ---------------------------------------------------------------------
_fallback_lock = lockwatch.lock("verifier._fallback_lock")
_fallbacks: Dict[tuple, int] = {}
# distinct-site cap: a long-lived process tracing many models must not
# grow the dict unboundedly; overflow is counted and reported on drain
_FALLBACK_SITE_CAP = 4096
_fallback_overflow = 0


def record_replicate_fallback(name: str, dim: int, degree: int,
                              axis: Optional[str], axis_size: int,
                              reason: str) -> None:
    """Called by the sharding layer when a requested split degrades to
    replication.  Aggregated per site; drained by
    :func:`drain_replicate_fallbacks`.  Process-global: sites from every
    model placed in this process land here until the next drain."""
    global _fallback_overflow
    key = (name, dim, degree, axis, axis_size, reason)
    with _fallback_lock:
        if key not in _fallbacks and len(_fallbacks) >= _FALLBACK_SITE_CAP:
            _fallback_overflow += 1
            return
        _fallbacks[key] = _fallbacks.get(key, 0) + 1


def has_fallback_records() -> bool:
    """Is any fallback record waiting to be drained?  (The hot path's
    cheap test before a drain.)"""
    return bool(_fallbacks) or _fallback_overflow > 0


def drain_fallback_sites(owned_names=None) -> tuple:
    """Return (and clear) the raw aggregated fallback records:
    ``({(name, dim, degree, axis, axis_size, reason): count}, dropped)``.
    This is the exact site payload the static FF120 prediction
    (``analysis.sharding_passes.predict_fallbacks``) must reproduce —
    the cross-validation tests compare these tuples bit-for-bit (below
    the ``_FALLBACK_SITE_CAP`` of 4096 distinct sites; past it the
    runtime truncates and reports the ``dropped`` count while the
    static prediction stays complete).

    ``owned_names`` scopes the drain: the recorder is process-global,
    so when several models trace in one process a caller passes its own
    tensor/parameter names and receives ONLY its sites — everything
    else stays recorded for the owning model's drain (without the
    filter, model B's first dispatch would absorb model A's sites and
    mis-attribute them).  The overflow counter cannot be attributed to
    a model, so scoped drains leave it for the next full drain instead
    of reporting another model's drops as their own."""
    global _fallback_overflow
    with _fallback_lock:
        if owned_names is None:
            items = dict(sorted(_fallbacks.items()))
            _fallbacks.clear()
            dropped, _fallback_overflow = _fallback_overflow, 0
        else:
            items = {k: n for k, n in sorted(_fallbacks.items())
                     if k[0] in owned_names}
            for k in items:
                del _fallbacks[k]
            dropped = 0
    return items, dropped


def fallback_where(axis, axis_size: int) -> str:
    """The shared site-location phrase of FF106 (runtime) and FF120
    (static prediction) messages — one formatter, identical payloads."""
    return (f"mesh axis {axis!r} (size {axis_size})" if axis
            else "no mesh axis")


def fallback_site_diagnostics(sites: Dict[tuple, int], dropped: int = 0,
                              code: str = "FF106") -> List[Diagnostic]:
    """Render raw fallback sites as diagnostics.  ``code`` selects the
    tense: FF106 'replicated at trace time' (the runtime record) vs
    FF120 'will replicate at trace time' (the static prediction) — same
    site/dim/reason payload either way."""
    verb = ("replicated at trace time" if code == "FF106"
            else "will replicate at trace time")
    hint = ("run flexflow-tpu lint to catch this before compile"
            if code == "FF106"
            else "use a degree the executor can realize (see FF101/FF105)")
    out = []
    if dropped:
        out.append(make(
            code, "",
            f"{dropped} additional fallback record(s) dropped past the "
            f"{_FALLBACK_SITE_CAP}-site cap", count=dropped))
    for (name, dim, degree, axis, axis_size, reason), n in sorted(
            sites.items()):
        out.append(make(
            code, name,
            f"degree {degree} on dim {dim} {verb} "
            f"({reason}, {fallback_where(axis, axis_size)})",
            hint=hint, count=n))
    return out


def drain_replicate_fallbacks() -> List[Diagnostic]:
    """Return (and clear) the aggregated FF106 diagnostics — one per
    distinct fallback site, with the repeat count."""
    sites, dropped = drain_fallback_sites()
    return fallback_site_diagnostics(sites, dropped, code="FF106")
