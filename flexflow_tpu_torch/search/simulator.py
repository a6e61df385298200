"""The memory half of the JAX package's strategy simulator
(``search/simulator.py``): a strategy's per-device high-water mark
(:meth:`Simulator.peak_memory_bytes`, the FF108 scalar) and its liveness
timeline (:meth:`Simulator.memory_timeline`, FF121).  The event
simulation of a step's time comes with the strategy search.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from ..config import PRECISION_DTYPES, ParallelConfig
from ..op import Op, pad_degrees
from .cost_model import (DeviceSpec, op_memory_bytes, op_memory_components,
                         precision_dtype_bytes, spec_for_device)


class Simulator:
    def __init__(self, spec: Optional[DeviceSpec] = None,
                 num_devices: int = 1, dtype_bytes: int = 2,
                 remat: bool = False, compute_dtype: str = "bfloat16",
                 opt_slot_bytes: int = 4, sparse_tables=None):
        self.spec = spec if spec is not None else spec_for_device()
        self.num_devices = num_devices
        self.dtype_bytes = dtype_bytes
        # f32 optimizer-state bytes per parameter (SGD momentum 4, Adam
        # m+v 8, plain SGD 0)
        self.opt_slot_bytes = opt_slot_bytes
        # embedding tables on the sparse update path
        # (FFModel._sparse_embedding_specs): no table-shaped gradient
        self.sparse_tables = frozenset(sparse_tables or ())
        self.remat = remat  # the run rematerializes: less resident memory
        self.compute_dtype = compute_dtype

    def effective_precision(self, pc) -> str:
        """The op's strategy precision token, normalized against the
        session dtype: an explicit pin EQUAL to ``compute_dtype`` runs
        the same program as the "" default, so it costs the same."""
        precision = getattr(pc, "precision", "") if pc is not None else ""
        if PRECISION_DTYPES.get(precision) == self.compute_dtype:
            return ""
        return precision

    def peak_memory_bytes(self, layers: List[Op],
                          strategies: Dict[str, ParallelConfig],
                          mesh_shape: Optional[Dict[str, int]] = None,
                          assume_remat: Optional[bool] = None,
                          extra_state_bytes: float = 0.0) -> float:
        """Per-device high-water estimate for a strategy: params + grads +
        optimizer slots (sharded over TP degrees) + retained activations
        (sharded over all degrees).  ``mesh_shape`` supplies the e/p axis
        sizes for expert-/stage-stacked weights (absent -> replicated).
        ``assume_remat`` overrides ``self.remat`` — the legality check
        passes False.  ``extra_state_bytes`` adds always-resident
        per-device state the graph itself does not show."""
        from ..ops.linear import host_placed
        from ..parallel.mesh import dim_axis_names
        remat = self.remat if assume_remat is None else assume_remat
        stack = {a: (mesh_shape or {}).get(a, 1) for a in ("e", "p")}
        # resident activation fraction under sqrt(N)-segmented remat
        # (model.py _execute_remat): ~nseg boundary tensors + one
        # recomputed segment interior of N/nseg ops -> 2/sqrt(N) of the
        # full retained set
        act_scale = 1.0
        if remat:
            n_mat = max(1, len(layers))
            act_scale = min(1.0, 2.0 / math.sqrt(n_mat))
        total = float(extra_state_bytes)
        for op in layers:
            pc = strategies.get(op.name)
            out = op.outputs[0]
            if pc is None:
                dims = tuple(ParallelConfig.data_parallel(
                    min(self.num_devices, out.shape[0]), out.num_dims).dims)
            else:
                dims = pad_degrees(pc.dims, out.num_dims)
            # host-placed candidates run the dense path — no sparse
            # row-grad discount on their tables.
            # Activation bytes follow the op's strategy precision: a
            # bf16-pinned op's retained outputs cost 2
            # bytes/elem even in an f32 session; "" (and a pin equal to
            # the session dtype — effective_precision) keeps the session
            # dtype — the FF108 scalar is bit-identical without overrides
            total += op_memory_bytes(
                op, dims,
                precision_dtype_bytes(self.effective_precision(pc),
                                      self.dtype_bytes),
                opt_slot_bytes=self.opt_slot_bytes,
                axes=dim_axis_names(out.num_dims),
                stack_degrees=stack, remat=remat,
                act_scale=act_scale,
                sparse_tables=(frozenset() if host_placed(pc)
                               else self.sparse_tables))
        return total

    def memory_timeline(self, layers: List[Op],
                        strategies: Dict[str, ParallelConfig],
                        mesh_shape: Optional[Dict[str, int]] = None,
                        assume_remat: Optional[bool] = None,
                        extra_state_bytes: float = 0.0) -> Dict:
        """Liveness-based per-device memory timeline for one training
        step — the interval analysis behind the FF121 diagnostic.

        Events are the topological order the executor runs: every op's
        FORWARD in layer order, then every op's BACKWARD in reverse.
        Live ranges (``cost_model.op_memory_components``):

        * params + grads + optimizer slots are resident for the whole
          step;
        * an op's retained activation is live from its forward event
          until its own backward event completes (in reverse topo order
          that is the LAST use — every consumer's backward ran
          earlier); under remat the retained fraction is the same
          ``2/sqrt(N)`` scale the one-shot bound charges;
        * each backward event additionally holds the incoming output
          cotangent as a TRANSIENT (full dtype bytes, never
          remat-discounted — it exists regardless).

        At the forward/backward boundary every retained activation is
        live at once, so the high-water is >= the one-shot
        ``peak_memory_bytes`` sum by construction (the first backward's
        cotangent rides on top) — the timeline strictly strengthens the
        scalar bound while FF108/search legality stay pinned to the
        scalar, so lint gating and the search's inf gate cannot
        disagree.  Returns ``{"events": [...], "state_bytes": ...,
        "peak_bytes": ..., "peak_event": {...}, "peak_owners": [...]}``
        — ``peak_owners`` names the largest live contributions at the
        peak event (the ops to re-shard or rematerialize first)."""
        from ..ops.linear import host_placed
        from ..parallel.mesh import dim_axis_names
        remat = self.remat if assume_remat is None else assume_remat
        stack = {a: (mesh_shape or {}).get(a, 1) for a in ("e", "p")}
        act_scale = 1.0
        if remat:
            n_mat = max(1, len(layers))
            act_scale = min(1.0, 2.0 / math.sqrt(n_mat))

        # always-resident extra state rides in state_bytes so the
        # timeline's high-water and FF108's scalar see the same number
        state_total = float(extra_state_bytes)
        acts: Dict[str, float] = {}
        cotangents: Dict[str, float] = {}
        for op in layers:
            pc = strategies.get(op.name)
            out = op.outputs[0]
            if pc is None:
                dims = tuple(ParallelConfig.data_parallel(
                    min(self.num_devices, out.shape[0]), out.num_dims).dims)
            else:
                dims = pad_degrees(pc.dims, out.num_dims)
            # per-op dtype bytes: the same precision rule the
            # FF108 scalar charges, so the FF121 timeline and the gate
            # cannot disagree about a mixed-precision strategy
            op_bytes = precision_dtype_bytes(self.effective_precision(pc),
                                             self.dtype_bytes)
            state, act = op_memory_components(
                op, dims, op_bytes,
                opt_slot_bytes=self.opt_slot_bytes,
                axes=dim_axis_names(out.num_dims), stack_degrees=stack,
                remat=remat, act_scale=act_scale,
                sparse_tables=(frozenset() if host_placed(pc)
                               else self.sparse_tables))
            state_total += state
            acts[op.name] = act
            nparts = 1
            for d in dims:
                nparts *= d
            cotangents[op.name] = sum(
                t.volume * op_bytes / max(1, nparts)
                for t in op.outputs)

        events: List[Dict] = []
        live_acts = 0.0
        live_set: List[str] = []
        peak = state_total
        peak_idx = -1
        peak_live: List[str] = []
        for op in layers:  # forward sweep
            live_acts += acts[op.name]
            live_set.append(op.name)
            total = state_total + live_acts
            events.append({"op": op.name, "phase": "fwd",
                           "live_bytes": total, "transient_bytes": 0.0})
            if total > peak:
                peak, peak_idx, peak_live = total, len(events) - 1, \
                    list(live_set)
        for op in reversed(layers):  # backward sweep
            trans = cotangents[op.name]
            total = state_total + live_acts + trans
            events.append({"op": op.name, "phase": "bwd",
                           "live_bytes": total, "transient_bytes": trans})
            if total > peak:
                peak, peak_idx, peak_live = total, len(events) - 1, \
                    list(live_set)
            live_acts -= acts[op.name]  # own backward: last use, dies
            if live_set and live_set[-1] == op.name:
                live_set.pop()
        owners = sorted(((name, acts[name]) for name in peak_live
                         if acts[name] > 0),
                        key=lambda kv: (-kv[1], kv[0]))[:5]
        peak_event = events[peak_idx] if 0 <= peak_idx < len(events) else {
            "op": "", "phase": "state", "live_bytes": state_total,
            "transient_bytes": 0.0}
        return {
            "state_bytes": state_total,
            "events": events,
            "peak_bytes": peak,
            "peak_event": dict(peak_event),
            "peak_owners": [{"op": n, "act_bytes": b} for n, b in owners],
        }
