"""The strategy simulator, the counterpart of the JAX package's
``search/simulator.py``.

The reference's architecture (``src/runtime/simulator.{h,cc}``): a task
graph of FORWARD/BACKWARD/COMM/UPDATE SimTasks built from the model and
a candidate strategy, dependency edges where producer and consumer
partitions intersect, then an event-driven simulation with per-device
ready queues (simulate_runtime, simulator.cc:275-448).  Per-op times come
from the analytic H100 roofline (``cost_model.py``) by default;
``measure=True`` times each op's sub-shape on the device with CUDA
events (``profiling.profile_op``: the port's own kernels), cached by
(op, config) as the reference's measure path (simulator.cc:235-273).
Weight sync is a ring allreduce.  :meth:`Simulator.simulate` runs the
native engine (``native/simulator.cpp``) when it builds, else
:meth:`Simulator.simulate_py`; both give the same bits.

The memory half: a strategy's per-device high-water mark
(:meth:`Simulator.peak_memory_bytes`, the FF108 scalar, times the spec's
``temp_factor`` for legality) and its liveness timeline
(:meth:`Simulator.memory_timeline`, FF121).
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import PRECISION_DTYPES, ParallelConfig
from ..op import Op, pad_degrees
from .cost_model import (DeviceSpec, allreduce_time, op_compute_time,
                         op_memory_bytes, op_memory_components,
                         precision_dtype_bytes, spec_for_device,
                         transfer_time)


class SimTask:
    __slots__ = ("ready_time", "run_time", "device", "next_tasks",
                 "remaining_deps", "kind")

    def __init__(self, run_time: float, device: int, kind: str):
        self.ready_time = 0.0
        self.run_time = run_time
        self.device = device
        self.kind = kind
        self.next_tasks: List["SimTask"] = []
        self.remaining_deps = 0

    def add_next(self, t: "SimTask") -> None:
        self.next_tasks.append(t)
        t.remaining_deps += 1


def _part_coords(dims: Tuple[int, ...]):
    """Row-major enumeration of partition coordinates."""
    idx = np.indices(dims).reshape(len(dims), -1).T
    return [tuple(c) for c in idx]


def _part_rect(shape, dims, coord):
    """[lo, hi) box of one partition."""
    lo, hi = [], []
    for s, d, c in zip(shape, dims, coord):
        step = s // d
        lo.append(c * step)
        hi.append((c + 1) * step if c < d - 1 else s)
    return tuple(lo), tuple(hi)


def _overlap_volume(lo1, hi1, lo2, hi2) -> int:
    v = 1
    for a1, b1, a2, b2 in zip(lo1, hi1, lo2, hi2):
        o = min(b1, b2) - max(a1, a2)
        if o <= 0:
            return 0
        v *= o
    return v


class Simulator:
    """``device`` is the device the run's ops execute on (the entry
    points' default, CUDA, unless the caller names another): the
    analytic path charges the kernels that run there (attention's flash
    rule), and measure mode times on it.  ``estimator`` keeps the JAX
    package's hook; the port accepts only None (the analytic roofline)
    until the calibration tables are ported (ROADMAP A.9b)."""

    def __init__(self, spec: Optional[DeviceSpec] = None,
                 num_devices: int = 1, devices_per_slice: int = 0,
                 measure: bool = False, dtype_bytes: int = 2,
                 use_native: bool = True, flash_attention=None,
                 remat: bool = False, compute_dtype: str = "bfloat16",
                 conv_layout: str = "auto", opt_slot_bytes: int = 4,
                 sparse_tables=None, estimator=None, device="cuda"):
        if estimator is not None:
            raise NotImplementedError(
                "a calibrated cost estimator is not ported yet (ROADMAP "
                "A.9b); the port's simulator takes estimator=None")
        self.spec = spec if spec is not None else spec_for_device()
        self.num_devices = num_devices
        self.devices_per_slice = devices_per_slice or num_devices
        self.measure = measure
        self.dtype_bytes = dtype_bytes
        # f32 optimizer-state bytes per parameter (SGD momentum 4, Adam
        # m+v 8, plain SGD 0)
        self.opt_slot_bytes = opt_slot_bytes
        # embedding tables on the sparse update path
        # (FFModel._sparse_embedding_specs): their replicas sync the
        # touched rows' gradients, not the table
        self.sparse_tables = frozenset(sparse_tables or ())
        self.estimator = estimator
        self.flash_attention = flash_attention
        self.remat = remat  # the run rematerializes: less resident memory
        self.compute_dtype = compute_dtype
        self.conv_layout = conv_layout
        self.device = torch.device(device)
        self._warned_remat_legality = False
        self._measure_cache: Dict[Tuple, Tuple[float, float]] = {}
        self._plan_cache: Dict[Tuple, Tuple] = {}
        self._use_native = use_native
        self._native_lib = None

    @property
    def _native(self):
        """The native engine's library, built and loaded at the first
        simulation (a memory-only caller never builds it); None for the
        pure-Python engine."""
        if self._use_native and self._native_lib is None:
            from ..native import load_ffsim
            self._native_lib = load_ffsim()
            self._use_native = self._native_lib is not None
        return self._native_lib

    @property
    def backend(self) -> str:
        """``"native"`` or ``"python"``: the engine :meth:`simulate`
        runs."""
        return "native" if self._native is not None else "python"

    def effective_precision(self, pc) -> str:
        """The op's strategy precision token, normalized against the
        session dtype: an explicit pin EQUAL to ``compute_dtype`` runs
        the same program as the "" default, so it costs the same."""
        precision = getattr(pc, "precision", "") if pc is not None else ""
        if PRECISION_DTYPES.get(precision) == self.compute_dtype:
            return ""
        return precision

    def _analytic_time(self, op: Op, dims: Tuple[int, ...],
                       backward: bool, precision: str = "") -> float:
        return op_compute_time(op, dims, self.spec, self.dtype_bytes,
                               backward,
                               flash_attention=self.flash_attention,
                               precision=precision, device=self.device,
                               compute_dtype=self.compute_dtype)

    def _op_time(self, op: Op, dims: Tuple[int, ...], backward: bool,
                 precision: str = "") -> float:
        """Per-partition op time: measured (measure mode, cached by
        (op name, dims[, precision]) as the JAX package keys it) or the
        analytic roofline."""
        if self.measure:
            key = (op.name, dims) if not precision \
                else (op.name, dims, precision)
            if key not in self._measure_cache:
                self._measure_cache[key] = self._measure_op(op, dims,
                                                            precision)
            fwd, bwd = self._measure_cache[key]
            return bwd if backward else fwd
        return self._analytic_time(op, dims, backward, precision)

    def measured(self) -> Dict[Tuple, Tuple[float, float]]:
        """Measure mode's timings so far: (op name, dims[, precision])
        -> (forward s, backward s), inf for a partition that cannot
        run."""
        return dict(self._measure_cache)

    def _measure_op(self, op: Op, dims: Tuple[int, ...],
                    precision: str = "") -> Tuple[float, float]:
        """One op sub-shape timed on ``self.device`` -> (fwd_s, bwd_s)
        (the reference's Op::measure_compute_time), through
        ``profiling.profile_op`` on the per-partition shapes of
        ``Op.sub_problem``.  Only an indivisible sub-problem
        (ValueError, AssertionError) and running out of device memory
        score inf: a kernel that fails to build or launch raises."""
        from ..profiling import profile_op

        try:
            in_shapes, w_shapes = op.sub_problem(dims)
        except (AssertionError, ValueError):
            return (float("inf"),) * 2  # indivisible -> invalid config
        try:
            r = profile_op(op,
                           compute_dtype=PRECISION_DTYPES.get(
                               precision, self.compute_dtype),
                           flash_attention=self.flash_attention,
                           input_shapes=in_shapes, weight_shapes=w_shapes,
                           conv_layout=self.conv_layout,
                           device=self.device)
        except torch.OutOfMemoryError:
            torch.cuda.empty_cache()
            return (float("inf"),) * 2
        fwd = r["fwd_ms"] * 1e-3
        bwd = r["bwd_ms"] * 1e-3
        if not np.isfinite(fwd):
            # no float leaf to time (an int-only view op): analytic times
            fwd = self._analytic_time(op, dims, False, precision)
            bwd = self._analytic_time(op, dims, True, precision)
        elif not np.isfinite(bwd) or bwd <= 0.0:
            bwd = 2.0 * fwd  # non-differentiable op: backward ~= 2x fwd
        return fwd, bwd

    def _op_plan(self, op: Op, strategies) -> Tuple:
        """(pc, padded dims, fwd, bwd, sync) for one op — shared between
        the Python and native engines, cached by (op, config)."""
        from ..ops.linear import host_placed
        pc = strategies.get(op.name)
        # a host-placed candidate takes the dense host-gather path, so
        # its table gets no sparse row-gradient discount; the host bit
        # is part of the key because it changes the sync cost
        host = host_placed(pc)
        sparse_tables = frozenset() if host else self.sparse_tables
        precision = self.effective_precision(pc)
        key = (op.name, None if pc is None
               else (tuple(pc.dims), tuple(pc.device_ids), host,
                     precision))
        hit = self._plan_cache.get(key)
        if hit is not None:
            return hit
        if pc is None:
            nd = op.outputs[0].num_dims
            pc = ParallelConfig.data_parallel(
                min(self.num_devices, op.outputs[0].shape[0]), nd)
        out = op.outputs[0]
        dims = pad_degrees(pc.dims, out.num_dims)
        ft = self._op_time(op, dims, backward=False, precision=precision)
        bt = self._op_time(op, dims, backward=True, precision=precision)
        sync = 0.0
        if op.weights:
            from ..parallel.mesh import dim_axis_names
            axes = dim_axis_names(out.num_dims)
            # a channel split shards a weight with a sharded_dim (its
            # replica groups span the non-c degrees, each moving 1/c of
            # the bytes); replicated weights allreduce across all degrees
            c_deg, repl = 1, 1
            for deg, ax in zip(dims, axes):
                if ax == "c":
                    c_deg *= deg
                else:
                    repl *= deg
            # the mesh puts c innermost, so one replica's channel shards
            # are contiguous devices and each host of
            # ``devices_per_slice`` devices holds dps // c_deg members
            # of a replica group
            dps = self.devices_per_slice
            for w in op.weights:
                if not w.trainable:
                    continue
                wb = w.volume * 4
                if w.name in sparse_tables:
                    # sparse-update table: replicas exchange the touched
                    # rows' gradients (ids x row width), not the table
                    wb = op.inputs[0].volume * w.shape[-1] * 4
                if (w.sharded_dim is not None and c_deg > 1
                        and w.shape[w.sharded_dim] % c_deg == 0):
                    sync += allreduce_time(
                        wb / c_deg, min(repl, self.num_devices), self.spec,
                        members_per_slice=max(1, dps // c_deg))
                else:
                    sync += allreduce_time(
                        wb, min(repl * c_deg, self.num_devices), self.spec,
                        members_per_slice=dps)
        plan = (pc, dims, ft, bt, sync)
        self._plan_cache[key] = plan
        return plan

    def op_time_shares(self, layers: List[Op], strategies,
                       subset: Optional[List[str]] = None
                       ) -> Dict[str, float]:
        """Each op's share of the summed per-op time (fwd + bwd + sync)
        under ``strategies`` — the hybrid search's guided proposal
        weights.  ``subset`` restricts the normalization to those op
        names.  Non-finite plans contribute zero; an all-zero vector
        degrades to uniform."""
        names = subset if subset is not None else [op.name for op in layers]
        wanted = set(names)
        raw: Dict[str, float] = {}
        for op in layers:
            if op.name not in wanted:
                continue
            _, _, ft, bt, sync = self._op_plan(op, strategies)
            t = ft + bt + sync
            raw[op.name] = t if math.isfinite(t) and t > 0 else 0.0
        total = sum(raw.values())
        if total <= 0:
            u = 1.0 / max(1, len(raw))
            return {n: u for n in raw}
        return {n: v / total for n, v in raw.items()}

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

    def _warn_remat_legality(self) -> None:
        """One warning when a remat=True simulator scores a strategy inf
        on the no-remat legality set (shared with SimSession)."""
        if self.remat and not self._warned_remat_legality:
            self._warned_remat_legality = True
            import warnings
            warnings.warn(
                "device-memory legality charges the NO-REMAT activation "
                "set even though this Simulator has remat=True: "
                "strategies scoring inf here may still fit with remat, "
                "but that is unmeasured", stacklevel=3)

    def session(self, layers: List[Op], overlap_backward_update: bool = False,
                mesh_shape: Optional[Dict[str, int]] = None,
                backend: str = "auto", delta_threshold: float = 0.25):
        """A :class:`~flexflow_tpu_torch.search.session.SimSession` over
        this simulator — the stateful delta simulation: the model is
        marshalled once, each ``evaluate()`` re-simulates only what a
        proposal changed.  Results are bit-identical to ``simulate()``."""
        from .session import SimSession
        return SimSession(self, layers,
                          overlap_backward_update=overlap_backward_update,
                          mesh_shape=mesh_shape, backend=backend,
                          delta_threshold=delta_threshold)

    def _simulate_native(self, layers: List[Op],
                         strategies: Dict[str, ParallelConfig],
                         overlap_backward_update: bool) -> float:
        """Marshal the model into flat arrays and run the C++ engine."""
        import ctypes

        MAXD = 4
        n = len(layers)
        fwd = np.zeros(n)
        bwd = np.zeros(n)
        sync = np.zeros(n)
        rank = np.zeros(n, np.int32)
        out_shape = np.zeros(n * MAXD, np.int64)
        out_dims = np.ones(n * MAXD, np.int64)
        dev_off = np.zeros(n + 1, np.int32)
        dev_ids: List[int] = []
        in_off = np.zeros(n + 1, np.int32)
        in_prod: List[int] = []
        in_rank: List[int] = []
        in_shape: List[int] = []
        uid_to_op = {op.outputs[0].uid: i for i, op in enumerate(layers)}
        for i, op in enumerate(layers):
            pc, dims, ft, bt, st = self._op_plan(op, strategies)
            if not np.isfinite(ft) or not np.isfinite(bt):
                return float("inf")
            fwd[i], bwd[i], sync[i] = ft, bt, st
            out = op.outputs[0]
            rank[i] = out.num_dims
            out_shape[i * MAXD: i * MAXD + out.num_dims] = out.shape
            out_dims[i * MAXD: i * MAXD + len(dims)] = dims
            dev_ids.extend(int(d) for d in pc.device_ids)
            dev_off[i + 1] = len(dev_ids)
            for t_in in op.inputs:
                in_prod.append(uid_to_op.get(t_in.uid, -1))
                in_rank.append(t_in.num_dims)
                row = list(t_in.shape)[:MAXD]
                in_shape.extend(row + [1] * (MAXD - len(row)))
            in_off[i + 1] = len(in_prod)

        ka = []  # keep-alive

        def q(a, ct):
            arr = np.ascontiguousarray(a)
            ka.append(arr)
            return arr.ctypes.data_as(ctypes.POINTER(ct))

        i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
        return float(self._native.ffsim_simulate(
            n, self.num_devices, self.devices_per_slice,
            q(fwd, f64), q(bwd, f64), q(sync, f64),
            q(rank, i32), q(out_shape, i64), q(out_dims, i64),
            q(dev_off, i32), q(np.asarray(dev_ids, np.int32), i32),
            q(in_off, i32), q(np.asarray(in_prod, np.int32), i32),
            q(np.asarray(in_rank, np.int32), i32),
            q(np.asarray(in_shape, np.int64), i64),
            1 if overlap_backward_update else 0,
            self.spec.ici_bw, self.spec.dcn_bw, self.spec.ici_latency,
            float(self.dtype_bytes)))

    def simulate(self, layers: List[Op],
                 strategies: Dict[str, ParallelConfig],
                 overlap_backward_update: bool = False,
                 mesh_shape: Optional[Dict[str, int]] = None) -> float:
        """Simulated per-iteration runtime (seconds) — the MCMC objective
        (reference simulate_runtime, simulator.cc:275-448).  A strategy
        whose per-device memory, times ``spec.temp_factor``, exceeds the
        device's capacity cannot run and scores inf; legality charges
        the no-remat activation set.  Runs the C++ engine when it
        loaded, else :meth:`simulate_py`."""
        if (self.peak_memory_bytes(layers, strategies, mesh_shape,
                                   assume_remat=False)
                * self.spec.temp_factor > self.spec.hbm_capacity):
            self._warn_remat_legality()
            return float("inf")
        if self._native is not None:
            t = self._simulate_native(layers, strategies,
                                      overlap_backward_update)
            return float("inf") if t >= 1e29 else t
        return self.simulate_py(layers, strategies, overlap_backward_update)

    def simulate_py(self, layers: List[Op],
                    strategies: Dict[str, ParallelConfig],
                    overlap_backward_update: bool = False) -> float:
        """Pure-Python engine (the reference implementation and the
        no-compiler fallback)."""
        tasks: List[SimTask] = []
        # per tensor uid: [(rect lo, rect hi, fwd task, bwd task, device)]
        produced: Dict[int, List[Tuple]] = {}
        fwd_of: Dict[str, List[SimTask]] = {}
        bwd_of: Dict[str, List[SimTask]] = {}
        plans = {op.name: self._op_plan(op, strategies) for op in layers}

        # 1) forward + backward tasks per partition
        for op in layers:
            pc, dims, ft, bt, _sync = plans[op.name]
            out = op.outputs[0]
            if not np.isfinite(ft) or not np.isfinite(bt):
                return float("inf")
            coords = _part_coords(dims)
            f_tasks, b_tasks = [], []
            for i, coord in enumerate(coords):
                dev = pc.device_ids[i % len(pc.device_ids)] % self.num_devices
                tf_ = SimTask(ft, dev, "fwd")
                tb_ = SimTask(bt, dev, "bwd")
                tasks += [tf_, tb_]
                f_tasks.append(tf_)
                b_tasks.append(tb_)
                lo, hi = _part_rect(out.shape, dims, coord)
                produced.setdefault(out.uid, []).append(
                    (lo, hi, tf_, tb_, dev))
            fwd_of[op.name] = f_tasks
            bwd_of[op.name] = b_tasks

            # 2) dependency + comm edges from producers
            for t_in in op.inputs:
                if t_in.uid not in produced:
                    continue
                prods = produced[t_in.uid]
                for i, coord in enumerate(coords):
                    dev = (pc.device_ids[i % len(pc.device_ids)]
                           % self.num_devices)
                    # the consumer reads the input rect its output coord
                    # projects onto
                    in_dims = tuple(dims[: t_in.num_dims]) + \
                        (1,) * max(0, t_in.num_dims - len(dims))
                    in_dims = tuple(min(d, s) if s % max(1, d) == 0 else 1
                                    for d, s in zip(in_dims, t_in.shape))
                    ccoord = tuple(c % d for c, d in zip(coord, in_dims))
                    lo_c, hi_c = _part_rect(t_in.shape, in_dims, ccoord)
                    for (lo_p, hi_p, tf_p, tb_p, dev_p) in prods:
                        vol = _overlap_volume(lo_p, hi_p, lo_c, hi_c)
                        if vol == 0:
                            continue
                        ctask_f = f_tasks[i]
                        ctask_b = b_tasks[i]
                        if dev_p != dev:
                            nb = vol * self.dtype_bytes
                            intra = (dev_p // self.devices_per_slice ==
                                     dev // self.devices_per_slice)
                            ct = SimTask(transfer_time(nb, intra, self.spec),
                                         dev_p, "comm")
                            tasks.append(ct)
                            tf_p.add_next(ct)
                            ct.add_next(ctask_f)
                            # the gradient's mirrored copy in backward
                            ct2 = SimTask(transfer_time(nb, intra,
                                                        self.spec),
                                          dev, "comm")
                            tasks.append(ct2)
                            ctask_b.add_next(ct2)
                            ct2.add_next(tb_p)
                        else:
                            tf_p.add_next(ctask_f)
                            ctask_b.add_next(tb_p)

        # 3) an op's backward waits for its own forward
        for op in layers:
            for tf_, tb_ in zip(fwd_of[op.name], bwd_of[op.name]):
                tf_.add_next(tb_)

        # 4) weight sync: a ring allreduce per parameter over its
        # replicas (reference simulator.cc:327-408), costed in _op_plan
        update_total = 0.0
        for op in layers:
            if not op.weights:
                continue
            t_sync = plans[op.name][4]
            if t_sync <= 0.0:
                continue
            if overlap_backward_update:
                ut = SimTask(t_sync, 0, "update")
                tasks.append(ut)
                for tb_ in bwd_of[op.name]:
                    tb_.add_next(ut)
            else:
                update_total += t_sync

        # 5) event-driven simulation (priority queue over ready tasks)
        dev_free = [0.0] * self.num_devices
        heap: List[Tuple[float, int, SimTask]] = []
        uid = 0
        for t in tasks:
            if t.remaining_deps == 0:
                heapq.heappush(heap, (t.ready_time, uid, t))
                uid += 1
        finish = 0.0
        processed = 0
        while heap:
            ready, _, t = heapq.heappop(heap)
            start = max(ready, dev_free[t.device])
            end = start + t.run_time
            dev_free[t.device] = end
            finish = max(finish, end)
            processed += 1
            for nxt in t.next_tasks:
                nxt.ready_time = max(nxt.ready_time, end)
                nxt.remaining_deps -= 1
                if nxt.remaining_deps == 0:
                    heapq.heappush(heap, (nxt.ready_time, uid, nxt))
                    uid += 1
        if processed != len(tasks):
            return float("inf")  # a cycle: an invalid graph
        return finish + update_total
