"""Stateful search-evaluation session — the paper's *delta simulation*,
the counterpart of the JAX package's ``search/session.py``.

The MCMC loop mutates exactly one op's ``ParallelConfig`` per proposal
(``search/mcmc.py``), yet the one-shot ``Simulator.simulate()`` re-marshals
every op and rebuilds the whole task graph each time, and
``peak_memory_bytes`` re-walks every weight.  :class:`SimSession` keeps the
(mesh, model) marshaled once and makes each proposal cost only its delta:

* per-op plans (times, sync, padded degrees) come from the Simulator's
  existing ``(op, config)``-keyed plan cache;
* peak memory is maintained as per-op contributions — only the changed
  op's ``op_memory_bytes`` is recomputed, and the memory legality sum is
  re-added in layer order so it is BIT-IDENTICAL to the one-shot
  ``peak_memory_bytes`` loop (no incremental float drift);
* the native engine (``native/simulator.cpp``) holds the task graph in a
  persistent ``ffsim_create`` state: ``ffsim_update_op`` invalidates only
  the link specs of edges incident to the changed op, and
  ``ffsim_state_simulate`` delta-repairs or replays in C++;
* without the native library, :class:`_PyDeltaEngine` mirrors the same
  caching in pure Python, reproducing ``Simulator.simulate_py``'s task
  construction order and heap tie-breaks exactly.

Both backends return makespans bit-identical to the one-shot path.
"""

from __future__ import annotations

import ctypes
import heapq
import math
from typing import Dict, List, Optional, Tuple

from ..config import ParallelConfig
from ..op import Op, pad_degrees

_MAXD = 4


def _plan_rows(sim, op: Op, strategies) -> Tuple:
    """(plan, padded-dims-MAXD, device_ids) for one op under a strategy."""
    plan = sim._op_plan(op, strategies)
    pc, dims = plan[0], plan[1]
    dims4 = tuple(dims) + (1,) * (_MAXD - len(dims))
    return plan, dims4, tuple(int(d) for d in pc.device_ids)


class _PyDeltaEngine:
    """Pure-Python stateful engine: cached per-edge link specs + task
    reassembly, mirroring ``Simulator.simulate_py`` exactly (same task
    list order, same ``add_next`` order, same heap uids) so session
    results equal the one-shot pure-Python results bit for bit."""

    def __init__(self, layers: List[Op], num_devices: int,
                 devices_per_slice: int, spec, dtype_bytes: int):
        self.num_devices = num_devices
        self.dps = devices_per_slice
        self.spec = spec
        self.dtype_bytes = dtype_bytes
        n = len(layers)
        self.n_ops = n
        self.out_shape = [tuple(op.outputs[0].shape) for op in layers]
        self.rank = [op.outputs[0].num_dims for op in layers]
        # simulate_py only wires inputs whose producer appeared EARLIER
        # in the layer list (``produced`` is filled as the loop walks) —
        # mirror that rule here
        uid_to_op = {op.outputs[0].uid: i for i, op in enumerate(layers)}
        self.edges: List[Tuple[int, int, Tuple[int, ...], int]] = []
        self.op_in_edges: List[List[int]] = [[] for _ in range(n)]
        self.op_out_edges: List[List[int]] = [[] for _ in range(n)]
        for i, op in enumerate(layers):
            for t_in in op.inputs:
                prod = uid_to_op.get(t_in.uid, -1)
                if prod < 0 or prod >= i:
                    continue
                e = len(self.edges)
                self.edges.append((i, prod, tuple(t_in.shape),
                                   t_in.num_dims))
                self.op_in_edges[i].append(e)
                self.op_out_edges[prod].append(e)
        # mutable rows
        self.fwd = [0.0] * n
        self.bwd = [0.0] * n
        self.sync = [0.0] * n
        self.dims: List[Tuple[int, ...]] = [()] * n
        self.devs: List[Tuple[int, ...]] = [()] * n
        self.has_weights = [bool(op.weights) for op in layers]
        # cached link specs: per edge, [(consumer part, producer part,
        # overlap volume), ...] in (p-major, q-minor) order
        self._links: List[Optional[List[Tuple[int, int, int]]]] = \
            [None] * len(self.edges)
        self._tasks = None
        self._dirty_struct = True
        self._overlap_built: Optional[bool] = None
        self.stat_edge_rebuilds = 0
        self.stat_replays = 0
        self.stat_assemblies = 0

    # -- updates ----------------------------------------------------
    def update_op(self, i: int, fwd: float, bwd: float, sync: float,
                  dims: Tuple[int, ...], devs: Tuple[int, ...]) -> None:
        structural = (self.dims[i] != tuple(dims)
                      or self.devs[i] != tuple(devs))
        self.fwd[i], self.bwd[i], self.sync[i] = fwd, bwd, sync
        self.dims[i], self.devs[i] = tuple(dims), tuple(devs)
        if structural:
            self._dirty_struct = True
            for e in self.op_in_edges[i]:
                self._links[e] = None
            for e in self.op_out_edges[i]:
                self._links[e] = None

    # -- link specs -------------------------------------------------
    def _build_links(self, e: int) -> List[Tuple[int, int, int]]:
        from .simulator import _overlap_volume, _part_coords, _part_rect
        cons, prod, in_shape, in_rank = self.edges[e]
        dims = self.dims[cons][: self.rank[cons]]
        pdims = self.dims[prod][: self.rank[prod]]
        pshape = self.out_shape[prod]
        prects = [_part_rect(pshape, pdims, c) for c in _part_coords(pdims)]
        links = []
        for i, coord in enumerate(_part_coords(dims)):
            in_dims = tuple(dims[: in_rank]) + \
                (1,) * max(0, in_rank - len(dims))
            in_dims = tuple(min(d, s) if s % max(1, d) == 0 else 1
                            for d, s in zip(in_dims, in_shape))
            ccoord = tuple(c % d for c, d in zip(coord, in_dims))
            lo_c, hi_c = _part_rect(in_shape, in_dims, ccoord)
            for q, (lo_p, hi_p) in enumerate(prects):
                vol = _overlap_volume(lo_p, hi_p, lo_c, hi_c)
                if vol > 0:
                    links.append((i, q, vol))
        self.stat_edge_rebuilds += 1
        return links

    # -- assembly (mirrors simulate_py's construction order) --------
    def _assemble(self, overlap: bool) -> None:
        from .cost_model import transfer_time
        from .simulator import SimTask, _part_coords
        tasks: List[SimTask] = []
        fwd_of: List[List[SimTask]] = []
        bwd_of: List[List[SimTask]] = []
        for i in range(self.n_ops):
            dims = self.dims[i][: self.rank[i]]
            devs = self.devs[i]
            nd = len(devs)
            nparts = len(_part_coords(dims))
            f_tasks, b_tasks = [], []
            for p in range(nparts):
                dev = devs[p % nd] % self.num_devices
                tf_ = SimTask(self.fwd[i], dev, "fwd")
                tb_ = SimTask(self.bwd[i], dev, "bwd")
                tasks += [tf_, tb_]
                f_tasks.append(tf_)
                b_tasks.append(tb_)
            fwd_of.append(f_tasks)
            bwd_of.append(b_tasks)
            for e in self.op_in_edges[i]:
                _, prod, _, _ = self.edges[e]
                if self._links[e] is None:
                    self._links[e] = self._build_links(e)
                pdevs = self.devs[prod]
                pnd = len(pdevs)
                for (p, q, vol) in self._links[e]:
                    dev = devs[p % nd] % self.num_devices
                    dev_p = pdevs[q % pnd] % self.num_devices
                    if dev_p != dev:
                        nb = vol * self.dtype_bytes
                        intra = (dev_p // self.dps == dev // self.dps)
                        ct = SimTask(transfer_time(nb, intra, self.spec),
                                     dev_p, "comm")
                        tasks.append(ct)
                        fwd_of[prod][q].add_next(ct)
                        ct.add_next(f_tasks[p])
                        ct2 = SimTask(transfer_time(nb, intra, self.spec),
                                      dev, "comm")
                        tasks.append(ct2)
                        b_tasks[p].add_next(ct2)
                        ct2.add_next(bwd_of[prod][q])
                    else:
                        fwd_of[prod][q].add_next(f_tasks[p])
                        b_tasks[p].add_next(bwd_of[prod][q])
        for i in range(self.n_ops):
            for tf_, tb_ in zip(fwd_of[i], bwd_of[i]):
                tf_.add_next(tb_)
        self._update_tasks: List = []
        self._overlap_ops: List[int] = []
        if overlap:
            for i in range(self.n_ops):
                if not self.has_weights[i] or self.sync[i] <= 0.0:
                    continue
                ut = SimTask(self.sync[i], 0, "update")
                tasks.append(ut)
                for tb_ in bwd_of[i]:
                    tb_.add_next(ut)
                self._overlap_ops.append(i)
                self._update_tasks.append(ut)
        self._tasks = tasks
        self._base_deps = [t.remaining_deps for t in tasks]
        self._fwd_of, self._bwd_of = fwd_of, bwd_of
        self._overlap_built = overlap
        self._dirty_struct = False
        self.stat_assemblies += 1

    # -- simulation -------------------------------------------------
    def simulate(self, overlap: bool) -> float:
        if self._dirty_struct or self._tasks is None \
                or self._overlap_built != overlap:
            self._assemble(overlap)
        else:
            # time-only updates: patch run times on the cached tasks
            for i in range(self.n_ops):
                for tf_ in self._fwd_of[i]:
                    tf_.run_time = self.fwd[i]
                for tb_ in self._bwd_of[i]:
                    tb_.run_time = self.bwd[i]
            if overlap:
                # sync changes move update-task run times; a sync that
                # flips between zero and positive changes the task SET
                want = [i for i in range(self.n_ops)
                        if self.has_weights[i] and self.sync[i] > 0.0]
                if want != self._overlap_ops:
                    self._assemble(overlap)
                else:
                    for i, ut in zip(self._overlap_ops,
                                     self._update_tasks):
                        ut.run_time = self.sync[i]
        tasks = self._tasks
        for t, bd in zip(tasks, self._base_deps):
            t.ready_time = 0.0
            t.remaining_deps = bd
        dev_free = [0.0] * self.num_devices
        heap: List[Tuple[float, int, object]] = []
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
        self.stat_replays += 1
        if processed != len(tasks):
            return float("inf")
        update_total = 0.0
        if not overlap:
            for i in range(self.n_ops):
                if self.has_weights[i] and self.sync[i] > 0.0:
                    update_total += self.sync[i]
        return finish + update_total

    def stats(self) -> Dict[str, int]:
        return {"edge_rebuilds": self.stat_edge_rebuilds,
                "full_replays": self.stat_replays,
                "delta_repairs": 0, "repair_fallbacks": 0,
                "tasks": len(self._tasks or ()),
                "assemblies": self.stat_assemblies}


class SimSession:
    """Incremental evaluation of strategy proposals for one
    (simulator, layers, overlap, mesh) context.

    ``evaluate(strategies, mesh_shape=...)`` returns exactly what
    ``sim.simulate(layers, strategies, overlap, mesh_shape)`` would,
    but each call re-simulates only what changed since the previous
    call.  The session is the per-chain engine behind ``search()``; the
    one-shot path remains for single evaluations.
    """

    def __init__(self, sim, layers: List[Op],
                 overlap_backward_update: bool = False,
                 mesh_shape: Optional[Dict[str, int]] = None,
                 backend: str = "auto", delta_threshold: float = 0.25):
        assert backend in ("auto", "native", "python"), backend
        self.sim = sim
        self.layers = list(layers)
        self.overlap = bool(overlap_backward_update)
        self.mesh_shape = dict(mesh_shape) if mesh_shape else None
        self.delta_threshold = delta_threshold
        self._cur: Dict[str, Optional[ParallelConfig]] = {}
        self._mem: Dict[str, float] = {}
        self._mem_cache: Dict[Tuple, float] = {}
        self._bad: set = set()          # ops with non-finite plans
        self._stale: set = set()        # ops whose plan row needs refresh
        self._pending: Dict[int, Tuple] = {}   # op idx -> engine row
        self._idx_of = {op.name: i for i, op in enumerate(self.layers)}
        # total evaluate() calls — the per-chain proposal-throughput
        # denominator the search's stats stamp
        self.evaluations = 0
        self._first = True
        self._handle = None
        self._py = None
        self._lib = sim._native if backend in ("auto", "native") else None
        if backend == "native" and self._lib is None:
            raise RuntimeError("native backend requested but the ffsim "
                               "library is unavailable")
        if self._lib is not None:
            self._create_native()
        else:
            self._py = _PyDeltaEngine(self.layers, sim.num_devices,
                                      sim.devices_per_slice, sim.spec,
                                      sim.dtype_bytes)

    # -- native handle ----------------------------------------------
    def _create_native(self) -> None:
        import numpy as np
        n = len(self.layers)
        rank = np.zeros(n, np.int32)
        out_shape = np.zeros(n * _MAXD, np.int64)
        in_off = np.zeros(n + 1, np.int32)
        in_prod: List[int] = []
        in_rank: List[int] = []
        in_shape: List[int] = []
        uid_to_op = {op.outputs[0].uid: i
                     for i, op in enumerate(self.layers)}
        for i, op in enumerate(self.layers):
            out = op.outputs[0]
            rank[i] = out.num_dims
            out_shape[i * _MAXD: i * _MAXD + out.num_dims] = out.shape
            for t_in in op.inputs:
                in_prod.append(uid_to_op.get(t_in.uid, -1))
                in_rank.append(t_in.num_dims)
                row = list(t_in.shape)[:_MAXD]
                in_shape.extend(row + [1] * (_MAXD - len(row)))
            in_off[i + 1] = len(in_prod)

        def p(a, ct):
            arr = np.ascontiguousarray(a)
            return arr, arr.ctypes.data_as(ctypes.POINTER(ct))

        ka = []

        def q(a, ct):
            arr, ptr = p(a, ct)
            ka.append(arr)
            return ptr

        i32, i64 = ctypes.c_int32, ctypes.c_int64
        spec = self.sim.spec
        self._handle = self._lib.ffsim_create(
            n, self.sim.num_devices, self.sim.devices_per_slice,
            q(rank, i32), q(out_shape, i64),
            q(in_off, i32), q(np.asarray(in_prod, np.int32), i32),
            q(np.asarray(in_rank, np.int32), i32),
            q(np.asarray(in_shape, np.int64), i64),
            spec.ici_bw, spec.dcn_bw, spec.ici_latency,
            float(self.sim.dtype_bytes), float(self.delta_threshold))

    def close(self) -> None:
        if self._handle is not None and self._lib is not None:
            self._lib.ffsim_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- incremental peak memory ------------------------------------
    def _mem_bytes(self, op: Op, pc: Optional[ParallelConfig],
                   mesh_shape) -> float:
        """One op's ``op_memory_bytes`` contribution under the legality
        settings ``simulate()`` uses (assume_remat=False) — cached by
        (op, dims, stack, host)."""
        from ..ops.linear import host_placed
        from ..parallel.mesh import dim_axis_names
        from .cost_model import op_memory_bytes, precision_dtype_bytes
        out = op.outputs[0]
        if pc is None:
            dims = tuple(ParallelConfig.data_parallel(
                min(self.sim.num_devices, out.shape[0]), out.num_dims).dims)
        else:
            dims = pad_degrees(pc.dims, out.num_dims)
        stack = {a: (mesh_shape or {}).get(a, 1) for a in ("e", "p")}
        host = host_placed(pc)
        # the op's strategy precision changes its activation byte width
        # — part of the cache key, and the same
        # effective_precision + precision_dtype_bytes rules the one-shot
        # peak_memory_bytes applies, so session and one-shot sums stay
        # bit-identical
        precision = self.sim.effective_precision(pc)
        key = (op.name, dims, stack["e"], stack["p"], host, precision)
        hit = self._mem_cache.get(key)
        if hit is None:
            hit = op_memory_bytes(
                op, dims,
                precision_dtype_bytes(precision, self.sim.dtype_bytes),
                opt_slot_bytes=self.sim.opt_slot_bytes,
                axes=dim_axis_names(out.num_dims), stack_degrees=stack,
                remat=False, act_scale=1.0,
                sparse_tables=(frozenset() if host
                               else self.sim.sparse_tables))
            self._mem_cache[key] = hit
        return hit

    def peak_memory_bytes(self) -> float:
        """Incrementally-maintained equivalent of
        ``sim.peak_memory_bytes(layers, strategies, mesh_shape,
        assume_remat=False)`` for the last-evaluated strategies.  Summed
        in layer order so the float result is bit-identical."""
        total = 0.0
        for op in self.layers:
            total += self._mem[op.name]
        return total

    # -- evaluation -------------------------------------------------
    def evaluate(self, strategies: Dict[str, ParallelConfig],
                 mesh_shape: Optional[Dict[str, int]] = None) -> float:
        """Simulated iteration time of ``strategies`` — bit-identical to
        ``sim.simulate(layers, strategies, overlap, mesh_shape)``."""
        self.evaluations += 1
        sim = self.sim
        if mesh_shape is not None and mesh_shape != self.mesh_shape:
            # stack degrees (e/p) feed the memory model only; drop the
            # per-op contributions so they recompute under the new mesh
            self.mesh_shape = dict(mesh_shape)
            self._mem.clear()
        ms = self.mesh_shape
        for op in self.layers:
            new_pc = strategies.get(op.name)
            if (not self._first and op.name in self._mem
                    and new_pc == self._cur.get(op.name)):
                continue
            self._cur[op.name] = new_pc
            self._mem[op.name] = self._mem_bytes(op, new_pc, ms)
            self._stale.add(op.name)
        self._first = False
        # memory legality BEFORE any plan work, exactly like simulate():
        # in measure mode a plan times the op on the device, and the
        # one-shot path never touches the device for a strategy that
        # does not fit.  Stale plan rows stay queued in ``_stale`` until
        # a legal strategy arrives.
        if self.peak_memory_bytes() * sim.spec.temp_factor \
                > sim.spec.hbm_capacity:
            sim._warn_remat_legality()
            return float("inf")
        if self._stale:
            idx_of = self._idx_of
            for name in self._stale:
                op = self.layers[idx_of[name]]
                plan, dims4, devs = _plan_rows(sim, op, strategies)
                _, _, ft, bt, sync = plan
                if not (math.isfinite(ft) and math.isfinite(bt)):
                    self._bad.add(name)
                    self._pending.pop(idx_of[name], None)
                    continue
                self._bad.discard(name)
                self._pending[idx_of[name]] = (ft, bt, sync, dims4, devs)
            self._stale.clear()
        if self._bad:
            return float("inf")
        # flush pending rows into the engine, then (delta-)simulate
        if self._handle is not None:
            for idx, (ft, bt, sync, dims4, devs) in self._pending.items():
                dims_arr = (ctypes.c_int64 * _MAXD)(*dims4)
                devs_arr = (ctypes.c_int32 * len(devs))(*devs)
                self._lib.ffsim_update_op(self._handle, idx, ft, bt, sync,
                                          dims_arr, len(devs), devs_arr)
            self._pending.clear()
            t = float(self._lib.ffsim_state_simulate(
                self._handle, 1 if self.overlap else 0))
            return float("inf") if t >= 1e29 else t
        for idx, (ft, bt, sync, dims4, devs) in self._pending.items():
            self._py.update_op(idx, ft, bt, sync, dims4, devs)
        self._pending.clear()
        return self._py.simulate(self.overlap)

    # -- introspection ----------------------------------------------
    @property
    def backend(self) -> str:
        return "native" if self._handle is not None else "python"

    def stats(self) -> Dict[str, int]:
        """Delta-engine counters (native: ffsim_stat; python: mirrored)
        — how much work proposals actually triggered."""
        if self._handle is not None:
            names = ("edge_rebuilds", "full_replays", "delta_repairs",
                     "repair_fallbacks", "tasks", "assemblies")
            out = {n: int(self._lib.ffsim_stat(self._handle, i))
                   for i, n in enumerate(names)}
        else:
            out = self._py.stats()
        out["evaluations"] = self.evaluations
        return out
