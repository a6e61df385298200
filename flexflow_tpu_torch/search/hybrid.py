"""Hybrid exact/stochastic strategy search, the counterpart of the JAX
package's ``search/hybrid.py``.

``search(mode="hybrid")`` composes three pieces:

* **exact where the graph factorizes** — per mesh factorization, the
  decomposition pass (``search/decompose.py``) partitions the op graph
  into linear chains and reconvergent diamonds and solves each region
  OPTIMALLY with the Viterbi DP over ``legal_configs``, scoring with
  the Simulator's own ``_op_plan`` + ``transfer_time`` terms — one cost
  function for DP and MCMC;
* **stochastic only on the residual** — the frozen region ops never
  mutate; the existing SimSession-backed Metropolis anneal walks only
  the cross-region variables, with a **cost-model-guided proposal
  distribution**: op *i* is mutated with probability
  ``beta * share_i + (1 - beta) / N`` where ``share_i`` is its
  simulated time share (``Simulator.op_time_shares``) and ``beta``
  anneals ``GUIDE_BETA0 -> 0`` over the budget.  The ``(1 - beta)/N``
  uniform floor keeps every residual op proposable at every
  temperature, so the chain remains ergodic over the residual space —
  guidance biases, it never silences (1805.08166's guided-proposal
  posture);
* **warm-start transfer** — chains seed from the best prior strategy
  for the same :func:`~flexflow_tpu_torch.search.decompose.graph_digest`,
  read from an on-disk :class:`BestStrategyStore` keyed like the
  CalibrationTable (digest × device count × estimator), and the store
  is updated when the new search wins.

Fully-decomposable graphs (no residual) skip annealing entirely: the
exact solution is returned with ``proposals == 0`` and the saved budget
is logged — the twin of the singleton early-exit in ``mcmc.search``.
The store's file format is the JAX package's, so either package reads
the other's table.
"""

from __future__ import annotations

import json
import math
import os
import random
import time
from typing import Dict, List, Optional, Tuple

from ..config import ParallelConfig
from ..op import Op
from .decompose import (MAX_EXACT_CANDIDATES, decompose, graph_digest,
                        solve_regions)

MeshShape = Dict[str, int]

# guided-proposal mix at iteration 0: 80% cost-model share, 20% uniform
# floor, annealed linearly back to fully uniform by the end of the
# budget (ergodicity: every residual op stays proposable throughout)
GUIDE_BETA0 = 0.8

STORE_KIND = "best_strategy_store"
STORE_VERSION = 1


# ---------------------------------------------------------------------------
# warm-start transfer: the on-disk best-known table
# ---------------------------------------------------------------------------

class BestStrategyStore:
    """Best-known strategies keyed by
    ``graph_digest|d<ndev>|<estimator>|<calibration>`` — the same
    kind/version/digest + atomic-save discipline as the
    CalibrationTable, so the table survives hand inspection and a
    crashed writer never leaves a truncated file.  Values carry the
    wire-format strategy bytes (hex), the mesh, and the simulated time
    that earned the entry; ``put`` only replaces an entry the new time
    actually beats."""

    def __init__(self):
        self.version = STORE_VERSION
        self.entries: Dict[str, Dict] = {}

    @staticmethod
    def key(digest: str, num_devices: int, estimator) -> str:
        desc = (estimator.describe() if estimator is not None
                else {"estimator": "analytic", "calibration_digest": None})
        return (f"{digest}|d{int(num_devices)}|{desc['estimator']}"
                f"|{desc['calibration_digest'] or 'none'}")

    def get(self, key: str) -> Optional[Tuple[Dict[str, ParallelConfig],
                                              MeshShape, float]]:
        rec = self.entries.get(key)
        if rec is None:
            return None
        from ..strategy.proto import loads
        try:
            strategies = loads(bytes.fromhex(rec["strategy_hex"]))
        except (ValueError, KeyError):
            return None
        return strategies, dict(rec.get("mesh") or {}), \
            float(rec.get("time_ms", math.inf)) * 1e-3

    def put(self, key: str, strategies: Dict[str, ParallelConfig],
            mesh: MeshShape, time_s: float) -> bool:
        rec = self.entries.get(key)
        if rec is not None and rec.get("time_ms", math.inf) <= time_s * 1e3:
            return False
        from ..strategy.proto import dumps, strategy_digest
        self.entries[key] = {
            "strategy_hex": dumps(strategies).hex(),
            "strategy_digest": strategy_digest(strategies),
            "mesh": {a: s for a, s in mesh.items() if s > 1},
            "time_ms": round(time_s * 1e3, 6),
        }
        return True

    # -- (de)serialization ------------------------------------------
    def _payload(self) -> Dict:
        return {"kind": STORE_KIND, "version": self.version,
                "entries": self.entries}

    def to_json(self) -> Dict:
        from .calibration import content_digest
        return {**self._payload(), "digest": content_digest(self._payload())}

    def save(self, path: str) -> str:
        d = self.to_json()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return d["digest"]

    @classmethod
    def load(cls, path: str) -> "BestStrategyStore":
        with open(path) as f:
            data = json.load(f)
        errs = validate_store(data)
        if errs:
            raise ValueError("invalid best-strategy store: "
                             + "; ".join(errs[:5]))
        s = cls()
        s.version = data["version"]
        s.entries = {k: dict(v) for k, v in data.get("entries", {}).items()}
        return s

    @classmethod
    def load_or_empty(cls, path: str) -> "BestStrategyStore":
        """A missing file is an empty store (first run); a CORRUPT file
        is an error — silently dropping a damaged table would erase
        every prior search's transfer value without a trace."""
        if not path or not os.path.exists(path):
            return cls()
        return cls.load(path)


def validate_store(data: Dict) -> List[str]:
    """Schema errors for a BestStrategyStore JSON (empty = valid)."""
    from .calibration import content_digest
    errs: List[str] = []
    if not isinstance(data, dict):
        return ["top level: want an object"]
    if data.get("kind") != STORE_KIND:
        errs.append(f"kind: want {STORE_KIND!r}, got {data.get('kind')!r}")
    if not isinstance(data.get("version"), int):
        errs.append("version: want an int")
    entries = data.get("entries", {})
    if not isinstance(entries, dict):
        errs.append("entries: want an object")
        entries = {}
    for key, rec in entries.items():
        if len(key.split("|")) != 4:
            errs.append(f"entries[{key!r}]: key is not "
                        "digest|dN|estimator|calibration")
        if not isinstance(rec, dict):
            errs.append(f"entries[{key!r}]: not an object")
            continue
        if not isinstance(rec.get("strategy_hex"), str):
            errs.append(f"entries[{key!r}].strategy_hex: want a string")
        tm = rec.get("time_ms")
        if not isinstance(tm, (int, float)) or tm != tm or tm < 0:
            errs.append(f"entries[{key!r}].time_ms: want a non-negative "
                        f"number, got {tm!r}")
    if "digest" in data:
        want = content_digest(data)
        if data["digest"] != want:
            errs.append(f"digest mismatch: file says {data['digest']}, "
                        f"content is {want}")
    else:
        errs.append("digest: missing")
    return errs


# ---------------------------------------------------------------------------
# the hybrid driver
# ---------------------------------------------------------------------------

def run_hybrid(layers: List[Op], num_devices: int, budget: int,
               alpha: float, seed: int, sim,
               overlap_backward_update: bool = False,
               chains: int = 1, fixed_mesh: Optional[MeshShape] = None,
               precision_axis: bool = False, verbose: bool = False,
               warm_start: str = "", stats: Optional[Dict] = None,
               max_exact_candidates: int = MAX_EXACT_CANDIDATES,
               ) -> Tuple[Dict[str, ParallelConfig], MeshShape, float]:
    """The ``mode="hybrid"`` body — called by ``mcmc.search`` AFTER the
    shared Simulator is resolved, so every objective knob (estimator,
    spec, sparse tables, dtype...) arrives exactly as the MCMC path
    would see it.  Returns the same ``(best, mesh, time)`` triple."""
    from ..fflogger import get_logger
    from ..parallel.mesh import AXES
    from .mcmc import (aligned_for_mesh, candidate_meshes, greedy_for_mesh,
                       legal_configs)
    from .simulator import Simulator
    log = get_logger("search")
    wall0 = time.perf_counter()
    if fixed_mesh is not None:
        pinned = {a: int(fixed_mesh.get(a, 1)) for a in AXES}
        meshes = [pinned]
    else:
        meshes = candidate_meshes(num_devices)

    # seed/DP ranking uses the analytic clone in measure mode, exactly
    # like the MCMC multi-start: timing every mesh's DP on the device
    # would dwarf the anneal it replaces.  The acceptance loop below (and the
    # final re-score) still run on `sim`, so the objective is unchanged.
    rank_sim = sim if not sim.measure else Simulator(
        spec=sim.spec, num_devices=num_devices,
        devices_per_slice=sim.devices_per_slice, remat=sim.remat,
        flash_attention=sim.flash_attention,
        compute_dtype=sim.compute_dtype, conv_layout=sim.conv_layout,
        opt_slot_bytes=sim.opt_slot_bytes,
        sparse_tables=sim.sparse_tables, estimator=sim.estimator,
        device=sim.device)

    regions, residual_idx = decompose(layers)
    digest = graph_digest(layers)

    cand_cache: Dict[Tuple[str, Tuple[int, ...]], List[ParallelConfig]] = {}

    def cands_for(ms: MeshShape) -> Dict[str, List[ParallelConfig]]:
        out = {}
        for op in layers:
            key = (op.name, tuple(ms[a] for a in AXES))
            if key not in cand_cache:
                cand_cache[key] = legal_configs(op, ms, seed=seed)
            out[op.name] = cand_cache[key]
        return out

    def cands(op: Op, ms: MeshShape) -> List[ParallelConfig]:
        key = (op.name, tuple(ms[a] for a in AXES))
        if key not in cand_cache:
            cand_cache[key] = legal_configs(op, ms, seed=seed)
        return cand_cache[key]

    # -- per-mesh starts: exact DP over regions + greedy residual,
    #    plus the plain greedy/aligned seeds the MCMC multi-start uses
    best: Optional[Dict[str, ParallelConfig]] = None
    best_mesh: MeshShape = dict(meshes[0])
    best_time = math.inf
    best_frozen: List[int] = []
    for ms in meshes:
        mesh_cands = cands_for(ms)
        frozen, frozen_idx, _t_dp = solve_regions(
            rank_sim, layers, regions, mesh_cands,
            max_exact_candidates=max_exact_candidates)
        dp_seed = dict(frozen)
        for i in range(len(layers)):
            op = layers[i]
            if op.name in dp_seed:
                continue
            # residual ops: per-op best node cost (the greedy rule)
            best_pc, best_c = None, math.inf
            for pc in mesh_cands[op.name]:
                _, _, ft, bt, sync = rank_sim._op_plan(op, {op.name: pc})
                c = ft + bt + sync
                if c < best_c:
                    best_pc, best_c = pc, c
            dp_seed[op.name] = best_pc or ParallelConfig.data_parallel(
                1, op.outputs[0].num_dims)
        seeds = [(dp_seed, frozen_idx),
                 (greedy_for_mesh(layers, ms, rank_sim, cands), frozen_idx),
                 (aligned_for_mesh(layers, ms), frozen_idx)]
        for strat, fidx in seeds:
            t = rank_sim.simulate(layers, strat, overlap_backward_update,
                                  mesh_shape=ms)
            if t < best_time:
                best, best_time, best_mesh = strat, t, dict(ms)
                best_frozen = fidx

    # -- warm-start transfer: the best prior strategy for this graph
    store: Optional[BestStrategyStore] = None
    store_key = BestStrategyStore.key(digest, num_devices, sim.estimator)
    warm: Optional[Dict[str, ParallelConfig]] = None
    warm_hit = False
    if warm_start:
        store = BestStrategyStore.load_or_empty(warm_start)
        hit = store.get(store_key)
        if hit is not None:
            prior, prior_mesh, _prior_t = hit
            if all(op.name in prior for op in layers):
                full_mesh = {a: int(prior_mesh.get(a, 1)) for a in AXES}
                if fixed_mesh is None or \
                        tuple(full_mesh[a] for a in AXES) == \
                        tuple(meshes[0][a] for a in AXES):
                    t = rank_sim.simulate(
                        layers, prior, overlap_backward_update,
                        mesh_shape=full_mesh)
                    # a compatible prior was consulted, whether or not
                    # it beats the fresh seeds (on a tie the DP-seeded
                    # start wins: it keeps its freeze set)
                    warm_hit = True
                    if t < best_time:
                        warm = {op.name: prior[op.name] for op in layers}
                        best, best_time = warm, t
                        best_mesh = full_mesh
                        # a transferred strategy respects no freeze set;
                        # the anneal may then touch every op
                        best_frozen = []
                        log.info(f"hybrid: warm start from {warm_start} "
                                 f"({t * 1e3:.3f} ms simulated)")

    if sim.measure:  # re-score the chosen start with the true objective
        best_time = sim.simulate(layers, best, overlap_backward_update,
                                 mesh_shape=best_mesh)

    frozen_names = {layers[i].name for i in best_frozen}
    residual_ops = [op for op in layers if op.name not in frozen_names]
    info = {
        "mode": "hybrid",
        "graph_digest": digest,
        "regions": len(regions),
        "exact_ops": len(layers) - len(residual_ops),
        "residual_ops": len(residual_ops),
        "fully_decomposable": not residual_idx,
        "warm_start_used": warm_hit,
        "warm_start_adopted": warm is not None,
        "proposals": 0, "accepted": 0, "evaluations": 0,
        "best_trace": [(0, best_time)],
    }

    # -- fully-decomposable (or nothing left to mutate): the exact
    #    solution IS the answer; skip annealing and log the savings
    if (not residual_ops and not precision_axis) or budget <= 0:
        info["proposals_saved"] = max(0, budget) * max(1, chains)
        log.info(
            f"hybrid: graph fully decomposable ({info['exact_ops']} ops "
            f"in {len(regions)} exact regions) — annealing skipped, "
            f"{info['proposals_saved']} proposals saved")
        info["time_to_best_ms"] = (time.perf_counter() - wall0) * 1e3
        if stats is not None:
            stats.update(info)
        _maybe_store(store, warm_start, store_key, best, best_mesh,
                     best_time, log)
        return best, best_mesh, best_time

    mutate_ops = residual_ops if residual_ops else list(layers)

    # as on the mcmc path: if every residual op has at
    # most one legal config on the chosen mesh (and no precision axis),
    # every proposal is a no-op — return the seeded optimum directly
    if (not precision_axis
            and all(len(cands(op, best_mesh)) <= 1 for op in mutate_ops)):
        info["proposals_saved"] = max(0, budget) * max(1, chains)
        log.info(
            f"hybrid: every residual op has a single legal config on "
            f"mesh { {a: s for a, s in best_mesh.items() if s > 1} } — "
            f"annealing skipped, {info['proposals_saved']} proposals "
            f"saved")
        info["time_to_best_ms"] = (time.perf_counter() - wall0) * 1e3
        if stats is not None:
            stats.update(info)
        _maybe_store(store, warm_start, store_key, best, best_mesh,
                     best_time, log)
        return best, best_mesh, best_time

    def guide_weights(strategies, beta: float) -> List[float]:
        """p_i = beta * share_i + (1 - beta)/N over the residual ops.
        Shares come from the simulator's own per-op plan times; a
        non-finite or all-zero share vector degrades to uniform."""
        shares = sim.op_time_shares(layers, strategies,
                                    subset=[o.name for o in mutate_ops])
        n = len(mutate_ops)
        return [beta * shares[o.name] + (1.0 - beta) / n
                for o in mutate_ops]

    def run_chain(chain_idx: int):
        import dataclasses

        from ..analysis.legality import allowed_precisions
        rng = random.Random(seed if chain_idx == 0
                            else seed + 7919 * chain_idx)
        cur, cur_t = dict(best), best_time
        b, bt = dict(cur), cur_t
        proposals = accepted = 0
        trace: List[Tuple[int, float]] = []
        t_best_wall = 0.0
        weights = guide_weights(cur, GUIDE_BETA0)
        session = sim.session(layers, overlap_backward_update,
                              mesh_shape=best_mesh)
        try:
            session.evaluate(cur, mesh_shape=best_mesh)  # marshal once
            for it in range(budget):
                beta = GUIDE_BETA0 * max(0.0, 1.0 - it / max(1, budget))
                if precision_axis and rng.random() < 0.25:
                    op = rng.choices(mutate_ops, weights=weights)[0]
                    cur_pc = cur[op.name]
                    opts = [p for p in allowed_precisions(op)
                            if p != cur_pc.precision]
                    if not opts:
                        continue
                    proposal = dict(cur)
                    proposal[op.name] = dataclasses.replace(
                        cur_pc, precision=rng.choice(opts))
                else:
                    op = rng.choices(mutate_ops, weights=weights)[0]
                    choices = cands(op, best_mesh)
                    if not choices:
                        continue
                    new_cfg = rng.choice(choices)
                    if new_cfg.dims == cur[op.name].dims:
                        continue
                    if precision_axis and cur[op.name].precision:
                        new_cfg = dataclasses.replace(
                            new_cfg, precision=cur[op.name].precision)
                    proposal = dict(cur)
                    proposal[op.name] = new_cfg
                proposals += 1
                new_time = session.evaluate(proposal, mesh_shape=best_mesh)
                delta = new_time - cur_t
                both_inf = (not math.isfinite(new_time)
                            and not math.isfinite(cur_t))
                if both_inf or delta < 0 or \
                        (math.isfinite(new_time) and
                         rng.random() < math.exp(-alpha * delta * 1e3)):
                    cur, cur_t = proposal, new_time
                    accepted += 1
                    weights = guide_weights(cur, beta)
                    if cur_t < bt:
                        b, bt = dict(cur), cur_t
                        trace.append((proposals, bt))
                        t_best_wall = time.perf_counter() - wall0
                        if verbose:
                            print(f"[hybrid] chain {chain_idx} iter {it}: "
                                  f"{bt * 1e3:.3f} ms")
        finally:
            evals = getattr(session, "evaluations", 0)
            session.close()
        return bt, chain_idx, b, proposals, accepted, trace, t_best_wall, \
            evals

    chains = max(1, chains)
    if chains == 1 or sim.measure:
        results = [run_chain(c) for c in range(chains)]
    else:
        import concurrent.futures as _cf
        import os as _os
        with _cf.ThreadPoolExecutor(
                max_workers=min(chains, _os.cpu_count() or 1)) as ex:
            results = list(ex.map(run_chain, range(chains)))
    bt, widx, b, _, _, wtrace, wt_best, _ = min(
        results, key=lambda r: (r[0], r[1]))
    if bt < best_time:
        best, best_time = b, bt
    info["proposals"] = sum(r[3] for r in results)
    info["accepted"] = sum(r[4] for r in results)
    info["evaluations"] = sum(r[7] for r in results)
    info["best_trace"] += [(p, t) for p, t in wtrace]
    info["winning_chain"] = widx
    info["time_to_best_ms"] = ((wt_best if wt_best > 0
                                else time.perf_counter() - wall0) * 1e3)
    if stats is not None:
        stats.update(info)
    _maybe_store(store, warm_start, store_key, best, best_mesh, best_time,
                 log)
    return best, best_mesh, best_time


def _maybe_store(store: Optional[BestStrategyStore], path: str, key: str,
                 best, best_mesh, best_time: float, log) -> None:
    """Record the winner into the warm-start table (only when the
    caller configured one, and only when the new time actually beats
    the stored entry)."""
    if store is None or not path or not math.isfinite(best_time):
        return
    if store.put(key, best, best_mesh, best_time):
        store.save(path)
        log.info(f"hybrid: best-known table updated "
                 f"({path}: {key} -> {best_time * 1e3:.3f} ms)")
