"""Graph decomposition + exact DP over decomposable regions, the
counterpart of the JAX package's ``search/decompose.py``.

The per-op objective is separable on large parts of every zoo graph:
where the op graph is a linear chain (or
a series-parallel diamond that reconverges), the simulated iteration
time decomposes into per-op node costs plus pairwise producer/consumer
transition costs — exactly the shape a Viterbi dynamic program solves
OPTIMALLY, with no annealing budget at all (2602.15172's "fast optimal
mapping" observation).  This module supplies the two halves the hybrid
driver (``search/hybrid.py``) composes:

* **decomposition** — :func:`decompose` partitions ``layers`` into
  maximal linear chains (fan-out-free segments: every interior op has
  exactly one in-edge and one out-edge) and reconvergent diamonds
  (one fork op, parallel interior chains, one join op), leaving the
  coupled remainder as the MCMC residual;
* **the exact solver** — :func:`solve_chain` runs the DP over
  ``legal_configs`` per op, scoring with the Simulator's OWN
  ``_op_plan`` times (fwd + bwd + weight-sync allreduce) and
  ``transfer_time`` over partition-rect overlaps for transitions, so
  the DP and the MCMC anneal optimize ONE cost function.

The DP node cost for op *i* under config *c* is
``ft + bt + sync`` from ``sim._op_plan``; the transition cost between
consecutive chain ops is the serialized sum of ``transfer_time`` over
every producer/consumer partition-rect overlap that lands on different
devices, counted once for the forward activation and once for the
mirrored backward cotangent — the same volumes and device rule
(``device_ids[i % len] % num_devices``) the event-driven simulator
wires as COMM tasks.  On a pure chain the event-driven makespan is this
sum exactly (partitions of one op run concurrently on distinct devices;
consecutive ops serialize through their dependency edges), which is why
the DP is exact there and only a *seed* elsewhere.

Ops whose legal-config count exceeds ``max_exact_candidates`` are not
frozen (the O(k·|C|²) DP would dwarf the anneal it replaces); they fall
into the MCMC residual and the cut is logged, never silent — the same
posture as ``legal_configs``' own sampling cap.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import ParallelConfig
from ..op import Op, pad_degrees
from .cost_model import transfer_time
from .simulator import _overlap_volume, _part_coords, _part_rect

# chains longer than this still solve fine; candidate sets wider than
# this make the |C|^2 transition matrix the bottleneck — the op joins
# the MCMC residual instead (logged by decompose_for_mesh)
MAX_EXACT_CANDIDATES = 64


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


# ---------------------------------------------------------------------------
# graph structure
# ---------------------------------------------------------------------------

def build_dag(layers: Sequence[Op]) -> Tuple[List[List[int]], List[List[int]]]:
    """(successors, predecessors) adjacency by layer index.  Mirrors the
    simulator's wiring rule exactly: an input edge exists only when the
    producing tensor's op appears EARLIER in the layer list (both
    ``simulate_py`` and the native marshaling fill ``produced`` as they
    walk), so the DP sees the same dependency graph the objective
    simulates.  Duplicate inputs from one producer collapse to one edge."""
    uid_to_op = {op.outputs[0].uid: i for i, op in enumerate(layers)}
    succs: List[List[int]] = [[] for _ in layers]
    preds: List[List[int]] = [[] for _ in layers]
    for i, op in enumerate(layers):
        seen = set()
        for t_in in op.inputs:
            p = uid_to_op.get(t_in.uid, -1)
            if p < 0 or p >= i or p in seen:
                continue
            seen.add(p)
            succs[p].append(i)
            preds[i].append(p)
    return succs, preds


def graph_digest(layers: Sequence[Op]) -> str:
    """16-hex-char stable digest of the op graph's search-relevant
    identity: op names, types, output shapes and the input wiring.  Two
    processes building the same model get the same digest, so the
    warm-start table (``hybrid.BestStrategyStore``) can key prior
    winners the way the CalibrationTable keys measurements."""
    succs, _ = build_dag(layers)
    h = hashlib.sha256()
    for i, op in enumerate(layers):
        h.update(f"{op.name}|{op.op_type.value}|"
                 f"{tuple(op.outputs[0].shape)}|"
                 f"{sorted(succs[i])}\n".encode())
    return h.hexdigest()[:16]


class Region:
    """One decomposable region: ``kind`` is ``"chain"`` or ``"diamond"``,
    ``ops`` the member layer indices in topological order.  For a
    diamond, ``fork``/``join`` name the endpoints and ``branches`` the
    interior chains (lists of indices, possibly empty for a skip
    edge)."""

    __slots__ = ("kind", "ops", "fork", "join", "branches")

    def __init__(self, kind: str, ops: List[int],
                 fork: Optional[int] = None, join: Optional[int] = None,
                 branches: Optional[List[List[int]]] = None):
        self.kind = kind
        self.ops = ops
        self.fork = fork
        self.join = join
        self.branches = branches or []

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Region({self.kind}, ops={self.ops})"


def decompose(layers: Sequence[Op]) -> Tuple[List[Region], List[int]]:
    """Partition the graph into (regions, residual-op-indices).

    Chains: maximal runs ``v1 -> v2 -> ... -> vk`` where every edge is
    the SOLE out-edge of its tail and the SOLE in-edge of its head —
    the per-op choice + pairwise transition cost along the run is then
    the whole objective contribution of the interior ops (weight sync
    is per-op additive, so it separates too).  Endpoints may touch the
    rest of the graph; interiors may not.

    Diamonds: a fork op with >= 2 out-edges whose successors are
    disjoint interior chains (or direct skip edges) all reconverging at
    one join op with exactly that in-degree — the reconvergent
    series-parallel shape (Inception blocks, residual adds).  Branches
    are conditionally independent given the (fork, join) configs, so
    the DP minimizes each branch per endpoint pair.

    Singleton runs are not regions (nothing pairwise to solve); they
    stay residual.  Every op lands in at most one region."""
    n = len(layers)
    succs, preds = build_dag(layers)
    claimed = [False] * n
    regions: List[Region] = []

    # -- diamonds first (a diamond's interior would otherwise be eaten
    #    by the chain pass, leaving fork/join residual)
    for f in range(n):
        outs = succs[f]
        if len(outs) < 2 or claimed[f]:
            continue
        branches: List[List[int]] = []
        join = None
        ok = True
        for s in outs:
            branch: List[int] = []
            cur = s
            # walk the branch while it is interior (1 in, 1 out)
            while (len(preds[cur]) == 1 and len(succs[cur]) == 1
                   and not claimed[cur]):
                branch.append(cur)
                cur = succs[cur][0]
            # cur is the reconvergence candidate
            if branch and (len(preds[cur]) < 2 or claimed[cur]):
                ok = False
                break
            if not branch:
                # direct fork->join skip edge: cur == s must be the join
                if len(preds[cur]) < 2 or claimed[cur]:
                    ok = False
                    break
            if join is None:
                join = cur
            elif join != cur:
                ok = False
                break
            branches.append(branch)
        if not ok or join is None or claimed[join]:
            continue
        # the join must be fed by exactly these branches (no third party)
        feeders = {b[-1] if b else f for b in branches}
        if set(preds[join]) != feeders or len(preds[join]) != len(outs):
            continue
        interior = [i for b in branches for i in b]
        if any(claimed[i] for i in interior):
            continue
        ops = [f] + sorted(interior) + [join]
        for i in ops:
            claimed[i] = True
        regions.append(Region("diamond", ops, fork=f, join=join,
                              branches=branches))

    # -- maximal chains over what remains
    for start in range(n):
        if claimed[start]:
            continue
        # chain-extendable edge: sole out-edge of tail, sole in-edge of
        # head, both unclaimed
        if (len(preds[start]) == 1 and not claimed[preds[start][0]]
                and len(succs[preds[start][0]]) == 1):
            continue  # not a chain head — an earlier op extends into it
        run = [start]
        cur = start
        while (len(succs[cur]) == 1
               and not claimed[succs[cur][0]]
               and len(preds[succs[cur][0]]) == 1):
            cur = succs[cur][0]
            run.append(cur)
        if len(run) >= 2:
            for i in run:
                claimed[i] = True
            regions.append(Region("chain", run))

    residual = [i for i in range(n) if not claimed[i]]
    regions.sort(key=lambda r: r.ops[0])
    return regions, residual


def fully_decomposable(layers: Sequence[Op]) -> bool:
    """True when decomposition leaves no residual op — the whole
    objective is solvable exactly and the anneal can be skipped
    (``proposals == 0``)."""
    _, residual = decompose(layers)
    return not residual


# ---------------------------------------------------------------------------
# the shared cost terms
# ---------------------------------------------------------------------------

def node_cost(sim, op: Op, pc: ParallelConfig) -> float:
    """Per-op DP node cost under ``sim``'s objective: fwd + bwd + weight
    sync from the Simulator's OWN plan cache — the exact numbers the
    anneal's acceptance test marshals, estimator and all."""
    _, _, ft, bt, sync = sim._op_plan(op, {op.name: pc})
    return ft + bt + sync


def _consumer_in_dims(dims: Tuple[int, ...], t_in) -> Tuple[int, ...]:
    """The consumer-side input partitioning the simulator derives from
    an op's output dims (simulate_py's projection rule, verbatim)."""
    in_dims = tuple(dims[: t_in.num_dims]) + \
        (1,) * max(0, t_in.num_dims - len(dims))
    return tuple(min(d, s) if s % max(1, d) == 0 else 1
                 for d, s in zip(in_dims, t_in.shape))


def transition_cost(sim, prev_op: Op, prev_pc: ParallelConfig,
                    op: Op, pc: ParallelConfig) -> float:
    """Pairwise producer->consumer transition cost: serialized
    ``transfer_time`` over every partition-rect overlap that crosses
    devices, forward activation + mirrored backward cotangent (the two
    COMM tasks the simulator wires per overlap).  Zero when every
    overlap stays on-device — the aligned case the DP rewards."""
    t_edge = next((t for t in op.inputs
                   if t.uid == prev_op.outputs[0].uid), None)
    if t_edge is None:
        return 0.0
    out = prev_op.outputs[0]
    pdims = pad_degrees(prev_pc.dims, out.num_dims)
    cdims = pad_degrees(pc.dims, op.outputs[0].num_dims)
    pdevs = prev_pc.device_ids
    cdevs = pc.device_ids
    ndev = sim.num_devices
    dps = sim.devices_per_slice
    prects = [_part_rect(out.shape, pdims, c) for c in _part_coords(pdims)]
    in_dims = _consumer_in_dims(cdims, t_edge)
    cost = 0.0
    for i, coord in enumerate(_part_coords(cdims)):
        dev_c = cdevs[i % len(cdevs)] % ndev
        ccoord = tuple(c % d for c, d in zip(coord, in_dims))
        lo_c, hi_c = _part_rect(t_edge.shape, in_dims, ccoord)
        for q, (lo_p, hi_p) in enumerate(prects):
            vol = _overlap_volume(lo_p, hi_p, lo_c, hi_c)
            if vol == 0:
                continue
            dev_p = pdevs[q % len(pdevs)] % ndev
            if dev_p == dev_c:
                continue
            nb = vol * sim.dtype_bytes
            intra = (dev_p // dps == dev_c // dps)
            cost += 2.0 * transfer_time(nb, intra, sim.spec)
    return cost


# ---------------------------------------------------------------------------
# exact solvers
# ---------------------------------------------------------------------------

def solve_chain(sim, chain_ops: Sequence[Op],
                candidates: Dict[str, List[ParallelConfig]],
                ) -> Tuple[Dict[str, ParallelConfig], float]:
    """Viterbi DP over one linear chain: minimize
    ``sum_i node_cost(op_i, c_i) + sum_i transition_cost(op_{i-1},
    c_{i-1}, op_i, c_i)`` over the full cartesian candidate space —
    O(k·|C|²) instead of the product the brute force walks.  Returns
    ``(per-op best configs, optimal objective value)``; infeasible
    configs (inf node cost, e.g. indivisible sub-shapes) are skipped,
    and a chain with an all-inf op returns ``(best-effort, inf)``."""
    best_prev: List[float] = []
    back: List[List[int]] = []
    prev_cands: List[ParallelConfig] = []
    for idx, op in enumerate(chain_ops):
        cands = candidates[op.name]
        node = [node_cost(sim, op, pc) for pc in cands]
        if idx == 0:
            best_prev = node
            back.append([-1] * len(cands))
            prev_cands = cands
            continue
        cur = [math.inf] * len(cands)
        choice = [0] * len(cands)
        prev_op = chain_ops[idx - 1]
        for j, pc in enumerate(cands):
            if not math.isfinite(node[j]):
                continue
            bj, bc = math.inf, 0
            for k, ppc in enumerate(prev_cands):
                base = best_prev[k]
                if not math.isfinite(base):
                    continue
                t = base + transition_cost(sim, prev_op, ppc, op, pc)
                if t < bj:
                    bj, bc = t, k
            cur[j] = bj + node[j]
            choice[j] = bc
        best_prev = cur
        back.append(choice)
        prev_cands = cands
    # backtrack from the best terminal state
    j = min(range(len(best_prev)), key=lambda i: (best_prev[i], i))
    total = best_prev[j]
    out: Dict[str, ParallelConfig] = {}
    for idx in range(len(chain_ops) - 1, -1, -1):
        op = chain_ops[idx]
        out[op.name] = candidates[op.name][j]
        j = back[idx][j]
    return out, total


def solve_chain_exhaustive(sim, chain_ops: Sequence[Op],
                           candidates: Dict[str, List[ParallelConfig]],
                           ) -> Tuple[Dict[str, ParallelConfig], float]:
    """Brute-force minimization of the SAME objective ``solve_chain``
    optimizes — the pinned ground truth for the DP's exactness claim
    Exponential; small graphs only."""
    import itertools
    names = [op.name for op in chain_ops]
    best: Optional[Dict[str, ParallelConfig]] = None
    best_t = math.inf
    for combo in itertools.product(*(candidates[n] for n in names)):
        t = 0.0
        for idx, (op, pc) in enumerate(zip(chain_ops, combo)):
            t += node_cost(sim, op, pc)
            if idx:
                t += transition_cost(sim, chain_ops[idx - 1],
                                     combo[idx - 1], op, pc)
        if t < best_t:
            best_t = t
            best = dict(zip(names, combo))
    if best is None:
        best = {n: candidates[n][0] for n in names}
    return best, best_t


def solve_diamond(sim, layers: Sequence[Op], region: Region,
                  candidates: Dict[str, List[ParallelConfig]],
                  ) -> Tuple[Dict[str, ParallelConfig], float]:
    """Exact solve of a reconvergent diamond: for each (fork, join)
    config pair, every branch minimizes independently (a branch is a
    chain conditioned on its endpoints); branch costs ADD — partitions
    of parallel branches contend for the same devices in the
    event-driven objective, so serialization is the faithful model (and
    the conservative one).  O(|Cf|·|Cj|·Σ branch DP)."""
    fork, join = layers[region.fork], layers[region.join]
    f_cands, j_cands = candidates[fork.name], candidates[join.name]
    branches = [[layers[i] for i in b] for b in region.branches]

    def branch_min(branch: List[Op], fpc, jpc) -> Tuple[Dict, float]:
        if not branch:  # direct skip edge fork->join
            return {}, transition_cost(sim, fork, fpc, join, jpc)
        # DP along the branch with pinned endpoints
        prev = [node_cost(sim, branch[0], pc)
                + transition_cost(sim, fork, fpc, branch[0], pc)
                for pc in candidates[branch[0].name]]
        back: List[List[int]] = [[-1] * len(prev)]
        for idx in range(1, len(branch)):
            op, prev_op = branch[idx], branch[idx - 1]
            cands = candidates[op.name]
            pcands = candidates[prev_op.name]
            cur = [math.inf] * len(cands)
            choice = [0] * len(cands)
            for j, pc in enumerate(cands):
                nc = node_cost(sim, op, pc)
                if not math.isfinite(nc):
                    continue
                bj, bc = math.inf, 0
                for k, ppc in enumerate(pcands):
                    if not math.isfinite(prev[k]):
                        continue
                    t = prev[k] + transition_cost(sim, prev_op, ppc,
                                                  op, pc)
                    if t < bj:
                        bj, bc = t, k
                cur[j] = bj + nc
                choice[j] = bc
            prev = cur
            back.append(choice)
        # close onto the pinned join
        last = branch[-1]
        total = [p + (transition_cost(sim, last,
                                      candidates[last.name][k], join, jpc)
                      if math.isfinite(p) else math.inf)
                 for k, p in enumerate(prev)]
        j = min(range(len(total)), key=lambda i: (total[i], i))
        t = total[j]
        sel: Dict[str, ParallelConfig] = {}
        for idx in range(len(branch) - 1, -1, -1):
            sel[branch[idx].name] = candidates[branch[idx].name][j]
            j = back[idx][j]
        return sel, t

    best: Optional[Dict[str, ParallelConfig]] = None
    best_t = math.inf
    for fpc in f_cands:
        fc = node_cost(sim, fork, fpc)
        if not math.isfinite(fc):
            continue
        for jpc in j_cands:
            jc = node_cost(sim, join, jpc)
            if not math.isfinite(jc):
                continue
            t = fc + jc
            sel = {fork.name: fpc, join.name: jpc}
            ok = True
            for branch in branches:
                bsel, bt = branch_min(branch, fpc, jpc)
                if not math.isfinite(bt):
                    ok = False
                    break
                t += bt
                sel.update(bsel)
            if ok and t < best_t:
                best_t, best = t, sel
    if best is None:
        best = {layers[i].name: candidates[layers[i].name][0]
                for i in region.ops}
    return best, best_t


def solve_regions(sim, layers: Sequence[Op], regions: Sequence[Region],
                  candidates: Dict[str, List[ParallelConfig]],
                  max_exact_candidates: int = MAX_EXACT_CANDIDATES,
                  ) -> Tuple[Dict[str, ParallelConfig], List[int], float]:
    """Solve every region whose ops all fit the candidate cap; returns
    (exact per-op configs, indices of ops actually frozen, summed
    region objective).  Regions with an over-cap op are skipped whole
    (a half-frozen chain would pin a transition the DP never scored)
    and the cut is logged."""
    frozen: Dict[str, ParallelConfig] = {}
    frozen_idx: List[int] = []
    total = 0.0
    skipped: List[str] = []
    for region in regions:
        if any(len(candidates[layers[i].name]) > max_exact_candidates
               for i in region.ops):
            skipped.append(f"{region.kind}@{layers[region.ops[0]].name}")
            continue
        if region.kind == "chain":
            sel, t = solve_chain(sim, [layers[i] for i in region.ops],
                                 candidates)
        else:
            sel, t = solve_diamond(sim, layers, region, candidates)
        if not math.isfinite(t):
            # no feasible assignment on this mesh — leave to the anneal
            skipped.append(f"{region.kind}@{layers[region.ops[0]].name}")
            continue
        frozen.update(sel)
        frozen_idx.extend(region.ops)
        total += t
    if skipped:
        from ..fflogger import get_logger
        get_logger("search").info(
            f"decompose: {len(skipped)} region(s) left to the anneal "
            f"(candidate cap {max_exact_candidates} or infeasible): "
            f"{', '.join(skipped[:4])}")
    return frozen, sorted(frozen_idx), total


# ---------------------------------------------------------------------------
# the data-parallel baseline
# ---------------------------------------------------------------------------

def data_parallel_strategies(layers: Sequence[Op],
                             num_devices: int) -> Dict[str, ParallelConfig]:
    """The data-parallel baseline strategy (batch dim split across all
    devices, capped by the batch size)."""
    return {op.name: ParallelConfig.data_parallel(
        min(num_devices, op.outputs[0].shape[0]), op.outputs[0].num_dims)
        for op in layers}
