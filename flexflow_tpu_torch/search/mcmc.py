"""MCMC / simulated-annealing strategy search (reference
``FFModel::optimize`` model.cc:1020-1054, ``rewrite`` model.cc:1012-1018),
the counterpart of the JAX package's ``search/mcmc.py``: under the same
DeviceSpec it walks the same proposals and returns the same strategies.

Identical loop shape: start from data parallelism, propose a single-op
mutation to a random legal config, accept if the simulated runtime improves,
else accept with probability ``exp(-alpha * delta)``; budget/alpha from the
``--budget`` / ``--alpha`` flags (model.cc:1253-1260).

Executability contract: the search fixes a *global mesh factorization* of
the device count over the canonical axes (n/c/h/w/s) as part of its state,
and per-op degrees are drawn from the divisors of the chosen axis sizes —
exactly the space MachineMesh's prime sub-axes can realize (mesh.py), so
every strategy this module returns compiles and runs.  A proposal either
mutates one op (the reference's ``rewrite``) or re-factorizes the mesh,
re-seeding every op from a greedy per-op-cost or fully-aligned init for
the new axis sizes; the anneal also STARTS from the best such seed across
all factorizations (multi-start), because the mesh-constrained space
leaves hybrid optima unreachable from a pure-DP start.
"""

from __future__ import annotations

import dataclasses
import math
import random
import warnings
from typing import Dict, List, Optional, Tuple

import torch

from ..analysis.legality import allowed_precisions
from ..analysis.legality import per_dim_degrees as _per_dim_degrees
from ..config import FFConfig, ParallelConfig
from ..op import Op
from ..parallel.mesh import AXES, expressible_degrees
from .cost_model import spec_for_device
from .simulator import Simulator

MeshShape = Dict[str, int]


def _factorizations(n: int, slots: int) -> List[Tuple[int, ...]]:
    """All ordered factorizations of n into `slots` positive factors."""
    if slots == 1:
        return [(n,)]
    out = []
    d = 1
    while d <= n:
        if n % d == 0:
            for rest in _factorizations(n // d, slots - 1):
                out.append((d,) + rest)
        d += 1
    return out


# "p" (pipeline stages) and "e" (experts) are op-less axes sized by their
# ops' users, not by the per-op SOAP search
_SEARCH_AXES = tuple(a for a in AXES if a not in ("p", "e"))


def candidate_meshes(num_devices: int) -> List[MeshShape]:
    """Factorizations of the device count over the per-op canonical axes
    (the pipeline axis is sized explicitly by PipelineBlock users, not by
    the per-op SOAP search)."""
    out = []
    for f in _factorizations(num_devices, len(_SEARCH_AXES)):
        m = dict(zip(_SEARCH_AXES, f))
        m["e"] = 1
        m["p"] = 1
        out.append(m)
    return out


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


# THE per-op legality definition now lives in analysis.legality
# (per_dim_degrees): one predicate module shared by this search, the
# trace-time sharding fallbacks and the static verifier, so the simulator
# can never cost a split the executor silently replicates
# (tests/test_verifier.py cross-checks every proposal).


def legal_configs(op: Op, mesh_shape: MeshShape,
                  max_candidates: int = 1024,
                  seed: int = 0) -> List[ParallelConfig]:
    """Legal configs for one op under a fixed mesh factorization — the
    cartesian product of ``_per_dim_degrees``.

    The FULL product is enumerated; only when it exceeds
    ``max_candidates`` does a seeded uniform sample (always including the
    all-ones config) replace it, and the cut is logged — never silent.
    Index-based sampling keeps every corner of the space (e.g. pure-h/w
    splits late in the product order) reachable."""
    per_dim = _per_dim_degrees(op, mesh_shape)
    total = _prod(len(d) for d in per_dim)
    if total <= max_candidates:
        import itertools
        combos = list(itertools.product(*per_dim))
    else:
        import zlib

        from ..fflogger import get_logger
        get_logger("search").warning(
            f"{op.name}: {total} legal configs exceed max_candidates="
            f"{max_candidates}; sampling uniformly (seeded)")
        # crc32, not hash(): str hashing is salted per-process and would
        # break cross-run reproducibility of the sampled space
        key = f"{seed}:{op.name}:{sorted(mesh_shape.items())}"
        rng = random.Random(zlib.crc32(key.encode()))
        picks = set(rng.sample(range(total), max_candidates))
        picks.add(0)  # index 0 = all-ones (replicated) — always legal
        combos = []
        for flat in sorted(picks):
            dims = []
            for choices in reversed(per_dim):
                flat, r = divmod(flat, len(choices))
                dims.append(choices[r])
            combos.append(tuple(reversed(dims)))
    return [ParallelConfig(dims=dims, device_ids=tuple(range(_prod(dims))))
            for dims in combos]


def greedy_for_mesh(layers: List[Op], mesh_shape: MeshShape, sim: Simulator,
                    cands) -> Dict[str, ParallelConfig]:
    """Per-op best-local-cost init for one mesh factorization: pick each
    op's candidate minimizing its own fwd+bwd+weight-sync time.  Cross-op
    transfer costs are ignored here — the caller ranks the resulting
    strategies with a full simulate() — but this init is what makes
    c/s/h/w-raised meshes REACHABLE: starting every mesh from DP-snapped
    configs leaves the walk a many-op uphill barrier away from any hybrid
    optimum."""
    strat = {}
    for op in layers:
        best_pc, best_c = None, math.inf
        for pc in cands(op, mesh_shape):
            _, _, ft, bt, sync = sim._op_plan(op, {op.name: pc})
            c = ft + bt + sync
            if c < best_c:
                best_pc, best_c = pc, c
        if best_pc is None:
            best_pc = ParallelConfig.data_parallel(
                1, op.outputs[0].num_dims)
        strat[op.name] = best_pc
    return strat


def aligned_for_mesh(layers: List[Op],
                     mesh_shape: MeshShape) -> Dict[str, ParallelConfig]:
    """Fully-aligned init for one mesh factorization: every op takes the
    LARGEST legal degree on every axis (dim i splits by the full axis size
    when divisible and allowed).  Producer/consumer partitions coincide, so
    no transfer edges appear — the Megatron-style uniform hybrid (and the
    shape of the reference's published Inception strategies).  Greedy's
    per-op minima can misalign neighbors; this seed covers the aligned
    corner greedy misses."""
    strat = {}
    for op in layers:
        dims = tuple(max(degs) for degs in _per_dim_degrees(op, mesh_shape))
        strat[op.name] = ParallelConfig(
            dims=dims, device_ids=tuple(range(_prod(dims))))
    return strat


_UNSET = object()  # distinguishes "kwarg not passed" from "passed default"


def search(layers: List[Op], num_devices: int, budget: int = 1000,
           alpha: float = 0.05, seed: int = 0,
           spec=_UNSET, measure=_UNSET,
           overlap_backward_update: bool = False,
           verbose: bool = False, flash_attention=_UNSET,
           devices_per_slice=_UNSET, remat=_UNSET,
           compute_dtype=_UNSET, conv_layout=_UNSET,
           opt_slot_bytes=_UNSET, sparse_tables=_UNSET,
           estimator=_UNSET, device=_UNSET,
           sim: Optional[Simulator] = None, chains: int = 1,
           fixed_mesh: Optional[MeshShape] = None,
           precision_axis: bool = False, mode: str = "mcmc",
           warm_start: str = "",
           stats: Optional[Dict] = None
           ) -> Tuple[Dict[str, ParallelConfig], MeshShape, float]:
    """Run the annealing loop; returns (best strategies, best mesh
    factorization, best simulated time).  ``devices_per_slice`` < the
    device count makes the objective slice-aware: weight-sync replica
    groups that cross a slice pay the DCN term (reference
    simulator.cu:27-29 inter-node fabric).  ``sim`` lets the caller
    share a Simulator (and, in measure mode, its device measurement
    cache) with its own baseline evaluations.

    ``chains`` > 1 runs that many INDEPENDENT anneals (each with its own
    rng stream and delta-simulation :class:`SimSession`, all sharing the
    plan/measure caches and the multi-start seeds) and reduces to the
    best strategy by (time, chain index) — deterministic under a fixed
    seed, and chain 0 reproduces the single-chain walk exactly.  Analytic
    chains run in threads (the native engine releases the GIL); measure
    mode runs them sequentially to keep one device-timing pipeline.

    ``fixed_mesh`` pins the global mesh factorization: the walk only
    mutates per-op strategies on that mesh (no refactorization proposals,
    seeds drawn from it alone).  The reshard path uses this when the
    caller chose the mesh explicitly, so the returned strategies are
    always expressible on the mesh that will actually be installed.

    ``precision_axis`` grows the SOAP space with the per-op precision
    axis: ~1/4 of non-refactorization proposals flip one
    op's ``ParallelConfig.precision`` among the tokens
    ``analysis.legality.allowed_precisions`` permits (loss and
    norm-statistics ops stay pinned fp32 — the same predicate the FF140
    verifier pass enforces, so the walk never proposes a strategy lint
    rejects), and partitioning mutations carry the op's current
    precision along.  OFF by default: the rng draw sequence — and
    therefore every acceptance decision — is bit-identical to a build
    without the axis.

    ``mode`` selects the search driver: ``"mcmc"`` — the default — is
    this annealing loop;
    ``"hybrid"`` solves decomposable regions EXACTLY first
    (search/decompose.py Viterbi DP over ``legal_configs``, scored with
    this same simulator) and anneals only the residual cross-region
    variables with a cost-model-guided proposal distribution
    (search/hybrid.py).  ``warm_start`` names an on-disk
    :class:`~flexflow_tpu_torch.search.hybrid.BestStrategyStore` the hybrid
    driver seeds from and updates.  ``stats``, when a dict, is filled
    with search telemetry in either mode: ``proposals``, ``accepted``,
    ``evaluations``, ``best_trace`` ([(proposal #, best simulated
    time)]), ``time_to_best_ms`` — counters only, never an rng draw,
    so passing it cannot change the result.  ``device`` is the device
    the run's ops execute on (the Simulator's)."""
    # one (name, value) table serves both branches: the contradiction
    # check against a shared sim AND the pass-through construction —
    # a new Simulator-mirrored kwarg is added in exactly one place
    _kwargs = (("measure", measure), ("spec", spec), ("remat", remat),
               ("flash_attention", flash_attention),
               ("devices_per_slice", devices_per_slice),
               ("compute_dtype", compute_dtype),
               ("conv_layout", conv_layout),
               ("opt_slot_bytes", opt_slot_bytes),
               ("sparse_tables", sparse_tables),
               ("estimator", estimator), ("device", device))
    if sim is not None:
        # the shared sim's config IS the objective; contradicting kwargs
        # would silently split seed-ranking from the acceptance test
        assert num_devices == sim.num_devices, \
            (f"num_devices={num_devices} contradicts shared "
             f"sim.num_devices={sim.num_devices}")
        # measure=True cannot be honored by an analytic sim — the caller
        # would record analytic times as chip-measured; hard error, not
        # a warning a batch log swallows
        assert not (measure is True and not sim.measure), \
            f"measure=True contradicts shared sim.measure={sim.measure}"
        # warn on every other EXPLICIT contradicting kwarg (sentinel
        # defaults distinguish "not passed" from "passed the default"),
        # comparing AFTER the same normalization
        # Simulator.__init__ applies — raw-kwarg comparison would warn
        # on agreeing calls
        _norm = {"spec": lambda v: spec_for_device() if v is None else v,
                 "devices_per_slice": lambda v: v or num_devices,
                 "sparse_tables": lambda v: frozenset(v or ()),
                 "device": lambda v: torch.device(v)}
        for _name, _given in _kwargs:
            if _given is _UNSET:
                continue
            _n = _norm.get(_name, lambda v: v)
            _given = _n(_given)
            _sims = _n(getattr(sim, _name))
            if _given != _sims:
                warnings.warn(
                    f"search(sim=...) ignores {_name}={_given!r}; the "
                    f"shared sim's {_name}={_sims!r} defines the objective",
                    stacklevel=2)
    else:
        # pass only explicit kwargs; Simulator supplies its own defaults
        # (no duplicated default table to drift)
        sim = Simulator(num_devices=num_devices,
                        **{k: v for k, v in _kwargs if v is not _UNSET})
    # the sim (shared or freshly built) is the single source of truth;
    # rank_sim below rebuilds from these locals
    if sim.conv_layout == "auto":
        # resolve for the run's device so measure mode times the layout
        # fit() will run
        from ..op import resolve_conv_layout
        sim.conv_layout = resolve_conv_layout("auto", sim.device)
    measure = sim.measure
    spec, remat = sim.spec, sim.remat
    flash_attention = sim.flash_attention
    devices_per_slice = sim.devices_per_slice
    compute_dtype, conv_layout = sim.compute_dtype, sim.conv_layout
    opt_slot_bytes = sim.opt_slot_bytes
    device = sim.device
    if mode not in ("mcmc", "hybrid"):
        raise ValueError(f"unknown search mode {mode!r} "
                         "(want 'mcmc' or 'hybrid')")
    if mode == "hybrid":
        # the hybrid driver receives the fully-resolved simulator, so
        # the DP, the guided anneal and this MCMC path share ONE
        # objective (estimator, spec, sparse tables, dtype — all of it)
        from .hybrid import run_hybrid
        return run_hybrid(
            layers, num_devices, budget, alpha, seed, sim,
            overlap_backward_update=overlap_backward_update,
            chains=chains, fixed_mesh=fixed_mesh,
            precision_axis=precision_axis, verbose=verbose,
            warm_start=warm_start, stats=stats)
    import time as _time
    wall0 = _time.perf_counter()
    if fixed_mesh is not None:
        pinned = {a: int(fixed_mesh.get(a, 1)) for a in AXES}
        if _prod(pinned.values()) != num_devices:
            raise ValueError(
                f"fixed_mesh {fixed_mesh} has "
                f"{_prod(pinned.values())} devices, expected {num_devices}")
        meshes = [pinned]
    else:
        meshes = candidate_meshes(num_devices)

    def dp_mesh() -> MeshShape:
        return {a: (num_devices if a == "n" else 1) for a in AXES}

    # start from data parallelism on an all-data mesh (model.cc:1020-1027)
    # — or, under a pinned factorization, data parallelism over the
    # pinned mesh's n axis (an all-data mesh would escape the pin)
    mesh_shape = dict(meshes[0]) if fixed_mesh is not None else dp_mesh()
    cand_cache: Dict[Tuple[str, Tuple[int, ...]], List[ParallelConfig]] = {}

    def cands(op: Op, ms: MeshShape) -> List[ParallelConfig]:
        key = (op.name, tuple(ms[a] for a in AXES))
        if key not in cand_cache:
            cand_cache[key] = legal_configs(op, ms, seed=seed)
        return cand_cache[key]

    current: Dict[str, ParallelConfig] = {}
    for op in layers:
        nd = op.outputs[0].num_dims
        # largest expressible divisor of the n axis that divides the batch
        deg = max((d for d in expressible_degrees(mesh_shape["n"])
                   if op.outputs[0].shape[0] % d == 0), default=1)
        current[op.name] = ParallelConfig.data_parallel(deg, nd)
    cur_time = sim.simulate(layers, current, overlap_backward_update,
                            mesh_shape=mesh_shape)
    # Seed strategies are ranked with the ANALYTIC simulator even when the
    # anneal measures: greedy scans every candidate of every mesh, and
    # microbenchmarking that whole space on-device before iteration 0
    # would dwarf the search itself (the anneal's acceptance test still
    # measures, so the objective is unchanged — seeds are only starts).
    rank_sim = sim if not measure else Simulator(
        spec=spec, num_devices=num_devices,
        devices_per_slice=devices_per_slice, remat=remat,
        flash_attention=flash_attention, compute_dtype=compute_dtype,
        conv_layout=conv_layout, opt_slot_bytes=opt_slot_bytes,
        sparse_tables=sim.sparse_tables, estimator=sim.estimator,
        device=device)
    seed_cache: Dict[Tuple[int, ...], List] = {}

    def mesh_seeds(ms: MeshShape) -> List:
        """[(strategy, rank_time), ...] for one mesh — greedy + aligned,
        deterministic per mesh, so computed once and reused by every
        refactorization proposal."""
        key = tuple(ms[a] for a in AXES)
        if key not in seed_cache:
            seed_cache[key] = [
                (s, rank_sim.simulate(layers, s, overlap_backward_update,
                                      mesh_shape=ms))
                for s in (greedy_for_mesh(layers, ms, rank_sim, cands),
                          aligned_for_mesh(layers, ms))]
        return seed_cache[key]

    # multi-start: rank greedy + aligned inits on EVERY mesh factorization
    # and begin the anneal from the best (the reference's per-op configs
    # carry no global mesh constraint, model.cc:276-305, so its walk
    # reaches hybrids directly; our mesh-factorized space needs the
    # cross-mesh jump seeded)
    for ms in meshes:
        for cand_strat, t in mesh_seeds(ms):
            if t < cur_time:
                current, cur_time, mesh_shape = cand_strat, t, ms
    if measure:  # re-score the chosen start with the measuring objective
        cur_time = sim.simulate(layers, current, overlap_backward_update,
                                mesh_shape=mesh_shape)
    best, best_mesh, best_time = dict(current), dict(mesh_shape), cur_time

    # when no proposal can possibly change anything —
    # a single candidate mesh (no refactorization moves), no precision
    # axis, and every op's legal_configs a singleton — the anneal would
    # burn the full budget on no-op draws (every single-op proposal
    # hits the ``dims == cur`` skip).  Return the multi-start optimum
    # directly — the exact same result, zero evaluations — and log the
    # savings.
    if (budget > 0 and len(meshes) == 1 and not precision_axis
            and all(len(cands(op, meshes[0])) <= 1 for op in layers)):
        from ..fflogger import get_logger
        get_logger("search").info(
            "search: every op has a single legal config on the only "
            "mesh factorization — annealing skipped, "
            f"{budget * max(1, chains)} proposals saved")
        if stats is not None:
            stats.update({
                "mode": "mcmc", "proposals": 0, "accepted": 0,
                "evaluations": 0,
                "proposals_saved": budget * max(1, chains),
                "best_trace": [(0, best_time)],
                "time_to_best_ms": (_time.perf_counter() - wall0) * 1e3})
        return best, best_mesh, best_time

    def run_chain(chain_idx: int):
        """One independent anneal from the shared multi-start seed.
        Chain 0 draws from ``Random(seed)`` so the single-chain walk (and
        its acceptance decisions) is reproduced exactly; every chain
        evaluates proposals through its own delta-simulation SimSession,
        which is bit-identical to ``sim.simulate``."""
        rng = random.Random(seed if chain_idx == 0
                            else seed + 7919 * chain_idx)
        cur, cur_t = dict(current), cur_time
        ms_cur = dict(mesh_shape)
        b, bm, bt = dict(cur), dict(ms_cur), cur_t
        # instrumentation: proposals actually evaluated,
        # Metropolis acceptances, the (proposal#, best-so-far) trace and
        # the wall clock of the last improvement — pure counters, no rng
        # draws, so the walk is bit-identical with or without them
        proposals = accepted = 0
        trace = [(0, bt)]
        t_best = _time.perf_counter() - wall0
        session = sim.session(layers, overlap_backward_update,
                              mesh_shape=ms_cur)
        try:
            session.evaluate(cur, mesh_shape=ms_cur)  # marshal once
            for it in range(budget):
                if len(meshes) > 1 and rng.random() < 0.1:
                    # re-factorize the mesh: re-seed from the (memoized)
                    # greedy or aligned init (snapping existing degrees
                    # produces a crippled low-degree strategy that is
                    # always rejected)
                    new_mesh = rng.choice(meshes)
                    if tuple(new_mesh.values()) == tuple(ms_cur.values()):
                        continue
                    proposal = rng.choice(mesh_seeds(new_mesh))[0]
                    prop_mesh = new_mesh
                elif precision_axis and rng.random() < 0.25:
                    # precision mutation: flip one op's dtype
                    # among its legal tokens, partitioning untouched
                    op = rng.choice(layers)
                    cur_pc = cur[op.name]
                    opts = [p for p in allowed_precisions(op)
                            if p != cur_pc.precision]
                    if not opts:
                        continue
                    proposal = dict(cur)
                    proposal[op.name] = dataclasses.replace(
                        cur_pc, precision=rng.choice(opts))
                    prop_mesh = ms_cur
                else:
                    op = rng.choice(layers)
                    choices = cands(op, ms_cur)
                    if not choices:
                        continue
                    new_cfg = rng.choice(choices)
                    if new_cfg.dims == cur[op.name].dims:
                        continue
                    if precision_axis and cur[op.name].precision:
                        # a partitioning mutation must not silently
                        # reset the op's precision to the default
                        new_cfg = dataclasses.replace(
                            new_cfg, precision=cur[op.name].precision)
                    proposal = dict(cur)
                    proposal[op.name] = new_cfg
                    prop_mesh = ms_cur
                proposals += 1
                new_time = session.evaluate(proposal, mesh_shape=prop_mesh)
                delta = new_time - cur_t
                # inf -> inf moves are accepted unconditionally: when the
                # start point is infeasible (e.g. DP exceeds device memory)
                # the walk must be able to drift across infeasible states
                # (mesh refactorizations) until a feasible one appears
                both_inf = (not math.isfinite(new_time)
                            and not math.isfinite(cur_t))
                if both_inf or delta < 0 or \
                        (math.isfinite(new_time) and
                         rng.random() < math.exp(-alpha * delta * 1e3)):
                    cur, cur_t, ms_cur = proposal, new_time, prop_mesh
                    accepted += 1
                    if cur_t < bt:
                        b, bm, bt = dict(cur), dict(ms_cur), cur_t
                        trace.append((proposals, bt))
                        t_best = _time.perf_counter() - wall0
                        if verbose:
                            print(f"[search] chain {chain_idx} iter {it}: "
                                  f"{bt * 1e3:.3f} ms")
        finally:
            evals = session.evaluations
            session.close()
        return bt, chain_idx, b, bm, proposals, accepted, trace, t_best, evals

    chains = max(1, chains)
    if chains == 1 or measure:
        # measure mode keeps ONE device-timing pipeline; the shared
        # measure cache still de-duplicates across sequential chains
        results = [run_chain(c) for c in range(chains)]
    else:
        import concurrent.futures as _cf
        import os as _os
        with _cf.ThreadPoolExecutor(
                max_workers=min(chains, _os.cpu_count() or 1)) as ex:
            results = list(ex.map(run_chain, range(chains)))
    # deterministic reduce: best simulated time, ties to the lowest chain
    win = min(results, key=lambda r: (r[0], r[1]))
    bt, win_chain, b, bm = win[0], win[1], win[2], win[3]
    if bt < best_time:
        best, best_mesh, best_time = b, bm, bt
    if stats is not None:
        stats.update({
            "mode": "mcmc",
            "proposals": sum(r[4] for r in results),
            "accepted": sum(r[5] for r in results),
            "evaluations": sum(r[8] for r in results),
            "best_trace": list(win[6]),
            "time_to_best_ms": win[7] * 1e3,
            "winning_chain": win_chain,
        })
    return best, best_mesh, best_time


def search_devices(cfg: FFConfig) -> int:
    """The device count a search targets: ``cfg.num_devices`` when the
    config names workers, else the process group's world size."""
    if cfg.workers_per_node:
        return cfg.num_devices
    from ..parallel import distributed
    return distributed.world_size()


def search_simulator(model, cfg: FFConfig, num_devices: int) -> Simulator:
    """The Simulator :func:`optimize_strategies` searches with: the
    config's objective (``simulator_mode``, flash flag, remat, compute
    dtype, the optimizer's slot bytes, the sparse tables, ``num_nodes``
    hosts) for ``num_devices`` devices, on the model's device."""
    from .calibration import estimator_from_config
    estimator_from_config(cfg)   # raises for what is not ported
    from ..op import resolve_conv_layout
    return Simulator(
        num_devices=num_devices,
        # num_nodes hosts: weight sync crossing them pays the dcn_bw term
        devices_per_slice=num_devices // max(1, cfg.num_nodes),
        measure=cfg.simulator_mode == "measure",
        flash_attention=cfg.flash_attention, remat=cfg.remat,
        compute_dtype=cfg.compute_dtype,
        conv_layout=resolve_conv_layout(cfg.conv_layout, model.device),
        opt_slot_bytes=getattr(model.optimizer, "slot_bytes_per_param", 4),
        # tables on the sparse-update path sync row gradients
        sparse_tables={t for _, t, _ in model._sparse_embedding_specs()},
        device=model.device)


def optimize_strategies(model, cfg: FFConfig, num_devices: int = None,
                        budget: int = None, with_mesh: bool = False,
                        mesh_shape: Optional[Dict[str, int]] = None,
                        sim: Optional[Simulator] = None,
                        stats: Optional[Dict] = None):
    """Entry point used by FFModel.compile when ``search_budget > 0``
    (reference model.cc:953-966 launching STRATEGY_SEARCH_TASK).  Pins
    ``cfg.mesh_shape`` to the searched factorization, so compile()
    builds the mesh the strategies were scored against.

    ``num_devices`` overrides :func:`search_devices` (and skips the
    pinning: the caller owns the mesh), ``budget`` overrides
    ``cfg.search_budget`` (reshard points pass
    ``cfg.reshard_search_budget``), ``with_mesh=True`` returns
    ``(strategies, mesh_shape)``, and ``mesh_shape`` pins the
    factorization (``search(fixed_mesh=...)``).  ``sim`` is the
    objective (default :func:`search_simulator`); ``stats`` is filled
    as ``search`` fills it.

    In a process group every rank must reach the same strategies: the
    analytic objective is deterministic, so each rank searches; measure
    mode's timings differ from rank to rank, so rank 0 searches alone
    and broadcasts its result over a gloo group."""
    ndev = (int(num_devices) if num_devices is not None
            else search_devices(cfg))
    if sim is None:
        sim = search_simulator(model, cfg, ndev)
    from ..parallel import distributed
    shared = sim.measure and distributed.world_size() > 1
    if not shared or _rank() == 0:
        best, best_mesh, best_time = search(
            model.layers, ndev,
            budget=cfg.search_budget if budget is None else int(budget),
            alpha=cfg.search_alpha, seed=cfg.seed,
            overlap_backward_update=cfg.search_overlap_backward_update,
            sim=sim, chains=cfg.search_chains, fixed_mesh=mesh_shape,
            precision_axis=cfg.search_precision,
            mode=getattr(cfg, "search_mode", "mcmc"),
            warm_start=getattr(cfg, "best_known_file", ""), stats=stats)
    if shared:
        best, best_mesh, best_time = _broadcast_result(
            (best, best_mesh, best_time) if _rank() == 0 else None)
    print(f"[search] best simulated iteration time: {best_time * 1e3:.3f} ms "
          f"on {ndev} devices, mesh "
          f"{ {a: s for a, s in best_mesh.items() if s > 1} }")
    if cfg.mesh_shape is None and num_devices is None:
        cfg.mesh_shape = {a: s for a, s in best_mesh.items() if s > 1}
    return (best, best_mesh) if with_mesh else best


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _broadcast_result(result):
    """Rank 0's (strategies, mesh, time) to every rank of the process
    group, over a gloo group made for the call (CPU objects, so it runs
    under an NCCL default group too).  Every rank calls it; the others
    wait for rank 0's measurements."""
    import datetime

    import torch.distributed as dist

    group = dist.new_group(backend="gloo",
                           timeout=datetime.timedelta(hours=1))
    try:
        box = [result]
        dist.broadcast_object_list(box, src=0, group=group)
    finally:
        dist.destroy_process_group(group)
    return box[0]
