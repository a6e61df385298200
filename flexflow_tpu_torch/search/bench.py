"""``search-bench`` — the search-throughput microbenchmark (delta against
full), the JAX package's ``search/bench.py``.

Search throughput is what lets a fixed wall-clock budget explore more
strategies ("Learning to Optimize Tensor Programs": autotuning is
bounded by search throughput).  This bench drives the SAME seeded
single-op proposal sequence through

* the one-shot path — ``Simulator.simulate()``, which rebuilds the whole
  task graph per proposal, and
* the delta path — :class:`~flexflow_tpu_torch.search.session.SimSession`,
  which re-simulates only what the proposal changed,

and reports proposals a second for each, plus the best simulated time a
short real MCMC search finds.  Both paths share one plan cache (warmed
before timing), so the ratio isolates the simulation machinery.  The
work is host work: the simulator prices the graph on the device it is
given (``--device``, the card by default) without running it.

Run: ``python -m flexflow_tpu_torch.search.bench [--devices 16]
[--steps 192] [--budget 200] [--seed 0] [--graphs transformer,dlrm]
[--calibration table.json --estimator table|ridge] [--hybrid]
[--device cuda|cpu] [--out search_bench.json]`` — JSON on stdout either
way.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List

from ..config import FFConfig


def _transformer_layers(device="cuda"):
    """Search-scale transformer."""
    from ..models.transformer import build_transformer
    cfg = FFConfig(batch_size=64, compute_dtype="float32")
    model, _, _ = build_transformer(cfg, num_layers=2, d_model=128,
                                    num_heads=4, d_ff=256, seq_len=32,
                                    vocab_size=1000, device=device)
    return model.layers


def _dlrm_layers(device="cuda"):
    from ..models.dlrm import build_dlrm
    cfg = FFConfig(batch_size=64, compute_dtype="float32")
    model, _, _ = build_dlrm(cfg, embedding_size=(1000, 1000, 1000, 1000),
                             sparse_feature_size=16,
                             mlp_bot=(32, 64, 16), mlp_top=(80, 64, 1),
                             device=device)
    return model.layers


def _inception_layers(device="cuda"):
    """InceptionV3 at the calibration zoo's size (75 px): the
    reconvergent-diamond stress test for the hybrid decomposition."""
    from ..models.inception import build_inception_v3
    cfg = FFConfig(batch_size=2, compute_dtype="float32")
    model, _, _ = build_inception_v3(cfg, image_size=75, device=device)
    return model.layers


def _mlp_layers(device="cuda"):
    """A pure dense chain — fully decomposable, so ``mode="hybrid"``
    returns the exact DP solution with zero MCMC proposals."""
    from ..model import FFModel
    cfg = FFConfig(batch_size=4096, compute_dtype="float32")
    cfg.mesh_shape = {"n": 1}
    model = FFModel(cfg, device=device)
    t = model.create_tensor((4096, 256))
    t = model.dense(t, 256, activation="relu")
    t = model.dense(t, 256, activation="relu")
    t = model.dense(t, 16)
    return model.layers


GRAPHS = {"transformer": _transformer_layers, "dlrm": _dlrm_layers,
          "inception": _inception_layers, "mlp": _mlp_layers}

# the three zoo models the hybrid-against-mcmc acceptance scores (mlp is
# the fully decomposable control)
ZOO_MODELS = ("transformer", "dlrm", "inception")


def _convergence_stamps(stats: Dict) -> Dict:
    """Convergence stamps for one search arm, from the ``stats`` dict
    ``mcmc.search``/``hybrid.run_hybrid`` fill: wall clock to the final
    best, the acceptance rate, and the first proposal whose best so far
    is within 1% of the final best."""
    proposals = int(stats.get("proposals", 0))
    accepted = int(stats.get("accepted", 0))
    trace = stats.get("best_trace") or []
    within = None
    if trace:
        final = trace[-1][1]
        if final == final and final != float("inf"):
            for p, t in trace:
                if t <= final * 1.01:
                    within = int(p)
                    break
    return {
        "time_to_best_ms": round(float(stats.get("time_to_best_ms", 0.0)), 3),
        "acceptance_rate": (round(accepted / proposals, 4)
                            if proposals else None),
        "proposals_to_within_1pct": within,
    }


def _proposal_sequence(layers, num_devices: int, steps: int, seed: int
                       ) -> List[Dict]:
    """A seeded random walk of single-op mutations (the MCMC proposal
    shape) under one hybrid mesh factorization — each consecutive pair
    of strategies differs in exactly one op."""
    import random

    from ..parallel.mesh import AXES
    from .mcmc import legal_configs
    rng = random.Random(seed)
    # a hybrid n*c mesh so proposals include tensor-parallel splits
    half = 1
    while half * half <= num_devices:
        half *= 2
    half //= 2
    mesh = {a: 1 for a in AXES}
    mesh["n"] = max(1, num_devices // half)
    mesh["c"] = half
    cands = {op.name: legal_configs(op, mesh, seed=seed) for op in layers}
    current = {op.name: cands[op.name][0] for op in layers}
    seq = [dict(current)]
    for _ in range(steps - 1):
        op = rng.choice(layers)
        current[op.name] = rng.choice(cands[op.name])
        seq.append(dict(current))
    return seq


def bench_graph(name: str, num_devices: int = 16, steps: int = 192,
                budget: int = 200, seed: int = 0,
                min_time_s: float = 0.4, estimator=None,
                hybrid: bool = False, spec=None, device="cuda") -> Dict:
    """Delta-against-full proposals a second and the best simulated time
    for one graph.  ``estimator`` (a ``search.calibration.CostEstimator``)
    makes both paths — and the short real search — run on the
    calibrated objective; the row records which estimator and
    calibration produced it.  ``hybrid=True`` adds a ``mode="hybrid"``
    arm at HALF the proposal budget.  ``spec`` (default: the card's) and
    ``device`` (where the graph's ops would run: the flash rule) define
    the objective."""
    from ..config import dtype_short
    from ..profiling import time_calls
    from .calibration import device_kind
    from .mcmc import search
    from .simulator import Simulator

    layers = GRAPHS[name](device)
    sim = Simulator(spec=spec, num_devices=num_devices, estimator=estimator,
                    device=device)
    seq = _proposal_sequence(layers, num_devices, steps, seed)

    # warm the shared plan cache (and the one-shot path) so both timed
    # loops measure simulation, not first-touch plan construction
    for strat in seq:
        sim.simulate(layers, strat)

    def run_full():
        for strat in seq:
            sim.simulate(layers, strat)

    session = sim.session(layers)

    def run_delta():
        for strat in seq:
            session.evaluate(strat)

    run_delta()  # one warm pass: marshal + first full build
    full_cps, _ = time_calls(run_full, min_time_s=min_time_s)
    delta_cps, _ = time_calls(run_delta, min_time_s=min_time_s)
    stats = session.stats()
    session.close()

    search_stats: Dict = {}
    best, best_mesh, best_t = search(layers, num_devices, budget=budget,
                                     seed=seed, sim=sim, stats=search_stats)
    desc = (estimator.describe() if estimator is not None
            else {"estimator": "analytic", "calibration_digest": None})
    row = {
        "graph": name,
        "num_ops": len(layers),
        "num_devices": num_devices,
        "device_kind": device_kind(device),
        # rows simulated under different compute dtypes are different
        # populations, like device_kind
        "precision_policy": dtype_short(sim.compute_dtype),
        **desc,
        "proposal_steps": steps,
        "proposals_per_sec_full": round(full_cps * steps, 2),
        "proposals_per_sec_delta": round(delta_cps * steps, 2),
        "speedup": round(delta_cps / full_cps, 2),
        "backend": sim.backend,
        "engine_stats": stats,
        "search_budget": budget,
        "best_simulated_ms": (None if not math.isfinite(best_t)
                              else round(best_t * 1e3, 6)),
        "best_mesh": {a: s for a, s in best_mesh.items() if s > 1},
        **_convergence_stamps(search_stats),
    }
    if hybrid:
        hstats: Dict = {}
        hybrid_budget = max(1, budget // 2)
        hbest, hmesh, ht = search(layers, num_devices,
                                  budget=hybrid_budget, seed=seed,
                                  sim=sim, mode="hybrid", stats=hstats)
        hybrid_ms = (None if ht != ht or ht == float("inf")
                     else round(ht * 1e3, 6))
        row["hybrid"] = {
            "search_budget": hybrid_budget,
            "best_simulated_ms": hybrid_ms,
            "best_mesh": {a: s for a, s in hmesh.items() if s > 1},
            "regions": hstats.get("regions", 0),
            "exact_ops": hstats.get("exact_ops", 0),
            "residual_ops": hstats.get("residual_ops", 0),
            "fully_decomposable": bool(hstats.get("fully_decomposable")),
            "proposals": int(hstats.get("proposals", 0)),
            "proposals_saved": int(hstats.get("proposals_saved", 0)),
            "beats_mcmc": (hybrid_ms is not None
                           and row["best_simulated_ms"] is not None
                           and hybrid_ms <= row["best_simulated_ms"]),
            **_convergence_stamps(hstats),
        }
    return row


def hybrid_acceptance(results: List[Dict]) -> Dict:
    """The hybrid search's acceptance booleans, from hybrid-arm rows:
    the hybrid's final cost is <= the MCMC-only arm's (which ran at
    TWICE the proposal budget) on >= 2 of the 3 zoo models, and every
    fully decomposable graph spent zero proposals."""
    zoo = [r for r in results if r["graph"] in ZOO_MODELS and "hybrid" in r]
    wins = [r["graph"] for r in zoo if r["hybrid"]["beats_mcmc"]]
    decomp = [r for r in results
              if "hybrid" in r and r["hybrid"]["fully_decomposable"]]
    return {
        "zoo_models_compared": [r["graph"] for r in zoo],
        "hybrid_le_mcmc_models": wins,
        "hybrid_le_mcmc_at_half_budget": len(wins) >= min(2, len(zoo)),
        "fully_decomposable_graphs": [r["graph"] for r in decomp],
        "fully_decomposable_zero_proposals": (
            bool(decomp)
            and all(r["hybrid"]["proposals"] == 0 for r in decomp)),
    }


_ROW_KEYS = ("graph", "num_devices", "device_kind", "precision_policy",
             "estimator", "search_budget", "best_simulated_ms",
             "time_to_best_ms", "acceptance_rate",
             "proposals_to_within_1pct")
_HYBRID_KEYS = ("search_budget", "best_simulated_ms", "regions",
                "exact_ops", "residual_ops", "fully_decomposable",
                "proposals", "beats_mcmc", "time_to_best_ms",
                "acceptance_rate", "proposals_to_within_1pct")


def validate_hybrid_bench(data) -> List[str]:
    """Schema check for a ``--hybrid`` payload (kind
    ``search_hybrid_bench``).  Returns a list of problems; empty means
    valid."""
    errs: List[str] = []
    if not isinstance(data, dict):
        return ["payload is not an object"]
    if data.get("kind") != "search_hybrid_bench":
        errs.append(f"kind {data.get('kind')!r} != 'search_hybrid_bench'")
    rows = data.get("results")
    if not isinstance(rows, list) or not rows:
        return errs + ["results missing or empty"]
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            errs.append(f"results[{i}] is not an object")
            continue
        for k in _ROW_KEYS:
            if k not in row:
                errs.append(f"results[{i}] missing {k!r}")
        if "calibration_digest" not in row:
            errs.append(f"results[{i}] missing 'calibration_digest'")
        hyb = row.get("hybrid")
        if not isinstance(hyb, dict):
            errs.append(f"results[{i}] missing hybrid arm")
            continue
        for k in _HYBRID_KEYS:
            if k not in hyb:
                errs.append(f"results[{i}].hybrid missing {k!r}")
        if not isinstance(hyb.get("proposals"), int) or \
                hyb.get("proposals", 0) < 0:
            errs.append(f"results[{i}].hybrid.proposals not a "
                        "non-negative int")
        if isinstance(row.get("search_budget"), int) and \
                isinstance(hyb.get("search_budget"), int) and \
                hyb["search_budget"] * 2 > row["search_budget"]:
            errs.append(f"results[{i}]: hybrid budget "
                        f"{hyb['search_budget']} exceeds half the mcmc "
                        f"budget {row['search_budget']}")
    acc = data.get("acceptance")
    if not isinstance(acc, dict):
        errs.append("acceptance block missing")
    else:
        for k in ("hybrid_le_mcmc_at_half_budget",
                  "fully_decomposable_zero_proposals"):
            if not isinstance(acc.get(k), bool):
                errs.append(f"acceptance.{k} missing or not a bool")
    return errs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m flexflow_tpu_torch.search.bench",
        description="search-throughput microbenchmark: delta (SimSession) "
                    "vs full (one-shot simulate) proposals/sec")
    ap.add_argument("--devices", type=int, default=16)
    ap.add_argument("--steps", type=int, default=192,
                    help="proposals per timed pass")
    ap.add_argument("--budget", type=int, default=200,
                    help="MCMC iterations for the best-time search")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--graphs", default="transformer,dlrm",
                    help="comma-separated subset of: "
                         + ",".join(GRAPHS))
    ap.add_argument("--min-time", type=float, default=0.4,
                    help="seconds of wall clock per timed loop")
    ap.add_argument("--calibration", default="",
                    help="CalibrationTable JSON — bench the CALIBRATED "
                         "objective")
    ap.add_argument("--estimator", default="",
                    help="cost estimator (table|ridge; default table "
                         "when --calibration is given, else analytic)")
    ap.add_argument("--hybrid", action="store_true",
                    help="add a mode=hybrid arm at HALF --budget per "
                         "graph and emit the acceptance booleans "
                         "(payload kind search_hybrid_bench)")
    ap.add_argument("--device", default="cuda",
                    help="the device the graphs' ops are priced for "
                         "(default cuda)")
    ap.add_argument("--out", default="",
                    help="also write the JSON artifact here")
    args = ap.parse_args(argv)
    names = [g.strip() for g in args.graphs.split(",") if g.strip()]
    for g in names:
        if g not in GRAPHS:
            ap.error(f"unknown graph {g!r}; choose from {sorted(GRAPHS)}")
    if args.estimator not in ("", "analytic", "table", "ridge"):
        ap.error(f"unknown estimator {args.estimator!r}; choose from "
                 "analytic, table, ridge")
    if args.estimator in ("table", "ridge") and not args.calibration:
        ap.error(f"--estimator {args.estimator} needs --calibration "
                 "(a table from calibrate)")
    estimator = None
    if args.calibration or args.estimator not in ("", "analytic"):
        from .calibration import CalibrationTable, make_estimator
        table = (CalibrationTable.load(args.calibration)
                 if args.calibration else None)
        estimator = make_estimator(args.estimator
                                   or ("table" if table else "analytic"),
                                   table)
    results = [bench_graph(g, num_devices=args.devices, steps=args.steps,
                           budget=args.budget, seed=args.seed,
                           min_time_s=args.min_time, estimator=estimator,
                           hybrid=args.hybrid, device=args.device)
               for g in names]
    payload = {"bench": "search-bench", "results": results}
    if args.hybrid:
        payload["kind"] = "search_hybrid_bench"
        payload["acceptance"] = hybrid_acceptance(results)
    text = json.dumps(payload, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
