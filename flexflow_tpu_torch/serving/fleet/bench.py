"""``serve-bench --fleet``: the multi-tenant isolation and hot-swap
benchmark, the port of ``flexflow_tpu/serving/fleet/bench.py``.

Three questions, three legs, one JSON payload:

1. **capacity**: each tenant's solo max-rate throughput (its fair-share
   denominator);
2. **isolation**: tenant A is offered 2x ITS capacity (bounded queue,
   ``shed_oldest`` and deadlines, the overload regime per tenant) while
   tenant B runs at a moderate rate; the JAX package's acceptance asks
   that B's goodput (completions within the SLO) stay >= 90% of its SOLO
   goodput at the same offered rate: overload on A must burn A's queue
   and A's fair share, never B's;
3. **hot swap**: while A serves paced load, a new checkpoint for A is
   built on the background thread and published at a dispatch boundary;
   the criterion is ZERO failed in-flight requests and exact counter
   reconciliation across the swap (``submitted == completed + rejected
   + shed + expired + errors``, counters continuous over the engine
   generations).

Run: ``python -m flexflow_tpu_torch.cli serve-bench --fleet [--requests
N] [--cell-seconds S] [--device cuda|cpu] [--out f.json]``.  The
fairness exercised is the dispatcher's policy; the isolation ratio rests
on host timing, the swap leg's counts on logic.
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Dict, List, Optional

import numpy as np

NFEAT = 16
NCLS = 10


def _dense_builder(hidden: int, seed: int):
    def build(cfg, device):
        import flexflow_tpu_torch as ft
        cfg.seed = seed
        m = ft.FFModel(cfg, device=device)
        x = m.create_tensor((cfg.batch_size, NFEAT), name="x")
        t = m.dense(x, hidden, activation="relu")
        t = m.dense(t, NCLS)
        return m
    return build


def _registry(max_batch: int, hidden_a: int, hidden_b: int,
              queue_rows: int, seed: int, bounded: bool = True):
    """Two dense tenants; A's queue is bounded (shed_oldest) unless
    ``bounded=False``: the capacity legs submit back to back, which a
    bounded queue would shed instead of measuring."""
    from .registry import ModelRegistry
    reg = ModelRegistry()
    a_serve = {"max_wait_ms": 1.0, "stats_every": 0}
    if bounded:
        a_serve.update({"max_queue_rows": queue_rows,
                        "admission": "shed_oldest"})
    reg.register(
        "a", _dense_builder(hidden_a, seed), batch_size=max_batch,
        weight=1.0, serve=a_serve)
    reg.register(
        "b", _dense_builder(hidden_b, seed + 1), batch_size=max_batch,
        weight=1.0,
        serve={"max_wait_ms": 1.0, "stats_every": 0})
    return reg


def _requests(n: int, rows_lo: int, rows_hi: int, seed: int
              ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    sizes = rng.integers(rows_lo, rows_hi + 1, n)
    return [rng.standard_normal((int(s), NFEAT)).astype(np.float32)
            for s in sizes]


def _arrivals(n: int, rate: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    return np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), n))


def _measure_capacity(fleet, name: str, pool) -> float:
    """Requests/s with every request submitted back to back: the
    tenant's solo ceiling under the fleet dispatcher.  One warm lap, then
    the best of 2 measured legs: host hiccups only ever DEFLATE a
    wall-clock sample, and the isolation leg's offered rates derive from
    these numbers."""
    def lap():
        t0 = time.perf_counter()
        futs = [fleet.submit(name, r) for r in pool]
        for f in futs:
            f.result(timeout=120)
        return len(pool) / (time.perf_counter() - t0)

    lap()  # warm
    return max(lap(), lap())


class _Pacer(threading.Thread):
    """Open-loop Poisson replay of one tenant's trace: submits at the
    scheduled arrival times, records each request's completion and
    latency through done-callbacks, counts admission refusals."""

    def __init__(self, fleet, name: str, reqs, rate: float,
                 deadline_ms: Optional[float]):
        super().__init__(name=f"pacer-{name}", daemon=True)
        self.fleet, self.tenant = fleet, name
        self.reqs, self.rate = reqs, rate
        self.deadline_ms = deadline_ms
        self.entries: List[Dict] = []
        self.rejected = 0
        self.submitted = 0

    def run(self):
        from ..errors import OverloadError
        arrivals = _arrivals(len(self.reqs), self.rate,
                             hash(self.tenant) % 1000)
        t0 = time.perf_counter()
        for r, at in zip(self.reqs, arrivals):
            lag = t0 + at - time.perf_counter()
            # always yield: an overload pacer that never sleeps would
            # hold the interpreter lock and starve the DISPATCHER,
            # measuring the harness, not the fleet's isolation
            time.sleep(max(lag, 0.0))
            ts = time.perf_counter()
            self.submitted += 1
            try:
                fut = self.fleet.submit(self.tenant, r,
                                        deadline_ms=self.deadline_ms)
            except OverloadError:
                self.rejected += 1
                continue
            entry = {"rows": int(r.shape[0]), "t": ts, "t_done": None,
                     "ok": False}

            def cb(f, e=entry):
                e["t_done"] = time.perf_counter()
                e["ok"] = not f.cancelled() and f.exception() is None

            fut.add_done_callback(cb)
            self.entries.append(entry)

    def result_row(self, slo_ms: float) -> Dict:
        from ...profiling import quantiles

        done = [e for e in self.entries
                if e["ok"] and e["t_done"] is not None]
        lats = [(e["t_done"] - e["t"]) * 1e3 for e in done]
        good = [e for e, l in zip(done, lats) if l <= slo_ms]
        # goodput normalizes by at least the INTENDED trace duration: a
        # pacer that briefly fell behind schedule would otherwise
        # compress its span and report goodput above the offered rate
        span = max(1e-6, len(self.reqs) / max(self.rate, 1e-9),
                   (max((e["t_done"] for e in done), default=0)
                    - min((e["t"] for e in self.entries), default=0)))
        q = quantiles(lats)

        def ms(v):
            return None if v != v else round(v, 3)

        return {
            "offered_rps": round(self.rate, 2),
            "offered_requests": self.submitted,
            "completed": len(done),
            "good_requests": len(good),
            "good_rows": int(sum(e["rows"] for e in good)),
            "goodput_rps": round(len(good) / span, 2),
            "rejected_at_submit": self.rejected,
            "p50_ms": ms(q[0.5]), "p95_ms": ms(q[0.95]),
            "p99_ms": ms(q[0.99]),
        }


def _reconciled(stats: Dict, submitted: int) -> bool:
    """Every submitted request accounted for exactly once: across hot
    swaps the fleet's merged counters must keep this identity."""
    return (stats["requests"] + stats["rejected"] + stats["shed"]
            + stats["expired"] + stats["errors"]) == submitted


def run_fleet_bench(requests: int = 384, rows_lo: int = 1,
                    rows_hi: int = 8, max_batch: int = 32,
                    hidden_a: int = 256, hidden_b: int = 256,
                    queue_rows: int = 0, cell_seconds: float = 2.0,
                    slo_ms: float = 0.0, b_frac: float = 0.15,
                    seed: int = 0, device=None) -> Dict:
    """The three legs on ``device`` (None: the process default, else the
    card); returns the JSON payload."""
    from ...search.calibration import device_kind
    from ...train_bench import _device
    from .engine import FleetEngine

    device = _device(device)
    queue_rows = queue_rows or 4 * max_batch
    pool = _requests(requests, rows_lo, rows_hi, seed)

    # ---- leg 0: per-tenant solo capacity --------------------------------
    caps: Dict[str, float] = {}
    for name in ("a", "b"):
        reg1 = _registry(max_batch, hidden_a, hidden_b, queue_rows,
                         seed, bounded=False)
        with FleetEngine(_one_of(reg1, name), device=device) as fleet:
            caps[name] = _measure_capacity(fleet, name, pool)
    if slo_ms <= 0:
        # generous at the offered rates below, hopeless for an unbounded
        # backlog: the overload sweep's auto-SLO rule
        slo_ms = max(50.0, 4e3 / max(caps["b"], 1.0) * 8)
    rate_b = max(1.0, caps["b"] * b_frac)
    rate_a_over = max(1.0, caps["a"] * 2.0)

    def n_for(rate):
        return max(16, min(4096, int(rate * cell_seconds)))

    def reqs_for(rate):
        n = n_for(rate)
        return [pool[i % len(pool)] for i in range(n)]

    # ---- leg 1: B solo at its moderate rate -----------------------------
    reg_solo = _registry(max_batch, hidden_a, hidden_b, queue_rows, seed)
    with FleetEngine(_one_of(reg_solo, "b"), device=device) as fleet:
        pb = _Pacer(fleet, "b", reqs_for(rate_b), rate_b, None)
        pb.start()
        pb.join()
        fleet.drain(timeout=max(1.0, 4 * slo_ms / 1e3))
        solo_b = pb.result_row(slo_ms)
        solo_stats = fleet.stats("b")
    solo_b["reconciled"] = _reconciled(solo_stats, pb.submitted)

    # ---- leg 2: isolation, A at 2x its capacity, B unchanged ------------
    reg2 = _registry(max_batch, hidden_a, hidden_b, queue_rows, seed)
    with FleetEngine(reg2, device=device) as fleet:
        pa = _Pacer(fleet, "a", reqs_for(rate_a_over), rate_a_over,
                    deadline_ms=slo_ms)
        pb = _Pacer(fleet, "b", reqs_for(rate_b), rate_b, None)
        pa.start()
        pb.start()
        pa.join()
        pb.join()
        fleet.drain(timeout=max(1.0, 4 * slo_ms / 1e3))
        contended_a = pa.result_row(slo_ms)
        contended_b = pb.result_row(slo_ms)
        stats_a = fleet.stats("a")
        stats_b = fleet.stats("b")
    contended_a["reconciled"] = _reconciled(stats_a, pa.submitted)
    contended_b["reconciled"] = _reconciled(stats_b, pb.submitted)
    contended_a["peak_queue_rows"] = stats_a["peak_queue_rows"]
    contended_a["shed"] = stats_a["shed"]
    contended_a["expired"] = stats_a["expired"]

    # ---- leg 3: hot checkpoint swap under load --------------------------
    # UNBOUNDED admission here: the question is whether the SWAP fails
    # anything, so load management must not fail requests for its own
    # reasons while the new checkpoint builds
    reg3 = _registry(max_batch, hidden_a, hidden_b, queue_rows, seed,
                     bounded=False)
    with FleetEngine(reg3, device=device) as fleet:
        rate_a = max(1.0, caps["a"] * 0.5)
        pa = _Pacer(fleet, "a", reqs_for(rate_a), rate_a, None)
        pa.start()
        time.sleep(cell_seconds * 0.25)
        # the "new checkpoint": same graph, fresh init (another seed),
        # built on the background thread, published at a dispatch
        # boundary, the pending queue transferred
        reg3.register(
            "a", _dense_builder(hidden_a, seed + 99),
            batch_size=max_batch,
            serve={"max_wait_ms": 1.0, "stats_every": 0})
        t_swap0 = time.perf_counter()
        fleet.load("a", wait=True)
        swap_s = time.perf_counter() - t_swap0
        pa.join()
        fleet.drain(timeout=max(2.0, 8 * slo_ms / 1e3))
        stats = fleet.stats("a")
    failed = sum(1 for e in pa.entries
                 if e["t_done"] is not None and not e["ok"])
    swap_row = {
        "offered_rps": round(rate_a, 2),
        "swap_publish_s": round(swap_s, 4),
        "engine_generations": stats["engine_generation"] + 1,
        "in_flight_failed": failed,
        "completed": sum(1 for e in pa.entries if e["ok"]),
        "rejected_at_submit": pa.rejected,
        "reconciled": _reconciled(stats, pa.submitted),
        "counters": {k: stats[k] for k in
                     ("requests", "rejected", "shed", "expired",
                      "errors")},
    }

    ratio = (contended_b["goodput_rps"]
             / max(1e-6, solo_b["goodput_rps"]))
    return {
        "bench": "fleet-bench",
        "backend": device.type,
        "device_kind": device_kind(device),
        "config": {
            "requests_pool": requests, "rows": f"{rows_lo}-{rows_hi}",
            "max_batch": max_batch, "hidden_a": hidden_a,
            "hidden_b": hidden_b, "queue_rows": queue_rows,
            "cell_seconds": cell_seconds, "slo_ms": round(slo_ms, 3),
            "b_frac": b_frac, "seed": seed,
        },
        "capacity_rps": {k: round(v, 2) for k, v in caps.items()},
        "solo_b": solo_b,
        "contended_a_2x": contended_a,
        "contended_b": contended_b,
        "swap": swap_row,
        "summary": {
            "b_goodput_solo_rps": solo_b["goodput_rps"],
            "b_goodput_contended_rps": contended_b["goodput_rps"],
            "b_goodput_ratio": round(ratio, 4),
            "isolation_holds": ratio >= 0.9,
            "a_queue_bounded": contended_a["peak_queue_rows"]
            <= queue_rows,
            "swap_zero_failed": swap_row["in_flight_failed"] == 0,
            "swap_reconciled": swap_row["reconciled"],
        },
    }


def _one_of(reg, name):
    """A registry view holding only ``name`` (the solo legs)."""
    from .registry import ModelRegistry
    out = ModelRegistry()
    out.hbm_gb = reg.hbm_gb
    out._specs[name] = reg.spec(name)
    return out


def validate_fleet_bench_json(obj) -> List[str]:
    """Schema problems of a fleet-bench payload, as strings (empty when
    it is well formed)."""
    probs: List[str] = []
    if not isinstance(obj, dict):
        return ["artifact must be a JSON object"]
    if obj.get("bench") != "fleet-bench":
        probs.append(f"bench: want 'fleet-bench', got {obj.get('bench')!r}")
    for key in ("config", "capacity_rps", "solo_b", "contended_a_2x",
                "contended_b", "swap", "summary"):
        if not isinstance(obj.get(key), dict):
            probs.append(f"{key}: want an object")
    summary = obj.get("summary") or {}
    for key in ("b_goodput_ratio", "b_goodput_solo_rps",
                "b_goodput_contended_rps"):
        if not isinstance(summary.get(key), (int, float)):
            probs.append(f"summary.{key}: want a number")
    for key in ("isolation_holds", "swap_zero_failed",
                "swap_reconciled"):
        if not isinstance(summary.get(key), bool):
            probs.append(f"summary.{key}: want a bool")
    swap = obj.get("swap") or {}
    if not isinstance(swap.get("in_flight_failed"), int):
        probs.append("swap.in_flight_failed: want an int")
    return probs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="flexflow-tpu-torch serve-bench --fleet",
        description="multi-tenant isolation and hot-swap benchmark")
    ap.add_argument("--requests", type=int, default=384)
    ap.add_argument("--rows", default="1-8")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--hidden-a", type=int, default=256)
    ap.add_argument("--hidden-b", type=int, default=256)
    ap.add_argument("--queue-rows", type=int, default=0,
                    help="tenant A's bounded queue (0 = 4x max-batch)")
    ap.add_argument("--cell-seconds", type=float, default=2.0)
    ap.add_argument("--slo-ms", type=float, default=0.0)
    ap.add_argument("--b-frac", type=float, default=0.15,
                    help="tenant B's offered rate as a fraction of its "
                         "solo (backlogged) capacity; keep it under B's "
                         "FAIR-SHARE paced capacity: the isolation "
                         "question is whether A's overload drags B, "
                         "not whether B can exceed its own share")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the device to run on (default: the runner's, "
                         "else the card)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    try:
        lo, hi = (int(v) for v in args.rows.split("-"))
    except ValueError:
        ap.error(f"--rows wants LO-HI, got {args.rows!r}")
    from ...fflogger import silenced
    from ..bench import write_payload
    with silenced("ff", "serve"):
        payload = run_fleet_bench(
            requests=args.requests, rows_lo=lo, rows_hi=hi,
            max_batch=args.max_batch, hidden_a=args.hidden_a,
            hidden_b=args.hidden_b, queue_rows=args.queue_rows,
            cell_seconds=args.cell_seconds, slo_ms=args.slo_ms,
            b_frac=args.b_frac, seed=args.seed, device=args.device)
    write_payload(payload, args.out)


if __name__ == "__main__":
    main()
