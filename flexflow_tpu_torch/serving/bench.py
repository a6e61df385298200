"""``serve-bench``: the serving engine's microbenchmark, the port of
``flexflow_tpu/serving/bench.py``: shape buckets and dynamic
micro-batching against naive per-request ``predict()``.

On a configuration where a dispatch's device work is comparable to its
host work (a small dense model) the engine wins twice: it coalesces many
requests into one forward and one fetch, where the naive loop pays a
forward and a host sync a request, and it packs rows into right-sized
buckets, where ``predict()`` pads every request to the model's batch.

Three phases, one JSON payload:

1. **engine**: the request set submitted back to back (max rate):
   rows/s and requests/s capacity, with latency percentiles (backlogged,
   so queueing dominates them: capacity, not an SLO);
2. **naive**: the same requests served one by one through ``predict()``:
   the baseline capacity and per-request service time;
3. **paced**: a Poisson (optionally bursty) arrival trace replayed open
   loop against the engine at a fraction of the measured capacity: the
   p50/p95/p99 a client sees under load.

Run: ``python -m flexflow_tpu_torch.cli serve-bench [--requests 512]
[--rows 1-8] [--max-batch 64] [--max-wait-ms 2] [--buckets 1,2,...]
[--burst 4] [--rate-frac 0.5] [--hidden 64] [--seed 0]
[--device cuda|cpu] [--out f.json]``: JSON on stdout either way, on the
card unless ``--device cpu`` is given.

``--overload`` runs the overload sweep instead: measure capacity, then
replay offered load at ``--mults`` x capacity under each ``--policies``
admission policy, reporting goodput (rows/s completed within the SLO)
and the shed, expired and reject counts of each cell.  ``--trace-out``
records every request's spans and reconciles them against the engine's
counters (the ``trace`` section); ``flexflow-tpu-torch trace export``
reads the file.  ``--generate`` (with ``--prefix`` or ``--speculate``),
``--fleet`` and ``--disagg`` run the token-generation, fleet and
disaggregated-serving benches (``generation/bench.py``,
``fleet/bench.py``, ``cluster/bench.py``), each with flags of its own.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

NFEAT = 16
NCLS = 10


def _build_model(batch_size: int, hidden: int, seed: int,
                 max_batch: int, max_wait_ms: float, buckets: str,
                 device=None):
    """The small model (train-bench's shape class): a request's device
    work is small, so the request loop's host work dominates, the regime
    the engine amortizes."""
    import flexflow_tpu_torch as ft

    cfg = ft.FFConfig(batch_size=batch_size, compute_dtype="float32",
                      seed=seed)
    cfg.serve_max_batch = max_batch
    cfg.serve_max_wait_ms = max_wait_ms
    cfg.serve_buckets = buckets
    m = ft.FFModel(cfg, device=device)
    x = m.create_tensor((batch_size, NFEAT), name="x")
    t = m.dense(x, hidden, activation="relu")
    t = m.dense(t, NCLS)
    m.compile(ft.SGDOptimizer(lr=0.05), metrics=["accuracy"])
    m.init_layers(seed=seed)
    return m


def make_requests(n: int, rows_lo: int, rows_hi: int, seed: int
                  ) -> List[np.ndarray]:
    """Synthetic request payloads with mixed row counts (uniform in
    [rows_lo, rows_hi]): mixed sizes exercise every bucket."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(rows_lo, rows_hi + 1, n)
    return [rng.standard_normal((int(s), NFEAT)).astype(np.float32)
            for s in sizes]


def make_arrivals(n: int, rate: float, seed: int, burst: int = 1
                  ) -> np.ndarray:
    """Arrival offsets (seconds) for the paced phase: Poisson with mean
    ``rate`` requests/s; ``burst > 1`` clumps arrivals into bursts of
    ``burst`` simultaneous requests at Poisson burst times (same mean
    rate)."""
    rng = np.random.default_rng(seed + 1)
    if burst <= 1:
        return np.cumsum(rng.exponential(1.0 / rate, n))
    nb = -(-n // burst)
    burst_t = np.cumsum(rng.exponential(burst / rate, nb))
    return np.repeat(burst_t, burst)[:n]


def _bitwise_parity(buckets, device) -> bool:
    """Whether engine-against-predict checks may demand bit equality:
    on the CPU with the default bucket set the packing does not change
    a row's result; an explicit bucket-1 list opts out (a matrix-vector
    product), and on the card cuBLAS may pick another algorithm for each
    bucket's batch size, so there the check is the loose one (rtol 1e-5,
    atol 1e-6)."""
    return 1 not in buckets and device.type == "cpu"


def _run_engine_maxrate(model, reqs) -> Tuple[Dict, object]:
    """Phase 1: capacity, every request submitted back to back."""
    from .engine import ServingEngine

    engine = ServingEngine(model)
    rows = sum(r.shape[0] for r in reqs)
    with engine:
        t0 = time.perf_counter()
        futs = [engine.submit(r) for r in reqs]
        outs = [f.result(timeout=120) for f in futs]
        dt = time.perf_counter() - t0
    snap = engine.stats()
    # spot check: the engine's rows == the model's own predict on
    # request 0 (a batch of at least 2 rows: a 1-row predict is the
    # matrix-vector product the buckets exclude)
    n0 = reqs[0].shape[0]
    want = model.predict(reqs[0], batch_size=max(2, n0))
    if _bitwise_parity(engine.buckets, model.device):
        np.testing.assert_array_equal(outs[0], want[:n0])
    else:
        np.testing.assert_allclose(outs[0], want[:n0], rtol=1e-5,
                                   atol=1e-6)
    return {
        "makespan_s": round(dt, 4),
        "qps_rows": round(rows / dt, 2),
        "qps_requests": round(len(reqs) / dt, 2),
        "p50_ms": snap["p50_ms"], "p95_ms": snap["p95_ms"],
        "p99_ms": snap["p99_ms"],
        "batch_occupancy": snap["batch_occupancy"],
        "dispatches": snap["dispatches"],
        "buckets": snap["buckets"],
    }, outs


def _run_naive(model, reqs) -> Tuple[Dict, object]:
    """Phase 2: the baseline, one ``predict()`` per request, each a
    forward and a host sync, padded to the model's fixed batch_size."""
    from ..profiling import quantiles

    rows = sum(r.shape[0] for r in reqs)
    lat: List[float] = []
    outs = []
    t0 = time.perf_counter()
    for r in reqs:
        t1 = time.perf_counter()
        outs.append(model.predict(r))
        lat.append(time.perf_counter() - t1)
    dt = time.perf_counter() - t0
    q = quantiles(lat)
    return {
        "makespan_s": round(dt, 4),
        "qps_rows": round(rows / dt, 2),
        "qps_requests": round(len(reqs) / dt, 2),
        "p50_ms": round(q[0.5] * 1e3, 3),
        "p95_ms": round(q[0.95] * 1e3, 3),
        "p99_ms": round(q[0.99] * 1e3, 3),
    }, outs


def _run_paced(model, reqs, rate: float, burst: int, seed: int) -> Dict:
    """Phase 3: open-loop Poisson (+bursty) replay at ``rate`` req/s:
    the latency a client sees when the engine is not saturated."""
    from .engine import ServingEngine

    arrivals = make_arrivals(len(reqs), rate, seed, burst)
    engine = ServingEngine(model)
    with engine:
        t0 = time.perf_counter()
        futs = []
        for r, at in zip(reqs, arrivals):
            lag = t0 + at - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            futs.append(engine.submit(r))
        for f in futs:
            f.result(timeout=120)
    snap = engine.stats()
    return {
        "offered_rate_rps": round(rate, 2),
        "burst": burst,
        "p50_ms": snap["p50_ms"], "p95_ms": snap["p95_ms"],
        "p99_ms": snap["p99_ms"],
        "batch_occupancy": snap["batch_occupancy"],
        "dispatches": snap["dispatches"],
    }


# ----------------------------------------------------------------------
# overload sweep: offered load x admission policy -> goodput
# ----------------------------------------------------------------------
# the four load regimes the sweep compares: the unbounded FIFO baseline
# against the three admission policies with deadlines on
_OVERLOAD_POLICIES = {
    # name: (admission, bounded?, deadlines?)
    "fifo": ("block", False, False),
    "shed_oldest": ("shed_oldest", True, True),
    "reject": ("reject", True, True),
    "block": ("block", True, True),
}


def _run_overload_cell(model, reqs, rate: float, policy: str,
                       max_queue_rows: int, slo_ms: float, burst: int,
                       seed: int, device_kind: str,
                       calibration_digest) -> Dict:
    """One sweep cell: open-loop Poisson (+burst) replay at ``rate``
    req/s against a fresh engine configured for ``policy``, measuring
    goodput (rows completed within the SLO) and every way a request can
    fail (rejected, shed, expired, late), reconciled against the
    submitted count.  The same ``slo_ms`` judges every policy: the
    unbounded FIFO baseline enforces no deadline, but its clients still
    stopped caring after slo_ms."""
    from ..profiling import quantiles
    from .engine import ServingEngine
    from .errors import OverloadError

    admission, bounded, deadlines = _OVERLOAD_POLICIES[policy]
    eng = ServingEngine(
        model, stats_every=0,
        max_queue_rows=max_queue_rows if bounded else 0,
        admission=admission)
    deadline_ms = slo_ms if deadlines else None
    arrivals = make_arrivals(len(reqs), rate, seed, burst)
    done: List[Dict] = []
    t0 = time.perf_counter()
    with eng:
        for r, at in zip(reqs, arrivals):
            lag = t0 + at - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            ts = time.perf_counter()
            try:
                fut = eng.submit(r, deadline_ms=deadline_ms)
            except OverloadError:
                continue  # counted engine-side (snap["rejected"])
            entry = {"rows": int(r.shape[0]), "t": ts, "t_done": None,
                     "ok": False}

            def cb(f, e=entry):
                e["t_done"] = time.perf_counter()
                e["ok"] = f.exception() is None and not f.cancelled()

            fut.add_done_callback(cb)
            done.append(entry)
        # bounded graceful shutdown: flush what is queued, then fail
        # stragglers (the drain verb under test; it also keeps the
        # collapsing baseline's cell from running unboundedly long)
        eng.drain(timeout=max(1.0, 4 * slo_ms / 1e3))
    t_end = time.perf_counter()
    snap = eng.stats()
    completed = [e for e in done if e["ok"] and e["t_done"] is not None]
    lats = [(e["t_done"] - e["t"]) * 1e3 for e in completed]
    good = [e for e, l in zip(completed, lats) if l <= slo_ms]
    good_rows = sum(e["rows"] for e in good)
    elapsed = max(1e-6, t_end - t0)
    q = quantiles(lats)  # nearest-rank, unit-agnostic: these are ms

    def _ms(v):
        return None if v != v else round(v, 3)
    # every submitted request must be accounted for exactly once:
    # completed + rejected-at-submit + shed + expired + dispatch-errors
    reconciled = (snap["requests"] + snap["rejected"] + snap["shed"]
                  + snap["expired"] + snap["errors"]) == len(reqs)
    return {
        "policy": policy,
        "admission": admission,
        "deadline_ms": deadline_ms,
        "slo_ms": slo_ms,
        "max_queue_rows": max_queue_rows if bounded else 0,
        "offered_rps": round(rate, 2),
        "offered_requests": len(reqs),
        "offered_rows": int(sum(r.shape[0] for r in reqs)),
        "elapsed_s": round(elapsed, 4),
        "completed": len(completed),
        "good_requests": len(good),
        "good_rows": int(good_rows),
        "goodput_rows_per_s": round(good_rows / elapsed, 2),
        "rejected": snap["rejected"],
        "shed": snap["shed"],
        "expired": snap["expired"],
        "errors": snap["errors"],
        "late": len(completed) - len(good),
        "reconciled": bool(reconciled),
        "peak_queue_rows": snap["peak_queue_rows"],
        "admission_blocked_ms": snap["admission_blocked_ms"],
        "p50_ms": _ms(q[0.5]), "p95_ms": _ms(q[0.95]),
        "p99_ms": _ms(q[0.99]),
        # every row carries the provenance to compare runs
        "device_kind": device_kind,
        "calibration_digest": calibration_digest,
    }


def run_overload_bench(requests: int = 512, rows_lo: int = 1,
                       rows_hi: int = 8, max_batch: int = 32,
                       max_wait_ms: float = 1.0, buckets: str = "",
                       hidden: int = 256, seed: int = 0, burst: int = 4,
                       cell_seconds: float = 2.0, slo_ms: float = 0.0,
                       queue_rows: int = 0,
                       mults=(0.5, 1.0, 2.0),
                       policies=("fifo", "shed_oldest", "reject", "block"),
                       calibration_digest=None, device=None) -> Dict:
    """The overload sweep: measure engine capacity, then replay offered
    load at ``mults`` x capacity under each admission policy, reporting
    goodput (rows/s completed within the SLO) and the shed, expired and
    reject counts.  The JAX package's acceptance shape: at 2x offered
    load ``shed_oldest`` with deadlines holds the queue within its bound
    and keeps at least 70% of its own 1x goodput, while the unbounded
    FIFO baseline's queue and latency diverge."""
    from ..search.calibration import device_kind as _device_kind

    model = _build_model(max_batch, hidden, seed, max_batch, max_wait_ms,
                         buckets, device=device)
    pool = make_requests(requests, rows_lo, rows_hi, seed)
    model.predict(pool[0])  # warm predict's bucket like serve-bench
    cap_row, _ = _run_engine_maxrate(model, pool)
    capacity_rps = cap_row["qps_requests"]
    mean_dispatch_ms = (cap_row["makespan_s"] / max(1, cap_row["dispatches"])
                        * 1e3)
    if slo_ms <= 0:
        # auto SLO: several dispatches' worth of wall time and the
        # coalescing wait: generous at 1x, hopeless for an unbounded
        # backlog at 2x
        slo_ms = max(25.0, 8 * mean_dispatch_ms + 2 * max_wait_ms)
    if queue_rows <= 0:
        queue_rows = 4 * max_batch
    dk = _device_kind(model.device)
    cells = []
    for ci, (policy, mult) in enumerate(
            (p, m) for p in policies for m in mults):
        rate = max(1.0, capacity_rps * mult)
        n = max(16, min(4096, int(rate * cell_seconds)))
        reqs = [pool[i % len(pool)] for i in range(n)]
        cell = _run_overload_cell(
            model, reqs, rate, policy, queue_rows, slo_ms, burst,
            seed + 13 * ci, dk, calibration_digest)
        cell["offered_mult"] = mult
        cells.append(cell)

    def _cell(policy, mult):
        # exact (policy, mult) match: a rate-ratio heuristic would drop
        # the summary on hosts slow enough that the rate clamp distorts
        # offered/capacity
        for c in cells:
            if c["policy"] == policy and c["offered_mult"] == mult:
                return c
        return None

    summary = {}
    shed1, shed2 = _cell("shed_oldest", 1.0), _cell("shed_oldest", 2.0)
    fifo2 = _cell("fifo", 2.0)
    if shed1 and shed2:
        summary["goodput_1x_shed_rows_per_s"] = shed1["goodput_rows_per_s"]
        summary["goodput_2x_shed_rows_per_s"] = shed2["goodput_rows_per_s"]
        summary["goodput_2x_over_1x_shed"] = round(
            shed2["goodput_rows_per_s"]
            / max(1e-6, shed1["goodput_rows_per_s"]), 3)
        summary["queue_bounded_at_2x"] = (
            shed2["peak_queue_rows"] <= queue_rows)
    if fifo2 and shed2:
        summary["goodput_2x_fifo_rows_per_s"] = fifo2["goodput_rows_per_s"]
        summary["fifo_2x_peak_queue_rows"] = fifo2["peak_queue_rows"]
    from ..analysis import comm_plan_digest_for_model
    return {
        "bench": "serve-overload",
        "backend": model.device.type,
        "device_kind": dk,
        "precision_policy": model.config.precision_policy(),
        "comm_plan_digest": comm_plan_digest_for_model(model),
        "estimator": "measured",
        "config": {
            "requests_pool": requests, "rows": f"{rows_lo}-{rows_hi}",
            "max_batch": max_batch, "max_wait_ms": max_wait_ms,
            "hidden": hidden, "seed": seed, "burst": burst,
            "cell_seconds": cell_seconds, "slo_ms": round(slo_ms, 3),
            "max_queue_rows": queue_rows,
            "policies": list(policies), "mults": list(mults),
        },
        "capacity": {"qps_requests": capacity_rps,
                     "qps_rows": cap_row["qps_rows"],
                     "mean_dispatch_ms": round(mean_dispatch_ms, 3)},
        "cells": cells,
        "summary": summary,
        "calibration_digest": calibration_digest,
    }


def run_serve_bench(requests: int = 512, rows_lo: int = 1, rows_hi: int = 8,
                    max_batch: int = 64, max_wait_ms: float = 2.0,
                    buckets: str = "", hidden: int = 64, seed: int = 0,
                    burst: int = 4, rate_frac: float = 0.5,
                    paced_requests: int = 0, naive_requests: int = 0,
                    device=None) -> Dict:
    """The three-phase benchmark; returns the JSON payload.
    ``paced_requests``/``naive_requests`` default to fractions of
    ``requests`` (the paced phase costs real wall-clock at the offered
    rate).  ``device`` defaults to the process default (the card)."""
    model = _build_model(max_batch, hidden, seed, max_batch, max_wait_ms,
                         buckets, device=device)
    reqs = make_requests(requests, rows_lo, rows_hi, seed)
    # warm: predict at the naive batch size (its one bucket); the
    # engine's buckets warm in ServingEngine.__init__
    model.predict(reqs[0])

    # each capacity phase runs twice and the faster run is kept: host
    # hiccups only ever inflate a wall-clock sample
    engine_row, engine_outs = _run_engine_maxrate(model, reqs)
    engine_again, _ = _run_engine_maxrate(model, reqs)
    if engine_again["qps_rows"] > engine_row["qps_rows"]:
        engine_row = engine_again
    n_naive = naive_requests or min(requests, 256)
    naive_row, naive_outs = _run_naive(model, reqs[:n_naive])
    naive_again, _ = _run_naive(model, reqs[:n_naive])
    if naive_again["qps_rows"] > naive_row["qps_rows"]:
        naive_row = naive_again
    # parity across the two paths (bit-identical on the CPU with the
    # default bucket set; a bucket-1 list or the card compare loosely,
    # see _bitwise_parity)
    from .batcher import derive_buckets
    bitwise = _bitwise_parity(derive_buckets(max_batch, buckets),
                              model.device)
    for got, want in zip(engine_outs[:8], naive_outs[:8]):
        if bitwise:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    n_paced = paced_requests or min(requests, 256)
    rate = max(1.0, engine_row["qps_requests"] * rate_frac)
    # keep the paced phase's wall-clock bounded (~4s) at any capacity
    n_paced = min(n_paced, int(rate * 4) + 1)
    paced_row = _run_paced(model, reqs[:n_paced], rate, burst, seed)

    from ..analysis import comm_plan_digest_for_model
    from ..search.calibration import device_kind as _device_kind
    return {
        "bench": "serve-bench",
        "backend": model.device.type,
        "device_kind": _device_kind(model.device),
        # int8-quantized and full-precision rows are different
        # populations, and so are rows served under different plans
        # (the static plan digest of `explain`)
        "precision_policy": model.config.precision_policy(),
        "comm_plan_digest": comm_plan_digest_for_model(model),
        "estimator": "measured",  # a real engine run, not a simulator's
        "config": {
            "requests": requests, "rows": f"{rows_lo}-{rows_hi}",
            "max_batch": max_batch, "max_wait_ms": max_wait_ms,
            "buckets": engine_row.pop("buckets"), "hidden": hidden,
            "naive_batch_size": model.config.batch_size, "seed": seed,
        },
        "engine": engine_row,
        "naive": naive_row,
        "paced": paced_row,
        "speedup_rows": round(
            engine_row["qps_rows"] / naive_row["qps_rows"], 2),
        "speedup_requests": round(
            engine_row["qps_requests"] / naive_row["qps_requests"], 2),
    }


_TRACE_COUNTERS = {
    "submitted": "ff_serve_submitted_total",
    "completed": "ff_serve_requests_total",
    "rejected": "ff_serve_rejected_total",
    "shed": "ff_serve_shed_total",
    "expired": "ff_serve_expired_total",
    "error": "ff_serve_errors_total",
    "cancelled": "ff_serve_cancelled_total",
}


def _registry_totals() -> Dict[str, int]:
    """Whole-process sums of the serving lifetime counters (all engine
    generations): the start and end of the trace reconciliation."""
    from ..obs.registry import get_registry
    fams = {f.name: f for f in get_registry().families()}
    return {k: int(fams[n].total()) if n in fams else 0
            for k, n in _TRACE_COUNTERS.items()}


def _finish_trace(tracer, path: str, counters0: Dict[str, int]) -> Dict:
    """Save the raw trace and reconcile it: every request submitted
    during the run must have produced exactly one terminal `request`
    span whose phase matches the engine counters
    (``submitted == completed+rejected+shed+expired+errors+cancelled``,
    phase by phase).  `sample_trace_ids` lets a reader pull those
    requests' timelines out of the exported Chrome trace."""
    raw = tracer.save(path)
    phases = tracer.terminal_phase_counts()
    counters = {k: v - counters0.get(k, 0)
                for k, v in _registry_totals().items()}
    per_phase_ok = all(
        phases.get(ph, 0) == counters.get(ph, 0)
        for ph in ("completed", "rejected", "shed", "expired", "error",
                   "cancelled"))
    reconciled = (per_phase_ok
                  and sum(phases.values()) == counters["submitted"]
                  and raw.get("dropped", 0) == 0)
    sample_ids = [s["trace"] for s in raw["spans"]
                  if s["name"] == "request"][:4]
    tracer.disable()
    return {
        "file": path,
        "schema": raw["schema"],
        "spans": len(raw["spans"]),
        "dropped": raw.get("dropped", 0),
        "terminal_phases": phases,
        "counters": counters,
        "reconciled": bool(reconciled),
        "sample_trace_ids": sample_ids,
    }


def write_payload(payload: Dict, out: str) -> None:
    """A bench's payload as indented JSON on stdout, and into ``out``
    when given."""
    text = json.dumps(payload, indent=2)
    print(text)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
        print(f"# wrote {out}", file=sys.stderr)


# the modes with a bench of their own: the flag and the module whose
# main runs it, given the arguments without the flag
MODES = {
    "--generate": "generation.bench",
    "--fleet": "fleet.bench",
    "--disagg": "cluster.bench",
}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag, module in MODES.items():
        if flag in argv:
            importlib.import_module(f".{module}", __package__).main(
                [a for a in argv if a != flag])
            return
    ap = argparse.ArgumentParser(
        prog="flexflow-tpu-torch serve-bench",
        description="the serving engine's microbenchmark: shape buckets "
                    "and micro-batching against naive per-request "
                    "predict()")
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--rows", default="1-8",
                    help="request row-count range, e.g. 1-8")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--buckets", default="",
                    help="explicit bucket list (default: powers of two)")
    ap.add_argument("--burst", type=int, default=4,
                    help="paced-phase burst size (1 = pure Poisson)")
    ap.add_argument("--rate-frac", type=float, default=0.5,
                    help="paced offered rate as a fraction of measured "
                         "engine capacity")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the device to run on (default: the card)")
    ap.add_argument("--overload", action="store_true",
                    help="run the overload sweep instead of the "
                         "three-phase bench: offered load x admission "
                         "policy -> goodput")
    ap.add_argument("--cell-seconds", type=float, default=2.0,
                    help="overload: offered-load duration per cell")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="overload: goodput SLO / per-request deadline "
                         "(0 = auto from measured dispatch time)")
    ap.add_argument("--queue-rows", type=int, default=0,
                    help="overload: serve_max_queue_rows for bounded "
                         "policies (0 = auto, 4x max-batch)")
    ap.add_argument("--mults", default="0.5,1,2",
                    help="overload: offered-load multiples of measured "
                         "capacity")
    ap.add_argument("--policies", default="fifo,shed_oldest,reject,block",
                    help="overload: admission policies to sweep")
    ap.add_argument("--calibration", default="",
                    help="CalibrationTable JSON whose digest the "
                         "payload records (the table does not alter "
                         "the run)")
    ap.add_argument("--out", default="",
                    help="also write the JSON payload here")
    ap.add_argument("--trace-out", default="",
                    help="enable span tracing at sample_rate=1.0 for "
                         "the whole run and write the raw ff-trace-v1 "
                         "file here (export with `flexflow-tpu-torch "
                         "trace export`); the payload gains a `trace` "
                         "section reconciling terminal span counts "
                         "exactly against the engine counters")
    ap.add_argument("--prom-out", default="",
                    help="write the process metrics registry's "
                         "Prometheus text exposition here after the "
                         "run (what GET /metrics would have served)")
    args = ap.parse_args(argv)
    try:
        lo, hi = (int(v) for v in args.rows.split("-"))
    except ValueError:
        ap.error(f"--rows wants LO-HI, got {args.rows!r}")
    if not (1 <= lo <= hi):
        ap.error(f"--rows wants 1 <= LO <= HI, got {args.rows!r}")
    # resolve the provenance digest before the measured run: a typo'd
    # --calibration fails at once, not after the whole sweep
    digest = None
    if args.calibration:
        from ..search.calibration import CalibrationTable
        try:
            digest = CalibrationTable.load(args.calibration).digest
        except (OSError, ValueError) as e:
            ap.error(f"cannot load --calibration {args.calibration!r}: {e}")
    from ..train_bench import _device
    device = _device(args.device)

    tracer = None
    counters0 = {}
    if args.trace_out:
        from ..obs.trace import get_tracer
        tracer = get_tracer().configure(sample_rate=1.0,
                                        capacity=1 << 20)
        tracer.reset()
        counters0 = _registry_totals()
    # this bench's stdout is the payload: silence the serve_stats and
    # epoch events while measuring (restored after)
    from ..fflogger import silenced
    with silenced("ff", "serve"):
        if args.overload:
            try:
                mults = tuple(float(v) for v in args.mults.split(",")
                              if v.strip())
                policies = tuple(p.strip() for p in
                                 args.policies.split(",") if p.strip())
            except ValueError:
                ap.error(f"bad --mults {args.mults!r}")
            unknown = [p for p in policies if p not in _OVERLOAD_POLICIES]
            if unknown:
                ap.error(f"unknown --policies {unknown} (have "
                         f"{', '.join(_OVERLOAD_POLICIES)})")
            payload = run_overload_bench(
                requests=args.requests, rows_lo=lo, rows_hi=hi,
                max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                buckets=args.buckets, hidden=args.hidden,
                seed=args.seed, burst=args.burst,
                cell_seconds=args.cell_seconds, slo_ms=args.slo_ms,
                queue_rows=args.queue_rows, mults=mults,
                policies=policies, calibration_digest=digest,
                device=device)
        else:
            payload = run_serve_bench(
                requests=args.requests, rows_lo=lo, rows_hi=hi,
                max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                buckets=args.buckets, hidden=args.hidden, seed=args.seed,
                burst=args.burst, rate_frac=args.rate_frac,
                device=device)
    payload["calibration_digest"] = digest
    if tracer is not None:
        payload["trace"] = _finish_trace(tracer, args.trace_out,
                                         counters0)
        print(f"# wrote {args.trace_out} "
              f"({payload['trace']['spans']} spans, reconciled="
              f"{payload['trace']['reconciled']})", file=sys.stderr)
    write_payload(payload, args.out)
    if args.prom_out:
        from ..obs.registry import render_prometheus
        with open(args.prom_out, "w") as f:
            f.write(render_prometheus())
        print(f"# wrote {args.prom_out}", file=sys.stderr)


if __name__ == "__main__":
    main()
