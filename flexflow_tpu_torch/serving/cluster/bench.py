"""The disaggregated pair the cluster tests and ``chip_smoke.py`` drive:
:func:`build_disagg` and :func:`_reconciled` from
``flexflow_tpu/serving/cluster/bench.py``.  The rest of that benchmark
(the interference arms and the calibrated replay) comes with the other
benchmarks."""

from __future__ import annotations

from typing import Dict, List


def _reconciled(snaps: List[Dict]) -> bool:
    """submitted == the sum of terminals, summed across the engines: a
    migrated stream submits on one engine and terminates on another, so
    only the cross-engine sum balances."""
    submitted = sum(s["submitted"] for s in snaps)
    terminal = sum(s["requests"] + s["rejected"] + s["shed"]
                   + s["expired"] + s["errors"] + s["cancelled"]
                   for s in snaps)
    return submitted == terminal


def build_disagg(model, slots: int, max_seq: int, chunk: int,
                 prefix_cache: str = "off", pf_pace_s: float = 0.0):
    """One prefill-role and one decode-role fleet over one model's
    parameters, fronted by a started router.  On one device both engines
    share it and the parameters (no second copy); the decode engine
    imports each migrated chain on its own dispatch thread.  The page
    geometry comes from the model's config (``serve_kv_page``,
    ``serve_kv_pages``), the same for both engines.  ``pf_pace_s`` is
    the prefill host's pause after each dispatch (``FleetEngine.pace_s``);
    off by default, unlike the JAX package's 0.002 s: with both engines on
    one H100, a 0.002 s pause lowered the decode TPOT p95 by 8% but
    raised the run's wall time by 6%, TTFT p50 by 10% and TPOT p50 by 6%
    (10 alternating pairs of runs, ``chip_smoke.disagg_pacing_phase``).
    Returns
    ``(router, fleets, engines)``; the caller stops the router first,
    then the fleets."""
    from ..fleet import FleetEngine
    from ..generation.engine import GenerationEngine
    from .router import FleetRouter

    pf_eng = GenerationEngine(model, slots=slots, max_seq=max_seq,
                              stats_every=0, prefill_chunk=chunk,
                              prefix_cache=prefix_cache)
    dc_eng = GenerationEngine(model, slots=slots, max_seq=max_seq,
                              stats_every=0, prefix_cache=prefix_cache)
    pf = FleetEngine(pace_s=pf_pace_s)
    dc = FleetEngine()
    pf.add_engine("lm", pf_eng)
    dc.add_engine("lm", dc_eng)
    pf.start()
    dc.start()
    router = FleetRouter()
    router.add_host("pf0", pf, role="prefill")
    router.add_host("dc0", dc, role="decode")
    router.start()
    return router, (pf, dc), (pf_eng, dc_eng)


__all__ = ["build_disagg"]
