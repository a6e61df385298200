"""``serve-bench --generate``: the token-generation benchmark, the port of
``flexflow_tpu/serving/generation/bench.py``: continuous batching
against static run-to-completion batching, plus an SLO-goodput sweep.

The claim under test is the continuous-batching scheduler itself: with
MIXED output lengths, a run-to-completion batch wastes every slot whose
stream finished early (a batch of 8 decodes until its LONGEST stream is
done), while iteration-level scheduling backfills freed slots from the
queue at every step boundary.  Both arms run the same prefill and decode
functions (``GraphDecoder``) on the same trace, so the ratio isolates
the scheduler:

1. **continuous**: the GenerationEngine, all requests submitted back to
   back (max rate): tokens/s plus TTFT (submit -> first token) and TPOT
   (decode-step wall time) percentiles;
2. **static**: groups of ``slots`` requests in arrival order, each group
   prefilled then decoded until EVERY member reached its own token
   budget (finished members idle in their slots: the run-to-completion
   waste being measured);
3. **SLO sweep** (unless ``--no-slo-sweep``): offered load at multiples
   of the measured capacity under fifo (unbounded, no deadlines) against
   shed_oldest (bounded queue and TTFT deadline): goodput = tokens of
   requests that completed with TTFT within the SLO.

``--prefix`` runs the shared-prefix and chunked-prefill bench instead
(:func:`run_prefix_bench`), ``--speculate`` the speculative-decoding
sweep (:func:`run_spec_bench`).  Every row stamps ``device_kind``,
``calibration_digest`` and ``comm_plan_digest``.  The models are float32
causal LMs over a 128-token vocabulary, built on ``--device`` (the
runner's, else the card): ``python -m flexflow_tpu_torch.cli serve-bench
--generate [--prefix | --speculate] [--device cpu] [flags]``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

VOCAB = 128


def _build_lm(slots: int, max_seq: int, d_model: int, num_heads: int,
              num_layers: int, seed: int, device=None):
    """The bench's LM on ``device`` (None: the process default, else
    the card): float32, ``d_ff = 4 * d_model``, a ``VOCAB``-token
    vocabulary, weights from ``seed``."""
    import flexflow_tpu_torch as ft
    from ...models import build_transformer_lm

    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=seed)
    cfg.serve_gen_slots = slots
    cfg.serve_gen_max_seq = max_seq
    m = build_transformer_lm(
        cfg, num_layers=num_layers, d_model=d_model, num_heads=num_heads,
        d_ff=4 * d_model, seq_len=max_seq, vocab_size=VOCAB,
        device=device)[0]
    m.compile(ft.SGDOptimizer(lr=0.01))
    m.init_layers(seed=seed)
    return m


def _stamp(model, calibration_digest) -> Dict:
    from ...analysis import comm_plan_digest_for_model
    from ...search.calibration import device_kind
    return {"device_kind": device_kind(model.device),
            "calibration_digest": calibration_digest,
            "comm_plan_digest": comm_plan_digest_for_model(model)}


def make_gen_trace(n: int, prompt_lo: int, prompt_hi: int,
                   short_new: int, long_new: int, long_frac: float,
                   seed: int) -> List[Tuple[np.ndarray, int]]:
    """The mixed-output-length trace: (prompt, max_new_tokens) pairs.
    Bimodal budgets (mostly short answers with a long tail) are the
    regime where run-to-completion batching wastes the most slot-steps
    (every group decodes to its longest member)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(prompt_lo, prompt_hi + 1))
        prompt = rng.integers(1, VOCAB, plen).astype(np.int32)
        max_new = long_new if rng.random() < long_frac else short_new
        out.append((prompt, int(max_new)))
    return out


def _pctl(vals: List[float]) -> Dict[str, Optional[float]]:
    from ...profiling import quantiles
    q = quantiles(vals)

    def ms(v):
        return None if v != v else round(v * 1e3, 3)

    return {"p50_ms": ms(q[0.5]), "p95_ms": ms(q[0.95]),
            "p99_ms": ms(q[0.99])}


def run_continuous(model, trace, slots: int, max_seq: int,
                   stamp: Dict) -> Tuple[Dict, List[List[int]]]:
    """Phase 1: the GenerationEngine at max rate."""
    from .engine import GenerationEngine

    eng = GenerationEngine(model, slots=slots, max_seq=max_seq,
                           stats_every=0)
    useful = sum(mn for _, mn in trace)
    with eng:
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=mn) for p, mn in trace]
        outs = [list(int(t) for t in s.result(timeout=600))
                for s in streams]
        dt = time.perf_counter() - t0
    snap = eng.stats()
    ttfts = [s.ttft for s in streams if s.ttft is not None]
    row = {
        "makespan_s": round(dt, 4),
        "requests": len(trace),
        "tokens": useful,
        "tokens_per_s": round(useful / dt, 2),
        "requests_per_s": round(len(trace) / dt, 2),
        "ttft": _pctl(ttfts),
        "tpot_p50_ms": snap["tpot_p50_ms"],
        "tpot_p95_ms": snap["tpot_p95_ms"],
        "tpot_p99_ms": snap["tpot_p99_ms"],
        **stamp,
    }
    return row, outs


def run_static(model, trace, slots: int, max_seq: int,
               stamp: Dict) -> Tuple[Dict, List[List[int]]]:
    """Phase 2: run-to-completion batching over the SAME decoder
    functions: groups of ``slots`` requests decode until the group's
    longest budget is exhausted; early finishers idle in their slots.
    Drives the paged decoder directly with a static dense-equivalent page
    assignment (slot i owns pages i*tpp .. (i+1)*tpp-1).  The decoder
    updates the pools in place and returns device tokens: the first token
    is read with ``int``, each step's tokens with one copy to the host."""
    from .decoder import GraphDecoder

    dec = GraphDecoder.for_model(model, slots, max_seq)
    caches = dec.init_cache()
    params = model._params
    tpp, page = dec.pages_per_slot, dec.page_size
    assert dec.num_pages >= slots * tpp, "auto pool covers the dense case"
    table = np.arange(slots * tpp, dtype=np.int32).reshape(slots, tpp)
    decode = dec.decode_fn()
    outs: List[List[int]] = []
    useful = sum(mn for _, mn in trace)
    steps = 0
    groups = 0
    t0 = time.perf_counter()
    for g0 in range(0, len(trace), slots):
        group = trace[g0:g0 + slots]
        groups += 1
        states = []
        for i, (prompt, max_new) in enumerate(group):
            bucket = dec.prefill_bucket(prompt.size)
            tok = np.zeros((1, bucket), np.int32)
            tok[0, :prompt.size] = prompt
            first = int(dec.prefill_fn(bucket)(
                params, caches, tok, table[i], i, 0, int(prompt.size)))
            states.append({"last": first, "len": int(prompt.size),
                           "gen": 1, "max": max_new, "out": [first]})
        # run to completion: the WHOLE group steps until its longest
        # member is done, the waste continuous batching removes; a slot
        # the group leaves empty writes through the "no page" sentinel
        while any(st["gen"] < st["max"] for st in states):
            toks = np.zeros((slots,), np.int32)
            pos = np.zeros((slots,), np.int32)
            wp = np.full((slots,), dec.num_pages, np.int32)
            wr = np.zeros((slots,), np.int32)
            for i, st in enumerate(states):
                toks[i] = st["last"]
                p = min(st["len"], max_seq - 1)
                pos[i] = p
                wp[i] = table[i, p // page]
                wr[i] = p % page
            host = decode(params, caches, toks, pos, table, wp,
                          wr).cpu().numpy()
            steps += 1
            for i, st in enumerate(states):
                st["len"] += 1
                if st["gen"] < st["max"]:
                    st["last"] = int(host[i])
                    st["gen"] += 1
                    st["out"].append(int(host[i]))
        outs.extend(st["out"] for st in states)
    dt = time.perf_counter() - t0
    return {
        "makespan_s": round(dt, 4),
        "requests": len(trace),
        "tokens": useful,
        "tokens_per_s": round(useful / dt, 2),
        "groups": groups,
        "decode_steps": steps,
        "slot_steps": steps * slots,
        "slot_efficiency": round(useful / max(1, steps * slots), 4),
        **stamp,
    }, outs


def reference_decode(model, prompt: np.ndarray, max_new: int,
                     max_seq: int) -> List[int]:
    """Replicated predict-style decode: full forward over the padded
    prompt at every step, argmax the last position: the parity reference
    the engine must reproduce token for token."""
    toks = [int(t) for t in prompt]
    for _ in range(max_new):
        padded = np.zeros((1, max_seq), np.int32)
        padded[0, :len(toks)] = toks
        probs = model.predict([padded], batch_size=2)
        toks.append(int(np.argmax(probs[0, len(toks) - 1])))
    return toks[len(prompt):]


def run_slo_cell(model, trace, slots: int, max_seq: int, rate: float,
                 policy: str, slo_ms: float, queue_bound: int,
                 seed: int, stamp: Dict) -> Dict:
    """One SLO-sweep cell: Poisson arrivals at ``rate`` req/s; goodput
    counts tokens of requests that completed with TTFT <= slo."""
    from ..bench import make_arrivals
    from ..errors import ServingError
    from .engine import GenerationEngine

    bounded = policy != "fifo"
    eng = GenerationEngine(
        model, slots=slots, max_seq=max_seq, stats_every=0,
        max_queue_requests=queue_bound if bounded else 0,
        admission="shed_oldest" if bounded else "block")
    arrivals = make_arrivals(len(trace), rate, seed, burst=1)
    entries = []
    t0 = time.perf_counter()
    with eng:
        for (prompt, max_new), at in zip(trace, arrivals):
            lag = t0 + at - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            try:
                s = eng.submit(prompt, max_new_tokens=max_new,
                               deadline_ms=slo_ms if bounded else None)
            except ServingError:
                continue  # rejected at admission (counted engine-side)
            entries.append((s, max_new))
        eng.drain(timeout=max(2.0, 16 * slo_ms / 1e3))
    elapsed = max(1e-6, time.perf_counter() - t0)
    snap = eng.stats()
    good_tokens = 0
    completed = 0
    for s, max_new in entries:
        if s.future.done() and not s.future.cancelled() \
                and s.future.exception() is None:
            completed += 1
            if s.ttft is not None and s.ttft * 1e3 <= slo_ms:
                good_tokens += len(s.tokens_so_far())
    return {
        "policy": policy,
        "offered_rps": round(rate, 2),
        "offered_requests": len(trace),
        "slo_ms": round(slo_ms, 3),
        "queue_bound": queue_bound if bounded else 0,
        "elapsed_s": round(elapsed, 4),
        "completed": completed,
        "goodput_tokens_per_s": round(good_tokens / elapsed, 2),
        "rejected": snap["rejected"],
        "shed": snap["shed"],
        "expired": snap["expired"],
        "peak_queue_requests": snap["peak_queue_requests"],
        **stamp,
    }


# ---------------------------------------------------------------------
# shared-prefix and chunked-prefill bench: TTFT with the prefix cache on
# against off on a shared-prompt trace, the decode stall with chunked
# against monolithic prefill, and the paged pool's high-water against
# the dense baseline, all with identical tokens across arms
# ---------------------------------------------------------------------
def make_prefix_trace(n: int, prefix_len: int, suffix_lo: int,
                      suffix_hi: int, short_new: int, long_new: int,
                      long_frac: float, seed: int,
                      n_prefixes: int = 2) -> List[Tuple[np.ndarray, int]]:
    """Shared-prompt, mixed-length trace: every request is one of
    ``n_prefixes`` shared system prompts (``prefix_len`` tokens, the
    few-shot/system-prompt regime) plus a short unique suffix, with the
    bimodal output budget of :func:`make_gen_trace`."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, VOCAB, prefix_len).astype(np.int32)
                for _ in range(n_prefixes)]
    out = []
    for _ in range(n):
        pref = prefixes[int(rng.integers(0, n_prefixes))]
        slen = int(rng.integers(suffix_lo, suffix_hi + 1))
        suffix = rng.integers(1, VOCAB, slen).astype(np.int32)
        prompt = np.concatenate([pref, suffix])
        max_new = long_new if rng.random() < long_frac else short_new
        out.append((prompt, int(max_new)))
    return out


def _run_prefix_arm(model, trace, slots: int, max_seq: int,
                    prefix_cache: str, stamp: Dict
                    ) -> Tuple[Dict, List[List[int]]]:
    """One prefix-cache A/B arm: the engine at max rate with the cache
    on or off: same decoder functions, same trace, same admission."""
    from .engine import GenerationEngine

    eng = GenerationEngine(model, slots=slots, max_seq=max_seq,
                           stats_every=0, prefix_cache=prefix_cache)
    useful = sum(mn for _, mn in trace)
    with eng:
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=mn) for p, mn in trace]
        outs = [list(int(t) for t in s.result(timeout=600))
                for s in streams]
        dt = time.perf_counter() - t0
        snap = eng.stats()
    ttfts = [s.ttft for s in streams if s.ttft is not None]
    recon = (snap["submitted"] == snap["requests"] + snap["rejected"]
             + snap["shed"] + snap["expired"] + snap["errors"]
             + snap["cancelled"])
    return {
        "prefix_cache": prefix_cache,
        "makespan_s": round(dt, 4),
        "requests": len(trace),
        "tokens": useful,
        "tokens_per_s": round(useful / dt, 2),
        "ttft": _pctl(ttfts),
        "prefix_hit_tokens": snap["prefix_hit_tokens"],
        "prefix_hit_rate": snap["prefix_hit_rate"],
        "evictions": snap["evictions"],
        "kv_pages_high_water": snap["kv_pages_high_water"],
        "kv_high_water_bytes": snap["kv_high_water_bytes"],
        "reconciled": bool(recon),
        **stamp,
    }, outs


def _stall_once(model, slots: int, max_seq: int, chunk: int,
                long_prompts: List[np.ndarray], victim_new: int
                ) -> Tuple[float, List[float], float, int]:
    """One stall measurement: a victim stream decodes while long-prompt
    requests join; returns (max inter-token gap, all gaps, elapsed,
    tokens): the gap is the decode stall a join inflicts (Sarathi's
    metric)."""
    import threading

    from .engine import GenerationEngine

    eng = GenerationEngine(model, slots=slots, max_seq=max_seq,
                           stats_every=0, prefill_chunk=chunk,
                           prefix_cache="off")
    gaps: List[float] = []
    with eng:
        victim = eng.submit(np.arange(1, 5, dtype=np.int32),
                            max_new_tokens=victim_new)
        got = threading.Event()

        def consume():
            last = time.perf_counter()
            for _ in victim:
                now = time.perf_counter()
                gaps.append(now - last)
                last = now
                got.set()

        th = threading.Thread(target=consume, daemon=True,
                              name="ff-genbench-consume")
        th.start()
        got.wait(timeout=60)  # the victim is decoding before the joins
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=2) for p in long_prompts]
        for s in streams:
            s.result(timeout=600)
        victim.result(timeout=600)
        dt = time.perf_counter() - t0
        th.join(timeout=60)
    tokens_done = victim_new + 2 * len(long_prompts)
    # the first gap includes the victim's own queue and prefill; the
    # stall evidence is the max gap AFTER streaming started
    stall = max(gaps[1:]) if len(gaps) > 1 else 0.0
    return stall, gaps[1:], dt, tokens_done


def _run_stall_arm(model, slots: int, max_seq: int, chunk: int,
                   long_prompts: List[np.ndarray], victim_new: int,
                   stamp: Dict, repeats: int = 3) -> Dict:
    """One chunked-prefill A/B arm, min of ``repeats``: the max
    inter-token gap is a MAX statistic, so one host-scheduler hiccup can
    dominate a run; the min over repeats is each arm's stall floor, the
    mechanism under test.  ``chunk=0`` is the monolithic baseline."""
    stalls: List[float] = []
    gaps_best: List[float] = []
    total_s = 0.0
    total_tokens = 0
    for _ in range(max(1, repeats)):
        stall, gaps, dt, toks = _stall_once(model, slots, max_seq,
                                            chunk, long_prompts,
                                            victim_new)
        if not stalls or stall < min(stalls):
            gaps_best = gaps
        stalls.append(stall)
        total_s += dt
        total_tokens += toks
    return {
        "prefill_chunk": chunk,
        "victim_max_gap_ms": round(min(stalls) * 1e3, 3),
        "victim_max_gap_ms_runs": [round(s * 1e3, 3) for s in stalls],
        "victim_gap_p50_ms": _pctl(gaps_best)["p50_ms"],
        "join_prompts": len(long_prompts),
        "repeats": max(1, repeats),
        "tokens": total_tokens,
        "elapsed_s": round(total_s, 4),
        "tokens_per_s": round(total_tokens / max(1e-6, total_s), 2),
        **stamp,
    }


def run_prefix_bench(requests: int = 48, slots: int = 8,
                     max_seq: int = 128, prefix_len: int = 48,
                     suffix_lo: int = 2, suffix_hi: int = 8,
                     short_new: int = 4, long_new: int = 24,
                     long_frac: float = 0.25, d_model: int = 64,
                     num_heads: int = 4, num_layers: int = 2,
                     seed: int = 0, prefill_chunk: int = 8,
                     stall_prompts: int = 6,
                     stall_prompt_len: int = 112,
                     calibration_digest=None, device=None) -> Dict:
    """The whole ``--prefix`` payload.

    Acceptance booleans: prefix-cache TTFT p95 strictly below the
    no-cache run on the shared-prefix trace with IDENTICAL tokens,
    chunked-prefill decode stall strictly below monolithic at comparable
    throughput, the KV high-water below the dense baseline at equal
    slots, and the submitted == terminal-outcomes reconciliation holding
    in every arm."""
    model = _build_lm(slots, max_seq, d_model, num_heads, num_layers,
                      seed, device=device)
    trace = make_prefix_trace(requests, prefix_len, suffix_lo,
                              suffix_hi, short_new, long_new, long_frac,
                              seed)
    stamp = _stamp(model, calibration_digest)

    # SYMMETRIC best of 2: both arms run twice over the same functions
    # (the first pair also absorbs the warm-up) and each keeps its
    # better p95; a one-sided min would bias ttft_cache_win toward the
    # arm that got two samples
    def best(arm):
        r1, o1 = _run_prefix_arm(model, trace, slots, max_seq, arm,
                                 stamp)
        r2, o2 = _run_prefix_arm(model, trace, slots, max_seq, arm,
                                 stamp)
        assert o1 == o2  # determinism within the arm
        if (r2["ttft"]["p95_ms"] or 1e9) < (r1["ttft"]["p95_ms"] or 1e9):
            return r2, o2
        return r1, o1

    on_row, on_outs = best("on")
    off_row, off_outs = best("off")
    parity = on_outs == off_outs

    rng = np.random.default_rng(seed + 1)
    long_prompts = [rng.integers(1, VOCAB,
                                 stall_prompt_len).astype(np.int32)
                    for _ in range(stall_prompts)]
    victim_new = max_seq - 8
    mono = _run_stall_arm(model, slots, max_seq, 0, long_prompts,
                          victim_new, stamp)
    chunked = _run_stall_arm(model, slots, max_seq, prefill_chunk,
                             long_prompts, victim_new, stamp)

    from ...analysis.kv_memory import dtype_bytes, kv_page_plan
    plan = kv_page_plan(model.layers, None, slots, max_seq,
                        kv_dtype_bytes=dtype_bytes(
                            model.config.compute_dtype))
    dense_baseline = plan["total_bytes"]  # auto pool == dense worst case

    ttft_win = ((on_row["ttft"]["p95_ms"] or 1e9)
                < (off_row["ttft"]["p95_ms"] or 0.0))
    stall_win = (chunked["victim_max_gap_ms"]
                 < mono["victim_max_gap_ms"])
    thr_ratio = (chunked["tokens_per_s"]
                 / max(1e-6, mono["tokens_per_s"]))
    # STRICT, and also <= the no-cache arm: high_water <= pool size holds
    # by construction (the auto pool IS the dense baseline), so a
    # non-strict bound would gate nothing; the claim is that pages in use
    # scale with live and shared tokens
    hbm_ok = (on_row["kv_high_water_bytes"] < dense_baseline
              and on_row["kv_high_water_bytes"]
              <= off_row["kv_high_water_bytes"])
    recon = bool(on_row["reconciled"] and off_row["reconciled"])
    return {
        "bench": "gen-prefix",
        "backend": model.device.type,
        "estimator": "measured",
        **stamp,
        "config": {
            "requests": requests, "slots": slots, "max_seq": max_seq,
            "prefix_len": prefix_len,
            "suffix": f"{suffix_lo}-{suffix_hi}",
            "short_new": short_new, "long_new": long_new,
            "long_frac": long_frac, "d_model": d_model,
            "num_heads": num_heads, "num_layers": num_layers,
            "seed": seed, "vocab": VOCAB,
            "page_size": plan["page_size"],
            "num_pages": plan["num_pages"],
            "prefill_chunk": prefill_chunk,
            "stall_prompts": stall_prompts,
            "stall_prompt_len": stall_prompt_len,
        },
        "prefix_cache": {"on": on_row, "off": off_row},
        "chunked_prefill": {"monolithic": mono, "chunked": chunked,
                            "throughput_ratio": round(thr_ratio, 3)},
        "kv_memory": {
            "dense_baseline_bytes": dense_baseline,
            "page_bytes": plan["page_bytes"],
            "high_water_bytes_cache_on": on_row["kv_high_water_bytes"],
            "high_water_bytes_cache_off":
                off_row["kv_high_water_bytes"],
        },
        "acceptance": {
            "ttft_cache_win": bool(ttft_win),
            "prefix_parity": bool(parity),
            "chunked_stall_win": bool(stall_win),
            "throughput_comparable": bool(thr_ratio >= 0.8),
            "hbm_high_water_ok": bool(hbm_ok),
            "reconciliation_ok": recon,
        },
    }


def run_generate_bench(requests: int = 96, slots: int = 8,
                       max_seq: int = 128, prompt_lo: int = 2,
                       prompt_hi: int = 8, short_new: int = 4,
                       long_new: int = 96, long_frac: float = 0.125,
                       d_model: int = 64, num_heads: int = 4,
                       num_layers: int = 2, seed: int = 0,
                       parity_checks: int = 2, slo_sweep: bool = True,
                       slo_ms: float = 0.0,
                       mults=(0.5, 1.0, 2.0),
                       calibration_digest=None, device=None) -> Dict:
    """The whole ``--generate`` payload."""
    model = _build_lm(slots, max_seq, d_model, num_heads, num_layers,
                      seed, device=device)
    trace = make_gen_trace(requests, prompt_lo, prompt_hi, short_new,
                           long_new, long_frac, seed)
    stamp = _stamp(model, calibration_digest)

    # the first engine's start warms the decoder's functions; the
    # decoder (one per geometry, GraphDecoder.for_model) is shared with
    # every later engine AND the static arm
    cont_row, cont_outs = run_continuous(model, trace, slots, max_seq,
                                         stamp)
    static_row, static_outs = run_static(model, trace, slots, max_seq,
                                         stamp)
    # scheduler isolation check: both arms decode the same tokens
    scheds_agree = all(a == b for a, b in zip(cont_outs, static_outs))

    # engine == replicated predict-style decode, token for token (a
    # greedy stream's first k tokens never depend on later ones, so a
    # bounded prefix check pins the whole trajectory class)
    parity = True
    for i, (prompt, max_new) in enumerate(trace[:parity_checks]):
        want = reference_decode(model, prompt, min(max_new, 8), max_seq)
        if cont_outs[i][:len(want)] != want:
            parity = False
            break

    cells = []
    eff_slo = slo_ms
    if slo_sweep:
        capacity = cont_row["requests_per_s"]
        if eff_slo <= 0:
            p95 = cont_row["ttft"]["p95_ms"] or 50.0
            eff_slo = max(50.0, 4 * p95)
        for mult in mults:
            rate = max(0.5, capacity * mult)
            n = max(8, min(len(trace), int(rate * 2.0)))
            for policy in ("fifo", "shed_oldest"):
                cells.append(run_slo_cell(
                    model, trace[:n], slots, max_seq, rate, policy,
                    eff_slo, 2 * slots, seed + len(cells), stamp)
                    | {"offered_mult": mult})

    return {
        "bench": "serve-generate",
        "backend": model.device.type,
        "estimator": "measured",
        **stamp,
        "config": {
            "requests": requests, "slots": slots, "max_seq": max_seq,
            "prompt": f"{prompt_lo}-{prompt_hi}",
            "short_new": short_new, "long_new": long_new,
            "long_frac": long_frac, "d_model": d_model,
            "num_heads": num_heads, "num_layers": num_layers,
            "seed": seed, "vocab": VOCAB,
        },
        "continuous": cont_row,
        "static": static_row,
        "speedup_tokens": round(
            cont_row["tokens_per_s"]
            / max(1e-6, static_row["tokens_per_s"]), 2),
        "parity": {"reference_checks": parity_checks,
                   "engine_eq_reference": bool(parity),
                   "schedulers_agree": bool(scheds_agree)},
        "slo_sweep": {"slo_ms": round(eff_slo, 3), "cells": cells}
        if slo_sweep else None,
    }


def _build_spec_pair(slots: int, max_seq: int, d_model: int,
                     num_heads: int, num_layers: int, seed: int,
                     draft_layers: int = 1, device=None):
    """A (target, draft) pair where the draft is a WELL-CALIBRATED cheap
    approximation of the target, the premise of speculative decoding,
    made without training: the target's blocks past ``draft_layers`` are
    neutralized (zeroed attention and FFN output projections,
    identity-standardizing layer norms), so on the already standardized
    residual stream each is an identity up to the LN epsilon, and the
    draft is the target truncated to its first ``draft_layers`` blocks
    with every remaining weight SHARED.  The target still pays the full
    ``num_layers`` of dense compute a step, the draft ``draft_layers``.

    The target's tensors are written in place and the draft's
    ``_params`` entries are bound to the same tensor objects, so both
    models must sit on one device (the draft is built on the target's)."""
    import torch

    if not 1 <= draft_layers < num_layers:
        raise ValueError("--speculate needs 1 <= draft layers < "
                         "--layers (the draft is a truncation of the "
                         "target)")
    target = _build_lm(slots, max_seq, d_model, num_heads, num_layers,
                       seed, device=device)
    draft = _build_lm(slots, max_seq, d_model, num_heads, draft_layers,
                      seed, device=target.device)
    p = target._params
    with torch.no_grad():
        # the LAST shared norm standardizes the stream (scale 1, bias 0)
        # so every neutralized block's norms see already-unit input
        p[f"ln_ffn_{draft_layers - 1}/scale"].fill_(1.0)
        p[f"ln_ffn_{draft_layers - 1}/bias"].zero_()
        for blk in range(draft_layers, num_layers):
            for name in (f"attention_{blk}/wo", f"attention_{blk}/bias",
                         f"ffn_down_{blk}/kernel", f"ffn_down_{blk}/bias"):
                p[name].zero_()
            for ln in (f"ln_attn_{blk}", f"ln_ffn_{blk}"):
                p[f"{ln}/scale"].fill_(1.0)
                p[f"{ln}/bias"].zero_()
    for name in draft._params:
        draft._params[name] = p[name]
    return target, draft


def _run_spec_arm(model, draft, trace, slots: int, max_seq: int,
                  gamma, policy: str, gamma_max: int,
                  temperature: float, sample_seed: int,
                  stamp: Dict) -> Tuple[Dict, List[List[int]]]:
    """One cell of the speculation sweep: the GenerationEngine with
    (``gamma``, ``policy``) against the same trace.  ``gamma`` 0 (with
    ``draft`` None) is the plain-decode baseline arm; ``temperature`` 0
    submits greedy streams, > 0 seeded sampled ones (per-request
    ``SamplingParams.seed = sample_seed + i``)."""
    from .engine import GenerationEngine
    from .sampling import SamplingParams

    kw = {}
    if draft is not None:
        kw = dict(draft_model=draft, spec_gamma=int(gamma),
                  spec_policy=policy, spec_gamma_max=gamma_max)
    eng = GenerationEngine(model, slots=slots, max_seq=max_seq,
                           stats_every=0, **kw)
    with eng:
        t0 = time.perf_counter()
        streams = [
            eng.submit(p, max_new_tokens=mn,
                       sampling=(SamplingParams(temperature=temperature,
                                                seed=sample_seed + i)
                                 if temperature > 0 else None))
            for i, (p, mn) in enumerate(trace)]
        outs = [list(int(t) for t in s.result(timeout=600))
                for s in streams]
        dt = time.perf_counter() - t0
        snap = eng.stats()
    useful = sum(len(o) for o in outs)
    row = {
        "arm": ("adaptive" if policy == "adaptive" else f"g{gamma}"),
        "gamma": (None if policy == "adaptive" else int(gamma)),
        "policy": policy,
        "temperature": temperature,
        "makespan_s": round(dt, 4),
        "tokens": useful,
        "tokens_per_s": round(useful / dt, 2),
        "tpot_p50_ms": snap["tpot_p50_ms"],
        "tpot_p95_ms": snap["tpot_p95_ms"],
        "tpot_p99_ms": snap["tpot_p99_ms"],
        "accept_rate": snap["accept_rate"],
        "draft_dispatches": snap["draft_dispatches"],
        "spec_proposed_tokens": snap["spec_proposed_tokens"],
        "spec_accepted_tokens": snap["spec_accepted_tokens"],
        "spec_fallbacks": snap["spec_fallbacks"],
        "spec_gamma_final": snap["spec_gamma"],
        "spec": snap["spec"],
        **stamp,
    }
    return row, outs


def run_spec_bench(requests: int = 16, slots: int = 4,
                   max_seq: int = 128, prompt_lo: int = 2,
                   prompt_hi: int = 8, new_tokens: int = 64,
                   d_model: int = 64, num_heads: int = 4,
                   num_layers: int = 4, draft_layers: int = 1,
                   seed: int = 0,
                   gamma_max: int = 8, temperature: float = 0.8,
                   calibration_digest=None, device=None) -> Dict:
    """The ``--generate --speculate`` payload: the TPOT sweep over gamma
    in {0, 2, 4, adaptive} x {greedy, temperature}, the draft the
    weight-shared truncation of :func:`_build_spec_pair`.  Acceptance
    booleans: the best greedy speculation arm beats the gamma=0 arm on
    tokens/s (spec_tokens_win), greedy speculation is token-identical to
    plain decode (greedy_parity), and the sampled arm reproduces exactly
    on a second run with the same per-request seeds
    (sampled_reproducible)."""
    model, draft = _build_spec_pair(slots, max_seq, d_model, num_heads,
                                    num_layers, seed,
                                    draft_layers=draft_layers,
                                    device=device)
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(requests):
        plen = int(rng.integers(prompt_lo, prompt_hi + 1))
        trace.append((rng.integers(1, VOCAB, plen).astype(np.int32),
                      new_tokens))
    stamp = _stamp(model, calibration_digest)

    arms = [(0, "fixed"), (2, "fixed"), (4, "fixed"), (2, "adaptive")]
    greedy_rows: List[Dict] = []
    sampled_rows: List[Dict] = []
    base_outs = None
    greedy_parity = True
    sampled_repro = True
    for gamma, policy in arms:
        d = None if (gamma == 0 and policy == "fixed") else draft
        # every cell runs TWICE: the first run absorbs the warm-up, the
        # second is the recorded measurement; for the sampled gamma=2
        # cell the pair doubles as the per-(seed, request)
        # reproducibility check
        _run_spec_arm(model, d, trace, slots, max_seq, gamma, policy,
                      gamma_max, 0.0, seed, stamp)
        row, outs = _run_spec_arm(model, d, trace, slots, max_seq,
                                  gamma, policy, gamma_max, 0.0,
                                  seed, stamp)
        greedy_rows.append(row)
        if base_outs is None:
            base_outs = outs
        elif outs != base_outs:
            greedy_parity = False
        _, souts1 = _run_spec_arm(model, d, trace, slots, max_seq,
                                  gamma, policy, gamma_max,
                                  temperature, seed + 1000, stamp)
        srow, souts = _run_spec_arm(model, d, trace, slots, max_seq,
                                    gamma, policy, gamma_max,
                                    temperature, seed + 1000, stamp)
        sampled_rows.append(srow)
        if gamma == 2 and policy == "fixed":
            sampled_repro = souts == souts1

    base_tps = greedy_rows[0]["tokens_per_s"]
    best_spec_tps = max(r["tokens_per_s"] for r in greedy_rows[1:])
    return {
        "bench": "gen-spec",
        "backend": model.device.type,
        "estimator": "measured",
        **stamp,
        "config": {
            "requests": requests, "slots": slots, "max_seq": max_seq,
            "prompt": f"{prompt_lo}-{prompt_hi}",
            "new_tokens": new_tokens, "d_model": d_model,
            "num_heads": num_heads, "num_layers": num_layers,
            "seed": seed, "vocab": VOCAB, "gamma_max": gamma_max,
            "temperature": temperature,
            "draft": f"weight-shared truncation ({draft_layers} of "
                     f"{num_layers} layers)",
        },
        "arms": {"greedy": greedy_rows, "temperature": sampled_rows},
        "speedup_tokens": round(best_spec_tps / max(1e-6, base_tps), 2),
        "acceptance": {
            "spec_tokens_win": bool(best_spec_tps > base_tps),
            "greedy_parity": bool(greedy_parity),
            "sampled_reproducible": bool(sampled_repro),
        },
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="flexflow-tpu-torch serve-bench --generate",
        description="token-generation benchmark: continuous batching "
                    "against run-to-completion, and the SLO-goodput "
                    "sweep")
    ap.add_argument("--prefix", action="store_true",
                    help="run the shared-prefix and chunked-prefill "
                         "bench instead (paged KV evidence)")
    ap.add_argument("--speculate", action="store_true",
                    help="run the speculative-decoding TPOT sweep "
                         "instead: gamma in {0,2,4,adaptive} x "
                         "{greedy, temperature} with a weight-shared "
                         "draft")
    ap.add_argument("--new-tokens", type=int, default=64,
                    help="speculate bench: uniform per-request token "
                         "budget (decode-heavy: the TPOT regime)")
    ap.add_argument("--temperature", type=float, default=0.8,
                    help="speculate bench: temperature of the sampled "
                         "arms")
    ap.add_argument("--draft-layers", type=int, default=1,
                    help="speculate bench: blocks the weight-shared "
                         "draft keeps (draft/target cost ratio "
                         "DRAFT_LAYERS/LAYERS)")
    ap.add_argument("--gamma-max", type=int, default=8,
                    help="speculate bench: adaptive-arm gamma ceiling")
    ap.add_argument("--prefix-len", type=int, default=48,
                    help="prefix bench: shared system-prompt length")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prefix bench: chunk size for the chunked "
                         "arm of the decode-stall A/B")
    # None sentinels for the knobs whose defaults differ per mode: a
    # comparison with the default could not tell an explicit 96 from
    # the default 96
    ap.add_argument("--requests", type=int, default=None,
                    help="trace size (default 96; 48 under --prefix, "
                         "16 under --speculate)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--prompt", default="2-8",
                    help="prompt-length range, e.g. 2-8 (suffix range "
                         "under --prefix)")
    ap.add_argument("--short-new", type=int, default=4)
    ap.add_argument("--long-new", type=int, default=None,
                    help="long-tail token budget (default 96; 24 "
                         "under --prefix)")
    ap.add_argument("--long-frac", type=float, default=None,
                    help="fraction of requests with the long token "
                         "budget, the chat-like mostly-short mix "
                         "(default 0.125; 0.25 under --prefix)")
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--layers", type=int, default=None,
                    help="transformer blocks (default 2; 4 under "
                         "--speculate: the draft/target cost gap)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-slo-sweep", action="store_true")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="TTFT SLO for the goodput sweep (0 = auto "
                         "from the measured continuous-phase TTFT)")
    ap.add_argument("--mults", default="0.5,1,2")
    ap.add_argument("--calibration", default="",
                    help="CalibrationTable JSON whose digest the "
                         "payload records")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the device to run on (default: the runner's, "
                         "else the card)")
    ap.add_argument("--out", default="",
                    help="also write the JSON payload here")
    args = ap.parse_args(argv)
    try:
        lo, hi = (int(v) for v in args.prompt.split("-"))
        mults = tuple(float(v) for v in args.mults.split(",")
                      if v.strip())
    except ValueError:
        ap.error(f"bad --prompt {args.prompt!r} or --mults "
                 f"{args.mults!r}")
    if not (1 <= lo <= hi):
        ap.error(f"--prompt wants 1 <= LO <= HI, got {args.prompt!r}")
    digest = None
    if args.calibration:
        from ...search.calibration import CalibrationTable
        try:
            digest = CalibrationTable.load(args.calibration).digest
        except (OSError, ValueError) as e:
            ap.error(f"cannot load --calibration "
                     f"{args.calibration!r}: {e}")
    from ...fflogger import silenced
    from ...train_bench import _device
    from ..bench import write_payload
    device = _device(args.device)

    with silenced("ff", "serve"):
        if args.speculate:
            payload = run_spec_bench(
                requests=16 if args.requests is None else args.requests,
                slots=args.slots, max_seq=args.max_seq,
                prompt_lo=lo, prompt_hi=hi,
                new_tokens=args.new_tokens,
                d_model=args.d_model, num_heads=args.heads,
                num_layers=4 if args.layers is None else args.layers,
                draft_layers=args.draft_layers, seed=args.seed,
                gamma_max=args.gamma_max,
                temperature=args.temperature,
                calibration_digest=digest, device=device)
        elif args.prefix:
            payload = run_prefix_bench(
                requests=48 if args.requests is None else args.requests,
                slots=args.slots, max_seq=args.max_seq,
                prefix_len=args.prefix_len, suffix_lo=lo, suffix_hi=hi,
                short_new=args.short_new,
                long_new=24 if args.long_new is None else args.long_new,
                long_frac=(0.25 if args.long_frac is None
                           else args.long_frac),
                d_model=args.d_model, num_heads=args.heads,
                num_layers=2 if args.layers is None else args.layers,
                seed=args.seed, prefill_chunk=args.prefill_chunk,
                calibration_digest=digest, device=device)
        else:
            payload = run_generate_bench(
                requests=96 if args.requests is None else args.requests,
                slots=args.slots,
                max_seq=args.max_seq, prompt_lo=lo, prompt_hi=hi,
                short_new=args.short_new,
                long_new=96 if args.long_new is None else args.long_new,
                long_frac=(0.125 if args.long_frac is None
                           else args.long_frac),
                d_model=args.d_model, num_heads=args.heads,
                num_layers=2 if args.layers is None else args.layers,
                seed=args.seed, slo_sweep=not args.no_slo_sweep,
                slo_ms=args.slo_ms, mults=mults,
                calibration_digest=digest, device=device)
    write_payload(payload, args.out)


if __name__ == "__main__":
    main()
