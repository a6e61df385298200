"""The generation driver: clients of ``GenerationEngine.submit`` and its
streams, on the client's clock.

One client thread (this process's main thread) keeps the mix's load on
the engine: a closed loop of ``clients`` that each send their next
request when the last one's final token arrives, or an open loop that
sends on a seeded schedule and times each request from when it was due.
A request's first token is seen by polling its stream every
``POLL_S``; its last token by the stream's completion callback.

The loop runs ``warmup_s`` (set-up) before the window opens.  In the
window it counts the tokens the clients received, the first tokens
(TTFT, send to first token) and the requests finished (TPOT, (last -
first) / (tokens - 1)).  When the window closes the requests in flight
are cancelled and the engine stopped; then a seeded sample of the
requests finished in the window, the longest among them, is held
against the plain reference's full forward.
"""

from __future__ import annotations

import gc
import queue
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, flops, stats, traffic as traffic_mod, weights
from .cell import Cell, Run
from .trace import WINDOW, TracedSpan

POLL_S = 0.001


@dataclass
class Request:
    prompt: np.ndarray
    budget: int
    t_send: float
    stream: object
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    failed: bool = False
    cancelled: bool = False
    n0: int = 0          # tokens received when the window opened
    n1: int = 0          # tokens received when it closed
    alive: bool = True   # not yet seen to finish


class Clients:
    def __init__(self, engine, source, arrival: Dict, seed: int):
        self.engine = engine
        self.source = source
        self.closed = arrival["kind"] == "closed"
        self.arrival = arrival
        self.seed = seed
        self.done: "queue.SimpleQueue" = queue.SimpleQueue()
        self.requests: List[Request] = []
        self.awaiting: List[Request] = []
        self.gaps: List[float] = []
        self.next_due = 0.0
        self.starts: List[float] = []
        self.sending = True

    def send(self, t_send: float) -> None:
        prompt, budget = self.source.next()
        with torch.profiler.record_function("bench.submit"):
            stream = self.engine.submit(prompt, max_new_tokens=budget)
        r = Request(prompt, budget, t_send, stream)
        self.requests.append(r)
        self.awaiting.append(r)
        stream.future.add_done_callback(
            lambda f, r=r: self.done.put((r, time.monotonic())))

    def start(self) -> None:
        """A closed loop's clients send their first requests evenly over
        the mix's ``ramp_s`` seconds (all at once without it), so the
        loop does not start as one wave; an open loop starts its
        schedule now."""
        now = time.monotonic()
        if self.closed:
            n = int(self.arrival["clients"])
            ramp = float(self.arrival.get("ramp_s", 0.0))
            self.starts = [now + ramp * i / n for i in range(n)][::-1]
        else:
            self.next_due = now

    def _due(self) -> float:
        if not self.gaps:
            self.gaps = list(traffic_mod.arrival_gaps(
                self.arrival, traffic_mod.derive(self.seed,
                                                 str(len(self.requests))),
                256))
        return self.gaps.pop()

    def pump(self, until: float) -> None:
        """Serve the loop until the clock reaches ``until``."""
        while True:
            now = time.monotonic()
            if now >= until:
                return
            while self.sending and self.starts and self.starts[-1] <= now:
                self.send(self.starts.pop())
            while self.sending and not self.closed and self.next_due <= now:
                self.send(self.next_due)
                self.next_due += self._due()
            wait = min(POLL_S, until - now)
            if self.starts:
                wait = max(0.0, min(wait, self.starts[-1] - now))
            if not self.closed:
                wait = max(0.0, min(wait, self.next_due - now))
            try:
                item = self.done.get(timeout=wait)
                while True:
                    self._finish(*item)
                    item = self.done.get_nowait()
            except queue.Empty:
                pass
            now = time.monotonic()
            still = []
            for r in self.awaiting:
                if r.stream.tokens_so_far():
                    r.t_first = now
                elif r.alive:
                    still.append(r)
            self.awaiting = still

    def _finish(self, r: Request, t: float) -> None:
        r.alive = False
        r.t_last = t
        if r.t_first is None:
            r.t_first = t
        if r.stream.future.cancelled() or r.stream.future.exception():
            r.failed = not r.cancelled
        if self.closed and self.sending:
            self.send(time.monotonic())

    def mark(self, attr: str) -> None:
        """Each request's tokens received so far, as ``n0`` or ``n1``."""
        for r in self.requests:
            setattr(r, attr, len(r.stream.tokens_so_far()))

    def stop(self) -> None:
        """No more sends; cancel what is in flight."""
        self.sending = False
        for r in self.requests:
            if r.alive:
                r.cancelled = True
                r.stream.cancel()


def _warm_buckets(engine, cfg: Dict, vocab: int) -> None:
    """One request of each prefill-chunk length class the traffic can
    produce (the engine pads a chunk to a power-of-two bucket), so no
    shape is first seen in the window."""
    chunk = int(cfg["serving"]["prefill_chunk"])
    ids = np.random.default_rng(0)
    b = 2
    streams = []
    while True:
        size = min(b, chunk)
        # ids of their own, so no warm-up prompt hits another's pages
        streams.append(engine.submit(
            ids.integers(0, vocab, size, dtype=np.int64).astype(np.int32),
            max_new_tokens=2))
        if size == chunk:
            break
        b *= 2
    for s in streams:
        s.result(timeout=600)


def window_work(reqs: List[Request], t0: float, t1: float, geo: Dict
                ) -> Dict:
    """What the clients received in ``[t0, t1]``, and the model work it
    took: the prefills of the requests whose first token came in the
    window and every decoded token received in it, each at its context."""
    tokens = sum(r.n1 - r.n0 for r in reqs)
    ttft = [r.t_first - r.t_send for r in reqs
            if r.t_first is not None and t0 <= r.t_first <= t1
            and not r.failed]
    done = [r for r in reqs if r.t_last is not None and t0 <= r.t_last <= t1
            and not r.failed and not r.cancelled]
    tpot = [(r.t_last - r.t_first) / (r.n1 - 1) for r in done if r.n1 > 1]
    prefill_rows = decode_rows = 0
    flop = 0.0
    for r in reqs:
        p = int(r.prompt.size)
        if r.t_first is not None and t0 <= r.t_first <= t1 and not r.failed:
            prefill_rows += p
            flop += flops.lm_prefill_flop(geo, p)
        lo = max(r.n0, 1)     # token 0 comes from the prefill
        if r.n1 > lo:
            n = r.n1 - lo
            decode_rows += n
            # token j is decoded from position p + j - 1, attending to
            # p + j positions
            ctx = n * p + (lo + r.n1 - 1) * n / 2.0
            flop += n * flops.lm_token_flop(geo, 0, True) + (
                geo["layers"] * 4.0 * geo["heads"] * geo["head_dim"] * ctx)
    return {"tokens": tokens, "ttft_s": ttft, "tpot_s": tpot,
            "finished": len(done), "prefill_rows": prefill_rows,
            "decode_rows": decode_rows, "model_flop": flop}


def sample(reqs: List[Request], t0: float, t1: float, want: int, seed: int
           ) -> List[Request]:
    """The requests to check: the longest finished in the window, then a
    seeded draw of the others until ``want`` served tokens."""
    done = [r for r in reqs if r.t_last is not None and t0 <= r.t_last <= t1
            and not r.failed and not r.cancelled]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (done[i].n1, -i))
    picked = [done[longest]]
    order = traffic_mod.rng(seed, "check").permutation(len(done))
    for i in order:
        if sum(r.n1 for r in picked) >= want:
            break
        if i != longest:
            picked.append(done[int(i)])
    return picked


def reference_gaps(cell: Cell, seed: int, device, picked: List[Request],
                   control: bool = False) -> Dict[str, float]:
    """``logit_gap``: the widest gap of a served token below the float32
    reference's best over the sample.  With ``control``, also
    ``control_gap``: the same for the token the fp8 reference puts first
    at each of those positions."""
    ref, geo = cell.reference, cell.geometry
    w = weights.make(cell.family.weight_spec(cell.config), seed, device)
    gap = ctrl = 0.0
    for r in picked:
        out = torch.as_tensor(np.asarray(r.stream.result()), device=device)
        seq = torch.cat([torch.as_tensor(r.prompt, device=device),
                         out[:-1]])
        p = int(r.prompt.size)
        lg = ref.logits(w, geo, seq)[p - 1:]
        gap = max(gap, check.logit_gap(lg, out))
        if control:
            first = ref.logits(w, geo, seq, "fp8")[p - 1:].argmax(dim=-1)
            ctrl = max(ctrl, check.logit_gap(lg, first))
        del lg
    out = {"logit_gap": gap}
    if control:
        out["control_gap"] = ctrl
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> Run:
    cuda = torch.device(device).type == "cuda"
    cfg, tr_cfg, fam, geo = cell.config, cell.traffic, cell.family, \
        cell.geometry
    model = fam.build(cfg, device)
    weights.install(model, weights.make(fam.weight_spec(cfg), seed, device))
    arrival = tr_cfg["arrival"]
    queue_cap = (int(arrival["clients"]) if arrival["kind"] == "closed"
                 else int(tr_cfg.get("queue", 4096)))
    engine = fam.engine(model, cfg, queue_cap, seconds)
    span = TracedSpan(cell.kernels(), cuda) if trace else None
    if span:
        span.start()    # before the engine's first launch
    engine.start()
    _warm_buckets(engine, cfg, geo["vocab"])
    clients = Clients(engine, traffic_mod.RequestSource(
        tr_cfg, seed, geo["vocab"]), arrival, seed)
    clients.start()
    clients.pump(time.monotonic() + float(tr_cfg["warmup_s"]))
    setup_s = time.monotonic() - t_start
    hits0 = engine.stats()["prefix_hit_tokens"]
    with torch.profiler.record_function(WINDOW):
        t0 = time.monotonic()
        clients.mark("n0")
        clients.pump(t0 + seconds)
        t1 = time.monotonic()
        clients.mark("n1")
        snap = engine.stats()
    clients.stop()
    engine.stop()
    tr = span.stop() if span else None
    if tr is not None:
        print(f"trace: {len(tr.ops)} device operations in the window, "
              f"reduced in {span.reduce_s:.3f} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    reqs = clients.requests
    work = window_work(reqs, t0, t1, geo)
    # prompt tokens the prefix cache served were not prefilled (their
    # attention share is left in: an over-count where hits occur)
    hits = snap["prefix_hit_tokens"] - hits0
    work["prefix_hit_tokens"] = hits
    work["prefill_rows"] -= hits
    work["model_flop"] -= hits * geo["layers"] * flops.layer_matmul_flop(geo)
    work["decode_step_p50_ms"] = snap["tpot_p50_ms"]
    # two LayerNorms a layer over every token the window prefilled or
    # decoded
    work["layernorm_rows"] = 2 * geo["layers"] * (work["prefill_rows"]
                                                  + work["decode_rows"])
    window_s = t1 - t0
    alive = [r for r in reqs if r.t_last is None or r.t_last >= t0]
    e2e = {"gen_tokens_per_s": work["tokens"] / window_s,
           "ttft_p95_ms": stats.nearest_rank(work["ttft_s"], 0.95) * 1e3,
           "tpot_p95_ms": stats.nearest_rank(work["tpot_s"], 0.95) * 1e3}
    picked = sample(reqs, t0, t1, int(tr_cfg["check_tokens"]), seed)
    # the program's state (its weights, the engine and its KV pool) is
    # freed before the reference runs
    clients.engine = None
    del engine, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = (reference_gaps(cell, seed, device, picked, control)
               if picked else {"logit_gap": float("nan")})
    work["checked_requests"] = len(picked)
    work["checked_tokens"] = sum(r.n1 for r in picked)
    return Run(cell, seed, window_s, work, trace=tr, setup_s=setup_s,
               attempted=len(alive), failed=sum(r.failed for r in alive),
               end_to_end=e2e, checks=numbers, memory_peak_bytes=peak)
