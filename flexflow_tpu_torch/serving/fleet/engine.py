"""FleetEngine — N models, one card, one dispatcher: the port of
``flexflow_tpu/serving/fleet/engine.py``.

Every resident engine runs in fleet mode (``begin_external_dispatch``:
its producer side, admission, deadlines and priorities, unchanged) and
one fleet dispatcher thread interleaves their dispatches under
**weighted-fair device-time scheduling**:

* each tenant accrues virtual time ``charged_device_seconds / weight``;
  the dispatcher serves the backlogged tenant with the lowest virtual
  time (start-time fair queuing: a tenant returning from idle is clamped
  to the virtual clock, so idling banks no credit).  The seconds charged
  are what ``dispatch_pending`` returns, which end once the dispatch's
  results reached the host;
* an optional per-tenant ``qps_rows`` budget (a token bucket on the
  injectable clock) caps a tenant's throughput.

**Hot load / unload / swap**: ``load()`` builds and warms the new model
on a background thread, then publishes it atomically at a dispatch
boundary.  A swap moves the outgoing engine's queue onto the replacement
(``MicroBatcher.requeue``: admitted work is never judged again);
``unload()`` closes admission, flushes the queue through normal dispatch
and fails only the stragglers.  The ``fleet_load_fail:<name>`` and
``fleet_swap_at_dispatch:N`` FF_FAULT kinds make load failures and swap
timing deterministic.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Callable, Dict, List, Optional

from ... import faults
from ...fflogger import get_logger
from ...obs import lockwatch
from ..engine import ServingEngine
from ..generation.engine import GenerationEngine
from .registry import ModelRegistry, TenantSpec, build_model


# counter continuity across hot swaps: the lifetime keys summed over
# every engine generation that served under one tenant name
_CONTINUITY_KEYS = ("dispatches", "requests", "rows", "errors",
                    "rejected", "shed", "expired", "cancelled",
                    "submitted")
# LIVE retired-generation metrics kept per tenant before the oldest is
# folded into the static carry and its registry series reclaimed: a
# generation this many swaps old has drained its transferred requests
# (each swap's moved queue resolves within the NEXT generation's
# serving period), so the fold is exact in practice while a week of
# hot swaps stays bounded in registry memory
_MAX_RETIRED_METRICS = 4


class _Tenant:
    """Dispatcher-side state of one resident model."""

    __slots__ = ("name", "kind", "engine", "weight", "qps_rows", "vtime",
                 "allowance", "last_refill", "idle", "retired", "carried")

    def __init__(self, name: str, kind: str, engine, weight: float,
                 qps_rows: float, now: float):
        self.name = name
        self.kind = kind            # "dense" | "generation"
        self.engine = engine
        self.weight = float(weight)
        self.qps_rows = float(qps_rows)
        self.vtime = 0.0            # used device seconds / weight
        self.allowance = qps_rows   # token bucket (rows; 1s burst)
        self.last_refill = now
        self.idle = True            # for the SFQ idle clamp (_pick)
        # ServingMetrics of swapped-out engine generations.  LIVE
        # objects, not snapshots: a request transferred across the
        # swap resolves on the NEW engine but records into the metrics
        # its submit() closure captured — the OLD one — so counter
        # continuity needs the object, not a copy taken at swap time.
        # Bounded: beyond _MAX_RETIRED_METRICS generations the oldest
        # is folded into `carried` (static sums) and unregistered.
        self.retired: List = []
        self.carried: Dict[str, float] = {}

    def has_pending(self) -> bool:
        return self.engine.has_pending

    def refill(self, now: float) -> None:
        if self.qps_rows <= 0:
            return
        self.allowance = min(
            self.qps_rows,
            self.allowance + (now - self.last_refill) * self.qps_rows)
        self.last_refill = now

    def within_budget(self) -> bool:
        # eligible while the bucket is positive (it may go negative by
        # up to one dispatch and recover at qps_rows/s — standard
        # token-bucket overshoot).  NOT `>= 1.0`: the bucket is capped
        # at qps_rows, so a sub-1.0 budget would never reach 1 and the
        # tenant would be starved forever instead of paced
        return self.qps_rows <= 0 or self.allowance > 0.0

    @staticmethod
    def _param_bytes(params) -> int:
        return sum(t.numel() * t.element_size() for t in params.values())

    def resident_bytes(self) -> float:
        """The tenant's always-resident bytes on its device: every
        parameter tensor the engine serves from, plus a generation
        engine's allocated KV pools and, under speculative decoding, the
        draft's parameters and pools.  The static co-residency gate
        predicts this number byte for byte (``gate.model_residency``)."""
        eng = self.engine
        if self.kind != "generation":
            return float(self._param_bytes(eng.model._params))
        total = self._param_bytes(eng._params) + eng.kv_cache_bytes
        if eng.draft_model is not None:
            total += self._param_bytes(eng.draft_model._params)
            total += eng.draft_kv_cache_bytes
        return float(total)


class FleetEngine:
    """Multi-tenant serving on one device.

    ::

        fleet = FleetEngine(registry)        # or FleetEngine()
        with fleet:                          # builds + starts tenants
            fut = fleet.submit("ranker", x_rows)
            stream = fleet.submit("chat", prompt_ids)
            fleet.load("ranker", wait=True)  # hot swap (new checkpoint)
            fleet.unload("chat", timeout=1.0)

    Tenants come from a :class:`~.registry.ModelRegistry` (built
    lazily at ``start()``) and/or are attached live via
    :meth:`add_engine` (an already-constructed engine) or :meth:`load`
    (background build + atomic publish).  Registry tenants are built on
    ``device`` (None: the card).  ``clock``/``sleep`` are injectable for
    deterministic tests."""

    # dispatcher park time between polls when nothing is due: short
    # enough to honor ~ms deadlines, long enough not to spin
    _IDLE_WAIT_S = 0.002

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 device=None, stats_every_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 autoscaler=None, share_identical: bool = False,
                 pace_s: float = 0.0):
        self.registry = registry
        self.device = device
        self.clock = clock
        self._sleep = sleep
        self.stats_every_s = float(stats_every_s)
        # dispatch pacing: yield the CPU for pace_s after
        # every served dispatch.  A placement-aware knob for THROUGHPUT
        # roles sharing a substrate with a latency role — a paced
        # prefill host hands the core to a co-resident decode host at
        # every op boundary instead of once per scheduler quantum, for
        # a TTFT cost of pace_s per chunk (~1% of a long prefill).
        # Meaningless co-located: there the prefill chunk and the
        # decode step share ONE dispatch loop, so a pause here delays
        # the victim it would protect.  Zero = off (default).
        self.pace_s = float(pace_s)
        # per-tenant autoscaling policy (fleet/autoscale.py): consulted
        # by the dispatcher at its boundary with each tenant's queue
        # depth; a returned weight is applied under the lock and
        # announced as a fleet_autoscale event
        self.autoscaler = autoscaler
        # cross-tenant dispatch sharing: tenants whose models share a
        # graph digest (two checkpoints of one graph: the same programs,
        # other params) are served back to back in ONE dispatcher turn
        self.share_identical = bool(share_identical)
        self._lock = lockwatch.lock("FleetEngine._lock")
        self._tenants: Dict[str, _Tenant] = {}  # guarded_by: self._lock
        # swapped-out GENERATION tenants still holding active decode
        # slots: the dispatcher keeps stepping them (admission closed,
        # queue already transferred) until every stream retires, then
        # finalizes — a swap must not strand or shed mid-flight
        # streams, whose KV state cannot move to the new engine
        self._retiring: List[_Tenant] = []  # guarded_by: self._lock
        # publish queue: (name, _Tenant) applied atomically at a
        # dispatch boundary by the dispatcher
        self._publishes: List = []   # guarded_by: self._lock
        self._thread: Optional[  # guarded_by: self._lock
            threading.Thread] = None
        self._stopped = False    # guarded_by: self._lock
        self._draining = False   # guarded_by: self._lock
        self._wake = threading.Event()
        # name of the tenant whose dispatch is currently executing
        # (dispatcher writes; unload() polls it so "queue drained"
        # includes the batch already popped into the in-flight
        # dispatch — benign read race, it only extends the wait)
        self._in_flight: Optional[str] = None  # dispatcher-thread-only
        self._n_dispatch = 0     # dispatcher-thread-only (single writer)
        self._last_stats_t = 0.0  # dispatcher-thread-only
        # SFQ global virtual clock: the vtime of the tenant served
        # LAST (~= the minimum among backlogged tenants) — a tenant
        # waking from idle is clamped UP to it so idling never banks
        # device-time credit.  Deliberately NOT a running max: a max
        # would include the waking tenant's own past position, forcing
        # it to wait for the flooding tenant to catch up to a
        # historical high-water before being served at all (measured:
        # the isolation sweep's tenant B lost ~13% of its SLO window
        # to exactly that)
        self._vclock = 0.0       # dispatcher-thread-only
        self._swap_hold = self._swap_hold_n()
        # observability: per-tenant fairness gauges and the fleet
        # dispatch counter live in the obs.registry (what fleet_stats
        # events report), and the flight-recorder taps are installed so
        # a fleet post-mortem covers every tenant
        from ...obs.flight import get_flight
        from ...obs.registry import get_registry
        from ..metrics import next_engine_id
        get_flight()
        reg = get_registry()
        # eng label = this fleet's own generation id (same sequence as
        # the per-engine metrics): two FleetEngines in one process —
        # sequential bench legs, a rebuilt fleet after drain — must
        # never merge their dispatch counts or overwrite each other's
        # tenant vtime gauges
        self._fleet_eng = next_engine_id()
        self._g_vtime = reg.gauge(
            "ff_fleet_vtime_seconds",
            "Per-tenant virtual device time (used seconds / weight)",
            ("model", "eng"))
        self._c_dispatch = reg.counter(
            "ff_fleet_dispatches_total",
            "Fleet dispatcher packed dispatches across all tenants",
            ("eng",)).labels(eng=self._fleet_eng)
        self._c_shared = reg.counter(
            "ff_fleet_shared_dispatches_total",
            "Extra same-turn dispatches riding a digest-matched "
            "tenant's warm programs (share_identical)",
            ("eng",)).labels(eng=self._fleet_eng)
        self._last_autoscale_t = 0.0  # dispatcher-thread-only
        # per-tenant vtime gauge children, resolved once per tenant —
        # the dispatch loop must not re-run label validation + the
        # family lock per packed dispatch
        self._vtime_children: Dict = {}  # dispatcher-thread-only
        # tenant names whose vtime series the DISPATCHER must reclaim
        # (unload() queues them here: reclaiming from the caller
        # thread raced an in-flight dispatch, whose completion
        # re-created the just-removed series)
        self._vtime_reclaim: List[str] = []  # guarded_by: self._lock

    @staticmethod
    def _swap_hold_n() -> Optional[int]:
        for spec in faults.fleet_faults():
            if spec.kind == "fleet_swap_at_dispatch":
                return int(spec.arg)
        return None

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> "FleetEngine":
        """Build every registry tenant (synchronously — startup is the
        one place a stall is fine), publish them, and start the fleet
        dispatcher."""
        with self._lock:
            if self._stopped:
                raise RuntimeError("fleet was stopped; create a new "
                                   "FleetEngine")
            already = self._thread is not None
        if already:
            return self
        if self.registry is not None:
            for name in self.registry.names():
                if self.registry.spec(name).engine == "draft":
                    # draft entries are built BY the generation tenant
                    # that references them (inside its engine), never
                    # started as standalone tenants
                    continue
                if name not in self._tenants:  # unguarded-ok: pre-thread
                    t = self._build_tenant(self.registry.spec(name))
                    with self._lock:
                        self._tenants[name] = t
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._dispatch_loop, name="ff-fleet-dispatch",
                    daemon=True)
                self._thread.start()
        get_logger("serve").event(
            "fleet_start",
            tenants=sorted(self._tenants))  # unguarded-ok: startup log
        return self

    def stop(self) -> None:
        """Serve everything queued to completion, then stop (unbounded
        drain — see :meth:`drain` for the bounded verb)."""
        self.drain(timeout=None)

    def drain(self, timeout: Optional[float] = None) -> Dict:
        """Close every tenant's admission, flush the queues through the
        normal weighted-fair dispatch path, and after ``timeout``
        seconds fail the stragglers with SheddedError.  Returns the
        final per-tenant stats."""
        with self._lock:
            already = self._stopped or self._draining
            self._draining = True
            thread = self._thread
            tenants = list(self._tenants.values())
        if already and thread is None:
            return self.stats()
        for t in tenants:
            t.engine._batcher.close()
        self._wake.set()
        if thread is not None:
            thread.join(timeout)
        with self._lock:
            self._stopped = True
            self._thread = None
            tenants = (list(self._tenants.values())
                       + list(self._retiring))
            self._retiring = []
        shed = 0
        for t in tenants:
            # anything still queued/active past the budget is about to
            # be failed with SheddedError by the engines' own stop():
            # count it so the fleet_drain event reports real losses
            shed += t.engine._batcher.queue_depth
            if t.kind == "generation":
                shed += sum(1 for s in t.engine._slots_state
                            if s is not None)
                t.engine._abort_active()
            t.engine.stop()
        snap = self.stats()
        get_logger("serve").event("fleet_drain", timeout_s=timeout,
                                  shed=shed,
                                  dispatches=self._n_dispatch)
        return snap

    def __enter__(self) -> "FleetEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- tenant construction / publication -----------------------------
    def _build_tenant(self, spec: TenantSpec) -> _Tenant:
        model = build_model(spec, device=self.device)
        return self._make_tenant(spec, model)

    def _make_tenant(self, spec: TenantSpec, model) -> _Tenant:
        if spec.engine == "generation":
            gkw = dict(spec.generation)
            draft_name = str(gkw.pop("draft", ""))
            if draft_name:
                # the draft tenant compiles + initializes HERE, on the
                # same device — its params and draft KV pool live inside
                # this tenant's engine, which is exactly what the gate
                # charged onto this tenant's residency row
                gkw["draft_model"] = build_model(
                    self.registry.spec(draft_name), device=self.device)
            engine = GenerationEngine(
                model, name=spec.name, clock=self.clock,
                sleep=self._sleep, **gkw)
            engine.begin_external_dispatch()
        else:
            skw = dict(spec.serve)
            engine = ServingEngine(
                model, name=spec.name, clock=self.clock,
                sleep=self._sleep, **skw)
            engine.begin_external_dispatch()
        return _Tenant(spec.name, spec.engine, engine, spec.weight,
                       spec.qps_rows, self.clock())

    def add_engine(self, name: str, engine, weight: float = 1.0,
                   qps_rows: float = 0.0) -> None:
        """Attach an already-constructed engine (must not own a
        dispatcher thread) as a tenant — the programmatic alternative
        to a registry entry.  Published atomically at the next dispatch
        boundary (immediately when the fleet is not running)."""
        kind = ("generation" if isinstance(engine, GenerationEngine)
                else "dense")
        engine.begin_external_dispatch()
        t = _Tenant(name, kind, engine, weight, qps_rows, self.clock())
        self._publish(name, t)

    def load(self, name: str, spec: Optional[TenantSpec] = None,
             wait: bool = True, timeout: Optional[float] = 60.0):
        """Hot load/swap: build ``name`` (from ``spec`` or the
        registry) on a BACKGROUND thread — compile + bucket warmup off
        the serving path — then publish atomically at a dispatch
        boundary.  A swap (existing name) transfers the old engine's
        pending queue to the new one: zero failed in-flight requests.
        Returns the publish event once it landed (``wait=True``) or a
        ``threading.Event`` to wait on."""
        spec = spec or self.registry.spec(name)
        done = threading.Event()
        err: List[BaseException] = []

        def build():
            try:
                t = self._build_tenant(spec)
            except BaseException as e:  # noqa: BLE001 — a failed load
                # must surface as an event + error, never disturb the
                # serving tenants
                err.append(e)
                get_logger("serve").event(
                    "fleet_load_error", model=spec.name,
                    error=f"{type(e).__name__}: {e}"[:300])
                done.set()
                return
            if not self._publish(spec.name, t, on_published=done.set):
                # the fleet stopped while we were building: the
                # tenant was discarded — a wait=True caller must see
                # the failure, not a phantom success
                err.append(RuntimeError(
                    f"fleet stopped before the load of {spec.name!r} "
                    f"could publish"))
                done.set()

        threading.Thread(target=build, name=f"ff-fleet-load-{name}",
                         daemon=True).start()
        if wait:
            if not done.wait(timeout):
                raise TimeoutError(
                    f"fleet load of {name!r} did not publish within "
                    f"{timeout}s")
            if err:
                raise RuntimeError(
                    f"fleet load of {name!r} failed") from err[0]
        return done

    def _publish(self, name: str, tenant: _Tenant,
                 on_published: Optional[Callable] = None) -> bool:
        """Install/queue ``tenant`` under ``name``.  Returns False when
        the fleet already stopped and the tenant was DISCARDED — the
        caller must surface that as a failure, not a landed publish."""
        with self._lock:
            stopped = self._stopped
            running = self._thread is not None and not stopped
            if running:
                self._publishes.append((name, tenant, on_published))
            elif not stopped:
                self._apply_publish(name, tenant)  # guarded by lock
        if stopped:
            # a background load finishing after the fleet shut down:
            # discard loudly instead of installing a tenant nothing
            # will ever dispatch
            tenant.engine.stop()
            get_logger("serve").event("fleet_publish_discarded",
                                      model=name)
            return False
        if running:
            self._wake.set()
        elif on_published is not None:
            on_published()
        return True

    def _apply_publish(self, name, tenant):  # guarded_by: self._lock
        old = self._tenants.get(name)
        # route NEW submissions to the replacement first, then close
        # and drain the outgoing engine's queue into it: a submit
        # racing the swap either lands in the new queue or — in the
        # tiny window where it holds the old engine and hits the
        # closed batcher — fails fast as a typed admission refusal,
        # never as a lost in-flight request
        self._tenants[name] = tenant
        moved: List = []
        retiring = False
        if old is not None:
            # atomic swap: move the already-admitted queue onto the
            # replacement (admitted once = admitted; requeue bypasses
            # admission), carry the fairness clock so a swap is not a
            # priority boost, and retire the old engine with its
            # counters kept for reconciliation
            old.engine._batcher.close()
            moved = old.engine._batcher.fail_pending()
            if moved:
                tenant.engine._batcher.requeue(moved)
            tenant.vtime = old.vtime
            tenant.idle = False
            tenant.carried = dict(old.carried)
            tenant.retired = old.retired + [old.engine.metrics]
            while len(tenant.retired) > _MAX_RETIRED_METRICS:
                # fold the OLDEST retired generation into the static
                # carry and reclaim its registry series — by now its
                # transferred requests have long resolved, so the
                # fold loses nothing while bounding registry growth.
                # The folded counts MOVE into the tenant's eng="carry"
                # series (inc BEFORE removal — a scrape in the window
                # sees a brief double-count, never a backwards counter
                # that Prometheus rate() would read as a reset), so
                # the scraped per-model sums stay monotonic and equal
                # to fleet.stats()'s continuity numbers
                oldest = tenant.retired.pop(0)
                snap = oldest.snapshot()
                for key in _CONTINUITY_KEYS:
                    v = snap.get(key, 0)
                    tenant.carried[key] = (tenant.carried.get(key, 0)
                                           + v)
                    if v:
                        oldest._fams[key].labels(
                            model=oldest.model_tag,
                            eng="carry").inc(v)
                oldest.unregister()
            if old.kind == "generation" and old.engine.has_pending:
                # active decode slots cannot move (their KV state
                # lives in the old engine's cache): keep stepping the
                # old engine until every stream retires — the
                # dispatcher serves retiring tenants alongside live
                # ones, then _finalize_retiring stops them
                retiring = True
                self._retiring.append(old)
            else:
                old.engine.stop()
        get_logger("serve").event(
            "fleet_publish", model=name, swap=old is not None,
            moved_requests=len(moved), retiring_streams=retiring,
            tenants=sorted(self._tenants))

    def unload(self, name: str, timeout: Optional[float] = None) -> Dict:
        """Remove one tenant with ``drain`` semantics: close ITS
        admission, let the fleet dispatcher flush its queue (other
        tenants keep their fair share throughout), then fail
        stragglers after ``timeout`` and detach.  Returns the tenant's
        final stats."""
        with self._lock:
            t = self._tenants.get(name)
        if t is None:
            raise KeyError(f"no resident model {name!r}")
        t.engine._batcher.close()
        self._wake.set()
        deadline = (None if timeout is None
                    else self.clock() + timeout)
        while t.has_pending() or self._in_flight == name:
            if deadline is not None and self.clock() >= deadline:
                break
            self._sleep(0.002)
        with self._lock:
            self._tenants.pop(name, None)
        if t.kind == "generation":
            t.engine._abort_active()
        t.engine.stop()  # fails any stragglers with SheddedError
        snap = self._tenant_stats(t)
        # queue the unloaded tenant's fleet gauge series for the
        # DISPATCHER to reclaim at its next boundary (its own engine
        # series were released by stop()): removing it here raced the
        # tenant's possibly-still-in-flight last dispatch, which would
        # re-create — and permanently resurrect — the stale series
        with self._lock:
            self._vtime_reclaim.append(name)
        if self.autoscaler is not None:
            self.autoscaler.forget(name)
        self._wake.set()
        get_logger("serve").event("fleet_unload", model=name,
                                  pending_failed=int(t.has_pending()))
        return snap

    # ---- producer side -------------------------------------------------
    def _tenant(self, name: str) -> _Tenant:
        with self._lock:
            t = self._tenants.get(name)
        if t is None:
            raise KeyError(f"no resident model {name!r} (have "
                           f"{', '.join(sorted(self.names()))})")
        return t

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def submit(self, name: str, *args, **kw):
        """Route one request to tenant ``name``: dense tenants take the
        per-input row arrays and return a Future; generation tenants
        take a prompt and return a GenerationStream.  Admission
        (bounded queue, deadlines, priorities) is the tenant's own
        engine's, unchanged."""
        t = self._tenant(name)
        out = t.engine.submit(*args, **kw)
        self._wake.set()
        return out

    def _tenant_stats(self, t: _Tenant) -> Dict:
        snap = t.engine.stats()
        # counter continuity across hot swaps: a tenant's lifetime
        # counters are the sum over every engine generation that
        # served under its name — read LIVE from the retired metrics
        # (see _Tenant.retired) so the submitted == outcomes reconciliation
        # holds even for requests that resolved after their swap
        for key, v in t.carried.items():
            if key in snap:
                snap[key] += v
        for m in t.retired:
            old = m.snapshot()
            for key in _CONTINUITY_KEYS:
                if key in snap and key in old:
                    snap[key] += old[key]
        snap.update({"weight": t.weight, "qps_rows_budget": t.qps_rows,
                     "vtime_s": round(t.vtime, 6),
                     "engine_generation": len(t.retired),
                     "resident_bytes": t.resident_bytes()})
        return snap

    def stats(self, name: Optional[str] = None) -> Dict:
        """Per-tenant stats (counters continuous across swaps), or one
        tenant's when ``name`` is given."""
        if name is not None:
            return self._tenant_stats(self._tenant(name))
        with self._lock:
            tenants = dict(self._tenants)
        return {"tenants": {n: self._tenant_stats(t)
                            for n, t in sorted(tenants.items())},
                "dispatches": self._n_dispatch}

    # ---- fleet dispatcher ----------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            served = self._dispatch_turn()
            if served is None:
                with self._lock:
                    draining = self._draining
                    tenants = (list(self._tenants.values())
                               + list(self._retiring))
                    pending_pub = bool(self._publishes)
                if (draining and not pending_pub
                        and not any(x.has_pending() for x in tenants)):
                    return
                self._wake.wait(self._IDLE_WAIT_S)
                self._wake.clear()
                continue
            if self.pace_s > 0:
                self._sleep(self.pace_s)

    def _dispatch_turn(self) -> Optional[_Tenant]:
        """One dispatcher turn: apply publishes, then serve the tenant
        of lowest virtual time that has a due dispatch, and charge it.
        Returns the served tenant, or None when nothing was due."""
        self._do_publishes()
        self._do_vtime_reclaims()
        self._finalize_retiring()
        self._maybe_autoscale()
        with self._lock:
            tenants = (list(self._tenants.values())
                       + list(self._retiring))
        order = self._pick_order(tenants)
        for i, t in enumerate(order):
            rows0 = t.engine.metrics.total_rows
            # a tenant may be backlogged but not DUE (its micro-batcher
            # is inside its coalescing window): dispatch_pending returns
            # None, and the next-lowest virtual time is tried instead
            self._in_flight = t.name
            dt = t.engine.dispatch_pending()
            self._in_flight = None
            if dt is None:
                continue
            self._account_dispatch(t, dt, rows0)
            rest = order[i + 1:]
            if self.share_identical and rest:
                self._share_turn(t, rest)
            self._maybe_emit_stats()
            return t
        return None

    def _account_dispatch(self, t: _Tenant, dt: float,
                          rows0: int) -> None:
        """Charge one completed dispatch to its tenant's fairness
        state + the registry surfaces (dispatcher thread)."""
        self._n_dispatch += 1
        self._c_dispatch.inc()
        with self._lock:
            t.vtime += dt / t.weight
            if t.qps_rows > 0:
                t.allowance -= (t.engine.metrics.total_rows - rows0)
        self._vclock = t.vtime
        # the registry's view of the fairness state fleet_stats
        # reports — same number, two surfaces
        child = self._vtime_children.get(t.name)
        if child is None:
            child = self._g_vtime.labels(model=t.name,
                                         eng=self._fleet_eng)
            self._vtime_children[t.name] = child
        child.set(t.vtime)

    @staticmethod
    def _digest_of(t: _Tenant) -> Optional[str]:
        """The graph digest two checkpoints of one graph share: op kinds,
        names, output and weight shapes, and the compute dtype."""
        model = t.engine.model
        parts = [str(model.config.compute_dtype)]
        for op in model.layers:
            parts.append(repr((op.op_type.value, op.name,
                               [tuple(o.shape) for o in op.outputs],
                               [tuple(w.shape) for w in op.weights])))
        return hashlib.sha256("\n".join(parts).encode()).hexdigest()

    def _share_turn(self, primary: _Tenant,
                    rest: List[_Tenant]) -> None:
        """Cross-tenant dispatch sharing: serve every OTHER due tenant
        whose graph digest matches the primary's in the SAME dispatcher
        turn (two checkpoints of one graph), instead of waiting a full
        SFQ rotation.  Each extra dispatch is accounted exactly like a
        primary one (vtime, qps bucket, counters) — sharing a turn is
        a latency optimization, never a fairness subsidy."""
        digest = self._digest_of(primary)
        if digest is None:
            return
        for u in rest:
            if u.kind != primary.kind:
                continue
            if self._digest_of(u) != digest:
                continue
            rows0 = u.engine.metrics.total_rows
            self._in_flight = u.name
            du = u.engine.dispatch_pending()
            self._in_flight = None
            if du is None:
                continue
            self._account_dispatch(u, du, rows0)
            self._c_shared.inc()

    def _maybe_autoscale(self) -> None:
        """Feed the autoscaling policy each tenant's queue depth and
        apply any weight change it returns (dispatcher thread — the
        policy itself is single-threaded by construction)."""
        scaler = self.autoscaler
        if scaler is None:
            return
        now = self.clock()
        with self._lock:
            live = list(self._tenants.values())
        for t in live:
            depth = t.engine._batcher.queue_depth
            new = scaler.observe(t.name, depth, t.weight, now)
            if new is None:
                continue
            with self._lock:
                old, t.weight = t.weight, new
            get_logger("serve").event(
                "fleet_autoscale", model=t.name,
                old_weight=round(old, 4), new_weight=round(new, 4),
                depth=depth)

    def _pick_order(self, tenants: List[_Tenant]) -> List[_Tenant]:
        """Start-time fair queuing: backlogged, within-budget tenants
        in ascending virtual-time order (the dispatcher serves the
        first one with a DUE batch).  A tenant re-entering from idle is
        clamped UP to the global virtual clock (``_vclock``) so idling
        never banks device-time credit — low weight means a smaller
        share while backlogged, never a catch-up monopoly afterwards."""
        now = self.clock()
        ready = []
        for t in tenants:
            t.refill(now)
            if not t.has_pending():
                t.idle = True
                continue
            if t.idle:
                t.vtime = max(t.vtime, self._vclock)
                t.idle = False
            if t.within_budget():
                ready.append(t)
        ready.sort(key=lambda t: (t.vtime, t.name))
        return ready

    def _do_vtime_reclaims(self) -> None:
        """Drop unloaded tenants' vtime gauge series (dispatcher
        thread — after this point no dispatch can re-create them: the
        tenant left ``_tenants`` before its name was queued here)."""
        with self._lock:
            if not self._vtime_reclaim:
                return
            names, self._vtime_reclaim = self._vtime_reclaim, []
        for name in names:
            self._vtime_children.pop(name, None)
            self._g_vtime.remove(model=name, eng=self._fleet_eng)

    def _finalize_retiring(self) -> None:
        """Stop swapped-out generation engines whose last active
        stream has retired (dispatcher thread)."""
        with self._lock:
            done = [t for t in self._retiring if not t.has_pending()]
            if not done:
                return
            self._retiring = [t for t in self._retiring
                              if t.has_pending()]
        for t in done:
            t.engine.stop()
            get_logger("serve").event("fleet_retired", model=t.name)

    def _do_publishes(self) -> None:
        """Apply queued atomic publishes at the dispatch boundary.
        Under ``fleet_swap_at_dispatch:N`` they are HELD until fleet
        dispatch index N (deterministic swap timing for tests)."""
        with self._lock:
            if not self._publishes:
                return
            if (self._swap_hold is not None
                    and self._n_dispatch < self._swap_hold
                    and not self._draining):
                # held for the fault's pinned dispatch index — but a
                # drain overrides the hold, or shutdown would wait on
                # a dispatch that will never happen
                return
            pubs, self._publishes = self._publishes, []
            for name, tenant, cb in pubs:
                self._apply_publish(name, tenant)
        for _, _, cb in pubs:
            if cb is not None:
                cb()

    def _maybe_emit_stats(self) -> None:
        now = self.clock()
        if self.stats_every_s <= 0:
            return
        if now - self._last_stats_t < self.stats_every_s:
            return
        self._last_stats_t = now
        with self._lock:
            shares = {t.name: round(t.vtime, 4)
                      for t in self._tenants.values()}
        get_logger("serve").event(
            "fleet_stats", dispatches=self._n_dispatch, vtime=shares)


__all__ = ["FleetEngine"]
