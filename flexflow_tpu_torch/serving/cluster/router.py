"""FleetRouter — disaggregated prefill/decode serving across fleet hosts,
the port of ``flexflow_tpu/serving/cluster/router.py``.

* each **host** is one started :class:`~..fleet.FleetEngine` (its own
  dispatcher thread), tagged ``prefill`` | ``decode`` | ``mixed``;
* ``submit(model, prompt)`` routes to the least-loaded healthy
  prefill/mixed host.  Load is scraped off the event stream: the router
  taps :mod:`~...fflogger` and keys the freshest ``gen_stats`` /
  ``serve_stats`` record by its ``eng`` field, floored by a live read of
  the queue depth;
* generation submissions carry a **handoff**: at prefill completion the
  source engine exports the stream's KV page chain (one device-to-host
  copy, ``pages.export_pages``) and offers it here; the router picks the
  best decode-role host at that instant, puts the pages on that engine's
  device in one copy (``pages.pages_to_device``, complete before the
  payload is queued) and queues the payload on its tenant engine
  (``adopt_migrated``); that engine's own dispatch thread imports it.
  True: the stream decodes on an engine that dispatches nothing but
  decode steps; False or a raise: the source decodes it, with one
  ``serve_health`` fallback event, and no stream fails;
* ``mark_down(host)`` (or ``FF_FAULT=route_host_down:<name>``) drains the
  host's queued requests to survivors (``fail_pending`` then
  ``requeue``), lets in-flight streams finish where they run, and
  excludes the host from routes and migrations.
  ``FF_FAULT=migrate_fail_at:N`` makes the Nth handoff raise once.

Observability: one ``route`` span per sampled stream, the
``ff_router_*`` registry families (migrations by status, migrated bytes,
queue depth by role) and ``router_*`` events.  ``clock`` is injectable;
the router owns no threads.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ... import faults, fflogger
from ...fflogger import get_logger
from ...obs import lockwatch
from ..fleet.engine import FleetEngine
from ..fleet.registry import TENANT_ROLES
from ..generation.pages import pages_to_device


class _Host:
    """Router-side state of one fleet host."""

    __slots__ = ("name", "fleet", "role", "down")

    def __init__(self, name: str, fleet: FleetEngine, role: str):
        self.name = name
        self.fleet = fleet
        self.role = role
        self.down = False


class FleetRouter:
    """Route requests across role-tagged fleet hosts, migrating KV
    pages from prefill to decode engines at prefill completion.

    ::

        router = FleetRouter()
        router.add_host("pf0", prefill_fleet, role="prefill")
        router.add_host("dc0", decode_fleet, role="decode")
        with router:                       # installs the stats tap
            stream = router.submit("chat", prompt_ids)
            for tok in stream:
                ...

    The router never starts or stops the fleets — hosts arrive started
    and outlive the router (``stop()`` only detaches the scrape tap).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._lock = lockwatch.lock("FleetRouter._lock")
        self._hosts: Dict[str, _Host] = {}  # guarded_by: self._lock
        self._started = False               # guarded_by: self._lock
        # freshest gen_stats/serve_stats record per engine generation
        # (eng id): written by the fflogger tap thread(s), read by
        # routing — whole-record replacement, so no lock is needed
        # (CPython dict item assignment is atomic)
        self._scrape: Dict[str, Dict] = {}
        self._n_routes = 0                  # guarded_by: self._lock
        self._n_migrations = 0              # guarded_by: self._lock
        self._migrated_bytes = 0            # guarded_by: self._lock
        # FF_FAULT state (faults.router_faults, materialized at
        # start()): the Nth migration handoff raises; a named host is
        # marked down at the first routing decision.  Both fire once.
        self._fault_migrate_n: Optional[int] = None
        self._fault_down_host: Optional[str] = None
        self._migrate_attempts = 0          # guarded_by: self._lock
        self._migrate_ms_total = 0.0        # guarded_by: self._lock
        self._fault_fired = {"migrate": False,
                             "down": False}  # guarded_by: self._lock
        from ...obs.registry import get_registry
        from ..metrics import next_engine_id
        reg = get_registry()
        self._eng = next_engine_id()
        self._c_migrations = reg.counter(
            "ff_router_migrations_total",
            "KV page-chain migrations by outcome "
            "(ok/declined/error)", ("eng", "status"))
        self._c_bytes = reg.counter(
            "ff_router_migrated_bytes_total",
            "Host bytes of KV pages shipped prefill -> decode",
            ("eng",)).labels(eng=self._eng)
        self._g_depth = reg.gauge(
            "ff_router_queue_depth",
            "Summed tenant queue depth per host role", ("eng", "role"))

    # ---- lifecycle -----------------------------------------------------
    def add_host(self, name: str, fleet: FleetEngine,
                 role: str = "mixed") -> None:
        """Attach one STARTED fleet as a routable host."""
        if role not in TENANT_ROLES:
            raise ValueError(f"host {name!r}: role must be one of "
                             f"{TENANT_ROLES}, got {role!r}")
        with self._lock:
            if name in self._hosts:
                raise ValueError(f"duplicate host {name!r}")
            self._hosts[name] = _Host(name, fleet, role)

    def start(self) -> "FleetRouter":
        with self._lock:
            if self._started:
                return self
            self._started = True
            hosts = {h.name: h.role for h in self._hosts.values()}
        for spec in faults.router_faults():
            if spec.kind == "migrate_fail_at":
                self._fault_migrate_n = int(spec.arg)
            elif spec.kind == "route_host_down":
                self._fault_down_host = str(spec.arg)
        fflogger.add_tap(self._tap)
        get_logger("serve").event("router_start", hosts=hosts)
        return self

    def stop(self) -> None:
        with self._lock:
            if not self._started:
                return
            self._started = False
            routes, migs = self._n_routes, self._n_migrations
        fflogger.remove_tap(self._tap)
        get_logger("serve").event("router_stop", routes=routes,
                                  migrations=migs)

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- load scrape ---------------------------------------------------
    def _tap(self, rec: Dict) -> None:
        if rec.get("event") not in ("gen_stats", "serve_stats"):
            return
        eng = str(rec.get("eng", ""))
        if eng:
            self._scrape[eng] = rec

    def _score(self, host: _Host, model: str) -> Optional[float]:
        """Load of ``model``'s tenant on ``host`` (lower = better), or
        None when the host does not serve the model.  The scraped
        stats record (keyed by the tenant engine's ``eng`` id) is the
        primary signal; the live queue depth floors it so a burst
        between emissions is never invisible, and active decode slots
        count toward load so a slot-full decode host yields to an
        emptier one."""
        try:
            t = host.fleet._tenant(model)
        except KeyError:
            return None
        eng = t.engine
        depth = float(eng._batcher.queue_depth)
        rec = self._scrape.get(str(getattr(eng.metrics, "eng_id", "")))
        if rec is not None:
            depth = max(depth, float(rec.get("queue_depth") or 0.0))
        slots = getattr(eng, "_slots_state", None)
        active = (sum(1 for s in slots if s is not None)
                  if slots is not None else 0)
        return depth + active

    def _pick(self, model: str, roles, exclude: str = ""
              ) -> Optional[_Host]:
        with self._lock:
            hosts = [h for h in self._hosts.values()
                     if not h.down and h.name != exclude]
        best, best_score = None, None
        for role in roles:  # earlier role wins ties across tiers
            for h in sorted((h for h in hosts if h.role == role),
                            key=lambda h: h.name):
                s = self._score(h, model)
                if s is None:
                    continue
                if best_score is None or s < best_score:
                    best, best_score = h, s
            if best is not None:
                return best
        return best

    # ---- routing -------------------------------------------------------
    def submit(self, model: str, *args, **kw):
        """Route one request for tenant ``model``: generation prompts
        return a GenerationStream (carrying the migration handoff when
        a decode target exists), dense rows a Future."""
        self._maybe_fire_host_down()
        src = self._pick(model, ("prefill", "mixed"))
        if src is None:
            with self._lock:
                have = sorted(self._hosts)
            raise KeyError(
                f"no healthy prefill/mixed host serves {model!r} "
                f"(hosts: {have})")
        t0 = self.clock()
        tenant = src.fleet._tenant(model)
        if (tenant.kind == "generation"
                and self._pick(model, ("decode", "mixed"),
                               exclude=src.name) is not None):
            kw.setdefault("handoff",
                          self._make_handoff(model, src.name))
        out = src.fleet.submit(model, *args, **kw)
        with self._lock:
            self._n_routes += 1
        self._route_span(tenant.engine, out, src, model, t0)
        self._update_depth_gauges()
        return out

    def _route_span(self, engine, out, src: _Host, model: str,
                    t0: float) -> None:
        """One ``route`` span per sampled stream — the routing leg of
        the request timeline, so span counts reconcile with the
        engines' terminal ``request`` spans exactly."""
        tracer = getattr(engine, "_tracer", None)
        trace = getattr(out, "trace", None)
        if tracer is None or not tracer.active or trace is None:
            return
        tracer.span("route", trace, t0, self.clock(), tid="router",
                    host=src.name, role=src.role, model=model)

    def _make_handoff(self, model: str, src_name: str) -> Callable:
        def handoff(payload: Dict) -> bool:
            with self._lock:
                self._migrate_attempts += 1
                attempt = self._migrate_attempts
                fire = (self._fault_migrate_n is not None
                        and attempt == self._fault_migrate_n
                        and not self._fault_fired["migrate"])
                if fire:
                    self._fault_fired["migrate"] = True
            if fire:
                raise RuntimeError(
                    f"FF_FAULT: injected migration failure at "
                    f"attempt {attempt}")
            h0 = time.perf_counter()
            dst = self._pick(model, ("decode", "mixed"),
                             exclude=src_name)
            if dst is None:
                self._c_migrations.labels(
                    eng=self._eng, status="declined").inc()
                return False
            try:
                tenant = dst.fleet._tenant(model)
                dev = getattr(tenant.engine, "device", None)
                if dev is not None:
                    # put the page bytes on the DESTINATION device from
                    # here (the source engine's thread), complete before
                    # the payload is queued: the decode host's import
                    # then only scatters resident rows
                    payload = dict(payload,
                                   pages=pages_to_device(
                                       payload["pages"], dev))
                adopted = bool(tenant.engine.adopt_migrated(payload))
            except Exception:
                self._c_migrations.labels(
                    eng=self._eng, status="error").inc()
                raise
            if not adopted:
                self._c_migrations.labels(
                    eng=self._eng, status="declined").inc()
                return False
            dst.fleet._wake.set()
            with self._lock:
                self._n_migrations += 1
                self._migrated_bytes += int(payload.get("nbytes", 0))
                self._migrate_ms_total += (time.perf_counter()
                                           - h0) * 1e3
            self._c_migrations.labels(eng=self._eng,
                                      status="ok").inc()
            self._c_bytes.inc(int(payload.get("nbytes", 0)))
            return True

        return handoff

    # ---- health --------------------------------------------------------
    def _maybe_fire_host_down(self) -> None:
        with self._lock:
            name = self._fault_down_host
            fire = (name is not None and name in self._hosts
                    and not self._fault_fired["down"])
            if fire:
                self._fault_fired["down"] = True
        if fire:
            self.mark_down(name)

    def mark_down(self, name: str) -> Dict[str, int]:
        """Mark one host down: no new routes or migrations target it,
        its tenants' QUEUED requests drain to surviving hosts (requeue
        — admitted work is never re-judged, zero streams fail), and
        in-flight work finishes where it runs (the host's own
        dispatcher keeps stepping it).  Returns ``{model: moved}``."""
        with self._lock:
            host = self._hosts.get(name)
            if host is None:
                raise KeyError(f"no host {name!r}")
            host.down = True
        moved: Dict[str, int] = {}
        for model in host.fleet.names():
            try:
                tenant = host.fleet._tenant(model)
            except KeyError:
                continue  # unloaded while we walked
            reqs = tenant.engine._batcher.fail_pending()
            if not reqs:
                continue
            dst = self._pick(model, ("prefill", "mixed", "decode"))
            if dst is None:
                # nowhere to drain to: give the queue back — the
                # downed host still serves what it already admitted
                tenant.engine._batcher.requeue(reqs)
                continue
            dst.fleet._tenant(model).engine._batcher.requeue(reqs)
            dst.fleet._wake.set()
            moved[model] = len(reqs)
        host.fleet._wake.set()
        get_logger("serve").event("router_host_down", host=name,
                                  moved=moved)
        return moved

    # ---- reporting -----------------------------------------------------
    def _update_depth_gauges(self) -> None:
        with self._lock:
            hosts = list(self._hosts.values())
        depth_by_role = {r: 0.0 for r in TENANT_ROLES}
        for h in hosts:
            for model in h.fleet.names():
                try:
                    t = h.fleet._tenant(model)
                except KeyError:
                    continue
                depth_by_role[h.role] += t.engine._batcher.queue_depth
        for role, d in depth_by_role.items():
            self._g_depth.labels(eng=self._eng, role=role).set(d)

    def stats(self) -> Dict:
        with self._lock:
            hosts = list(self._hosts.values())
            out = {
                "routes": self._n_routes,
                "migrations": self._n_migrations,
                "migrated_bytes": self._migrated_bytes,
                "migrate_attempts": self._migrate_attempts,
                "migrate_ms_total": round(self._migrate_ms_total, 3),
            }
        out["hosts"] = {
            h.name: {"role": h.role, "down": h.down,
                     "models": h.fleet.names()}
            for h in hosts}
        return out


__all__ = ["FleetRouter"]
