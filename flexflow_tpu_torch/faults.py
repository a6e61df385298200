"""Deterministic fault injection, the port of ``flexflow_tpu/faults.py``.

A fault plan is described in the ``FF_FAULT`` environment variable; the
train loop (``FFModel.train_batch``/``train_window``/``fit``), the
checkpoint writer (``FFModel.save_checkpoint``), the elastic supervisor
(``parallel.elastic.run_elastic``), the serving engines, the generation
engine, the model fleet and the cluster router each consult it at
well-defined points.  With ``FF_FAULT`` unset every hook is a cached
``None``-check.

``grow_at_step``/``shrink_at_step`` are consumed at the window edge by
``FFModel``: a target equal to the world size reshards in process; any
other size goes through the supervisor (the ranks save the step's
elastic checkpoint and exit with ``parallel.elastic.RESIZE_EXIT_CODE``,
and ``run_elastic`` relaunches the requested world, which reshards on
resume), since the port's process group has one size for its life.

Grammar (specs joined by ``;``, qualifiers by ``,``)::

    FF_FAULT = spec (";" spec)*
    spec     = kind ":" arg ("," key "=" value)*

    kill_at_step:N        exit hard (os._exit, code 17) after step N completes
    hang_at_step:N        stop making progress after step N (sleep forever —
                          detected by the supervisor's heartbeat monitor)
                          (under fused multi-step dispatch, FFConfig.
                          steps_per_dispatch > 1, both indices round UP to
                          the next window edge)
    corrupt_ckpt:N        truncate the checkpoint published at step N
    corrupt_ckpt:latest   truncate every checkpoint this process publishes
    spawn_fail_attempt:A  supervisor-side: fail attempt A at spawn time
    slow_rank:R           rank R sleeps ``delay`` (default 0.25 s) per step
    grow_at_step:N        request an in-process mesh GROW after step N
    shrink_at_step:N      request an in-process mesh SHRINK after step N
                          (both consumed by the train loop via
                          ``FFModel.reshard()``;
                          same window-edge rounding as kill/hang; target
                          device count via ``devices=D``, default 2x /
                          half the current mesh)

    serving kinds (consumed by ServingEngine's dispatcher before each
    packed dispatch — :func:`serve_faults`; docs/serving.md "Overload,
    SLOs & degradation"):

    serve_slow_dispatch:N   the first N dispatches each stall ``ms``
                            milliseconds (default 50) through the
                            engine's injectable sleep — deterministic
                            overload without a slow model
    serve_fail_dispatch:N   inject N dispatch failures (RuntimeError on
                            the normal dispatch-error path: the batch's
                            futures fail, serving continues); ``every=K``
                            spaces them every K-th dispatch (default 1 —
                            the first N dispatches fail)
    serve_queue_spike:N     at dispatch index N, push ``rows`` rows
                            (default 4x max_batch) of synthetic load
                            through the real admission path — the
                            bounded-queue/shedding behavior under a
                            burst is the thing being tested

    token-generation kinds (consumed by GenerationEngine's decode loop
    — :func:`generation_faults`; docs/serving.md "Token generation"):

    serve_cancel_at_token:N the FIRST stream to reach N generated
                            tokens is cancelled mid-generation — its
                            KV slot must free and ONLY its own stream
                            fail (fires once)
    serve_slow_decode:N     the first N decode steps each stall ``ms``
                            milliseconds (default 50) through the
                            engine's injectable sleep
    spec_draft_fail:N       the Nth speculative DRAFT dispatch raises
                            (fires once) — the engine must demote to
                            plain decode (serve_health fallback event)
                            with NO stream failing

    model-fleet kinds (consumed by the FleetEngine — :func:`
    fleet_faults`; docs/serving.md "Model fleets"):

    fleet_load_fail:NAME    the registry build of model NAME fails
                            (RuntimeError before compile) — a failed
                            background load/swap must surface a
                            fleet_load_error event and leave every
                            serving tenant untouched.  The arg is the
                            MODEL NAME, not a step index.
    fleet_swap_at_dispatch:N a prepared publish (hot load/swap) is
                            HELD until fleet dispatch index N — pins
                            the dispatch boundary where an atomic
                            swap lands, so swap-under-load tests are
                            deterministic

    router kinds (consumed by the cluster FleetRouter —
    :func:`router_faults`; docs/serving.md "Disaggregated
    prefill/decode"):

    migrate_fail_at:N       the Nth KV page migration handoff raises
                            (fires once) — the source engine must fall
                            back to CO-LOCATED decode (one serve_health
                            fallback event) with NO stream failing
    route_host_down:NAME    host NAME is marked down at the router's
                            first routing decision — its tenants'
                            queued requests drain to surviving hosts
                            (requeue, never re-judged), in-flight
                            streams finish where they run, and no new
                            route/migration targets it.  The arg is the
                            HOST NAME, not a step index.

    qualifiers: rank=R (fire only on rank R), attempt=A or attempt=*
                (default attempt=0 — faults must not re-fire on the
                restarted attempt or recovery could never be observed),
                delay=SECONDS (slow_rank), exit=CODE (kill_at_step),
                devices=D (grow_at_step/shrink_at_step target),
                ms=MILLIS (serve_slow_dispatch, serve_slow_decode),
                every=K (serve_fail_dispatch), rows=R
                (serve_queue_spike)

Examples::

    FF_FAULT="kill_at_step:7,rank=1"
    FF_FAULT="corrupt_ckpt:4;kill_at_step:5,rank=1"
    FF_FAULT="hang_at_step:5,rank=0,attempt=0"

Rank resolution: :func:`set_rank` when a worker called it, else
``torch.distributed.get_rank()`` when a process group is initialised,
else unknown.  A rank-qualified spec never fires when the rank is
unknown.  The attempt comes from ``FF_ELASTIC_ATTEMPT``.  Stdlib only.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional

# exit code for an injected kill — distinguishable from real crashes in
# AttemptResult.returncodes
KILL_EXIT_CODE = 17

KINDS = ("kill_at_step", "hang_at_step", "corrupt_ckpt",
         "spawn_fail_attempt", "slow_rank", "grow_at_step",
         "shrink_at_step", "serve_slow_dispatch", "serve_fail_dispatch",
         "serve_queue_spike", "serve_cancel_at_token",
         "serve_slow_decode", "spec_draft_fail", "fleet_load_fail",
         "fleet_swap_at_dispatch", "migrate_fail_at",
         "route_host_down")

SERVE_KINDS = ("serve_slow_dispatch", "serve_fail_dispatch",
               "serve_queue_spike")

# token-generation kinds (GenerationEngine's decode loop —
# docs/serving.md "Token generation"); disjoint from SERVE_KINDS so a
# plan mixing both drives each engine's own fire points only
GENERATION_KINDS = ("serve_cancel_at_token", "serve_slow_decode",
                    "spec_draft_fail")

# model-fleet kinds (FleetEngine / fleet registry — docs/serving.md
# "Model fleets"); disjoint from both sets above
FLEET_KINDS = ("fleet_load_fail", "fleet_swap_at_dispatch")

# disaggregated-serving router kinds (cluster.FleetRouter —
# docs/serving.md "Disaggregated prefill/decode"); disjoint from every
# set above so a plan mixing engine families drives each one's own
# fire points only
ROUTER_KINDS = ("migrate_fail_at", "route_host_down")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    arg: str
    rank: Optional[int]      # None: any rank
    attempt: Optional[int]   # None: any attempt
    extras: Dict[str, str] = dataclasses.field(default_factory=dict)


def parse_faults(text: Optional[str]) -> List[FaultSpec]:
    """Parse an ``FF_FAULT`` value.  Malformed specs and unknown kinds
    raise ValueError loudly — a typo that silently injects nothing would
    make a fault test vacuously green."""
    specs: List[FaultSpec] = []
    for raw in (text or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        head, _, qual = raw.partition(",")
        kind, sep, arg = head.partition(":")
        kind, arg = kind.strip(), arg.strip()
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in FF_FAULT spec {raw!r} "
                f"(known: {', '.join(KINDS)})")
        if not sep or not arg:
            raise ValueError(f"fault spec {raw!r} is missing ':<arg>'")
        rank: Optional[int] = None
        # default attempt 0: a fault that re-fired on the restarted
        # attempt would defeat every recovery test
        attempt: Optional[int] = 0
        extras: Dict[str, str] = {}
        for kv in qual.split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, sep2, val = kv.partition("=")
            if not sep2:
                raise ValueError(
                    f"fault qualifier {kv!r} in {raw!r} is not key=value")
            key, val = key.strip(), val.strip()
            if key == "rank":
                rank = int(val)
            elif key == "attempt":
                attempt = None if val == "*" else int(val)
            elif key in ("delay", "exit", "devices", "ms", "every",
                         "rows"):
                # validate now, fail at parse not at fire — with the
                # type actually used at fire time (exit=9.5 must not
                # blow up inside the train loop)
                (float if key in ("delay", "ms") else int)(val)
                if key in ("devices", "every", "rows") and int(val) < 1:
                    raise ValueError(
                        f"{key} qualifier must be >= 1, got {val!r} "
                        f"in {raw!r}")
                if key == "ms" and float(val) < 0:
                    # a negative stall would turn serve_slow_dispatch
                    # into dispatch FAILURES at fire time (sleep raises)
                    raise ValueError(
                        f"ms qualifier must be >= 0, got {val!r} "
                        f"in {raw!r}")
                extras[key] = val
            else:
                raise ValueError(
                    f"unknown fault qualifier {key!r} in {raw!r}")
        # validate the arg NOW (same policy as delay/exit above): a typo
        # like corrupt_ckpt:latst must fail at parse, not silently
        # inject nothing — or blow up mid-training at fire time
        if kind == "corrupt_ckpt":
            if arg != "latest" and not arg.isdigit():
                raise ValueError(
                    f"corrupt_ckpt arg must be a step number or "
                    f"'latest', got {arg!r} in {raw!r}")
        elif kind in ("fleet_load_fail", "route_host_down"):
            pass  # the arg IS a model/host name — any non-empty string
        elif not (arg.isdigit() or (arg[:1] == "-" and arg[1:].isdigit())):
            raise ValueError(
                f"{kind} arg must be an integer, got {arg!r} in {raw!r}")
        if kind == "spawn_fail_attempt":
            attempt = int(arg)  # the arg IS the attempt
        specs.append(FaultSpec(kind, arg, rank, attempt, extras))
    return specs


# ----------------------------------------------------------------------
# process-local plan (parsed once; reset() for in-process tests)
# ----------------------------------------------------------------------
_UNSET = object()
_plan = _UNSET
_rank: Optional[int] = None


def plan() -> Optional[List[FaultSpec]]:
    """The cached fault plan from ``FF_FAULT``, or None when unset."""
    global _plan
    if _plan is _UNSET:
        text = os.environ.get("FF_FAULT")
        _plan = parse_faults(text) if text else None
    return _plan  # type: ignore[return-value]


def reset() -> None:
    """Drop the cached plan and rank (tests mutate the environment)."""
    global _plan, _rank
    _plan = _UNSET
    _rank = None


def set_rank(rank: int) -> None:
    """Register this process's rank (workers call it at startup)."""
    global _rank
    _rank = int(rank)


def current_rank() -> Optional[int]:
    if _rank is not None:
        return _rank
    dist = sys.modules.get("torch.distributed")
    if dist is None:  # never trigger the import
        return None
    try:
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 — an unusable group: rank unknown
        return None
    return None


def current_attempt() -> int:
    return int(os.environ.get("FF_ELASTIC_ATTEMPT", "0"))


def _matches(spec: FaultSpec) -> bool:
    if spec.attempt is not None and spec.attempt != current_attempt():
        return False
    if spec.rank is not None:
        r = current_rank()
        if r is None or r != spec.rank:
            return False
    return True


def _note(msg: str) -> None:
    # stderr lands in the supervisor's per-rank log tail
    print(f"FF_FAULT: {msg}", file=sys.stderr, flush=True)


# ----------------------------------------------------------------------
# fire points of the train loop and the supervisor
# ----------------------------------------------------------------------
def on_step(step: int) -> None:
    """Train-loop hook: call after step ``step`` completes.  May sleep
    (slow_rank), stop progressing (hang_at_step) or kill the process
    (kill_at_step).  No-op without an active plan."""
    on_window(step - 1, step)


def on_window(start: int, end: int) -> None:
    """Window-granularity train-loop hook: call after the window of
    steps ``(start, end]`` completes (``FFConfig.steps_per_dispatch``).

    * ``kill_at_step:N`` / ``hang_at_step:N`` with ``start < N <= end``
      fire at the WINDOW EDGE — the step index rounds up to ``end``;
    * ``slow_rank`` sleeps ``delay`` once per covered step (``end -
      start`` times), preserving the per-step straggler budget.

    ``on_step(step)`` is exactly ``on_window(step - 1, step)``.
    No-op without an active plan."""
    p = plan()
    if not p:
        return
    for spec in p:
        if not _matches(spec):
            continue
        if spec.kind == "slow_rank":
            r = current_rank()
            if r is not None and r == int(spec.arg):
                time.sleep(float(spec.extras.get("delay", "0.25"))
                           * max(1, end - start))
        elif spec.kind == "hang_at_step" and start < int(spec.arg) <= end:
            _note(_edge_note("hang", spec, end))
            while True:  # no progress, no exit: only heartbeat monitoring
                time.sleep(3600)  # (or the attempt timeout) can end this
        elif spec.kind == "kill_at_step" and start < int(spec.arg) <= end:
            code = int(spec.extras.get("exit", str(KILL_EXIT_CODE)))
            _note(_edge_note("kill", spec, end, f"exit {code}"))
            os._exit(code)  # hard crash: no cleanup, no excepthook


def _edge_note(what: str, spec, end: int, extra: str = "") -> str:
    """One message format for every window-edge fire point (kill / hang
    / grow / shrink): what fired, where it rounded from, and the
    rank/attempt scope."""
    rounded = (f" (requested step {spec.arg} rounded up to the "
               f"window edge)" if int(spec.arg) != end else "")
    scope = f"rank {current_rank()}, attempt {current_attempt()}"
    if extra:
        scope += f", {extra}"
    return f"injected {what} at step {end}{rounded} ({scope})"


def reshard_at_window(start: int, end: int):
    """Which ``grow_at_step:N`` / ``shrink_at_step:N`` specs fall inside
    the just-completed window ``(start, end]``: a list of ``(kind,
    devices)`` requests in spec order, ``devices`` the ``devices=D``
    qualifier as an int or None for the default scaling (grow doubles,
    shrink halves the mesh).  Same window-edge rounding as kill/hang,
    and each spec fires at most once.  The consumer is
    ``FFModel.train_batch``/``train_window``/``fit``."""
    p = plan()
    if not p:
        return []
    out = []
    for spec in p:
        if spec.kind not in ("grow_at_step", "shrink_at_step"):
            continue
        if not _matches(spec):
            continue
        if start < int(spec.arg) <= end:
            devices = spec.extras.get("devices")
            _note(_edge_note(f"{spec.kind.split('_')[0]} reshard", spec,
                             end, f"devices={devices if devices else 'auto'}"))
            out.append((spec.kind, int(devices) if devices else None))
    return out


def corrupt_file(path: str) -> None:
    """The corruption primitive: truncate to half size, simulating a
    writer killed mid-write.  The result is not a valid zip, so both
    ``np.load`` and the manifest verification reject it."""
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(max(1, size // 2))


def maybe_corrupt_checkpoint(path: str, step: int) -> None:
    """Checkpoint-writer hook: call after publishing ``path`` for
    ``step``.  ``corrupt_ckpt:N`` corrupts the step-N file only;
    ``corrupt_ckpt:latest`` corrupts every file this process writes."""
    p = plan()
    if not p:
        return
    for spec in p:
        if spec.kind != "corrupt_ckpt" or not _matches(spec):
            continue
        if spec.arg == "latest" or (spec.arg.isdigit()
                                    and int(spec.arg) == step):
            corrupt_file(path)
            _note(f"injected checkpoint corruption: {path} (step {step})")


def spawn_fail_requested(env: Dict[str, str], attempt: int) -> bool:
    """Supervisor-side hook: should ``attempt`` fail at spawn time?
    Parses the worker environment (not this process's cached plan — the
    supervisor's own FF_FAULT may differ from what it exports)."""
    text = env.get("FF_FAULT")
    if not text:
        return False
    return any(s.kind == "spawn_fail_attempt" and s.attempt == attempt
               for s in parse_faults(text))


# ----------------------------------------------------------------------
# fire points of the serving stack
# ----------------------------------------------------------------------
def generation_faults() -> List[FaultSpec]:
    """The FF_FAULT token-generation specs matching this rank/attempt,
    in plan order (empty without a plan).  The consumer is the
    ``GenerationEngine``, which materializes per-engine firing state at
    ``start()`` and consults it at decode-step boundaries; this module
    stays engine-free."""
    p = plan()
    if not p:
        return []
    return [s for s in p if s.kind in GENERATION_KINDS and _matches(s)]


def fleet_faults() -> List[FaultSpec]:
    """The FF_FAULT model-fleet specs matching this rank/attempt, in
    plan order (empty without a plan).  Consumers: the fleet registry's
    build path (``fleet_load_fail``) and the FleetEngine's publish
    boundary (``fleet_swap_at_dispatch``); this module stays
    engine-free."""
    p = plan()
    if not p:
        return []
    return [s for s in p if s.kind in FLEET_KINDS and _matches(s)]


def router_faults() -> List[FaultSpec]:
    """The FF_FAULT disaggregated-router specs matching this
    rank/attempt, in plan order (empty without a plan).  The consumer
    is the cluster ``FleetRouter``, which materializes firing state at
    ``start()`` and consults it at routing/migration boundaries; this
    module stays engine-free."""
    p = plan()
    if not p:
        return []
    return [s for s in p if s.kind in ROUTER_KINDS and _matches(s)]


def serve_faults() -> List[FaultSpec]:
    """The FF_FAULT serving specs matching this rank/attempt, in plan
    order (empty without a plan — the cached None-check keeps the
    fault-free serving path cost-free).  The consumer is
    ``ServingEngine``, which materializes per-engine firing state at
    ``start()`` and consults it before each packed dispatch; this
    module stays engine-free."""
    p = plan()
    if not p:
        return []
    return [s for s in p if s.kind in SERVE_KINDS and _matches(s)]
