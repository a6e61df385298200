"""Elastic multi-process training: failure detection, restart from the
newest valid checkpoint, and planned resizes — the port of
``flexflow_tpu/parallel/elastic.py``.

The port runs one process per device (``parallel/distributed.py``), and
a process group has one world size for its life: a ``MachineMesh``
spans every rank.  So the supervisor is where the world changes size.
``run_elastic`` supervises the group:

* spawn N worker processes with torchrun's variables (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
  ``MASTER_ADDR=127.0.0.1`` and ``MASTER_PORT``, a fresh port per
  attempt, never the previous attempt's) and the supervisor's own
  (``FF_ELASTIC_ATTEMPT``, ``FF_HEARTBEAT_DIR``, ``FF_ELASTIC_NPROCS``,
  and ``FF_ELASTIC_CKPT_DIR`` when a checkpoint directory is given), so
  ``initialize_distributed()`` brings the group up with no arguments;
* poll liveness and progress: any worker exiting nonzero fails the
  attempt (all or nothing, as a process group is), and with
  ``hang_timeout_s`` an attempt in which no rank advances its heartbeat
  step for that long is killed and classified ``hung``;
* classify every failed attempt (``crash`` / ``hung`` / ``spawn`` /
  ``timeout``) and relaunch up to ``max_restarts`` times with
  exponential backoff and seeded jitter.  A first attempt in which
  every rank exits nonzero at once fails fast;
* degrade and continue: after ``degrade_after`` topology-class failures
  the world is halved (never below ``min_processes``), with a
  ``degrade`` event;
* planned resizes: ranks that all exit with :data:`RESIZE_EXIT_CODE`
  after writing ``resize.json`` to their heartbeat directory (what
  ``FFModel`` does for a ``grow_at_step``/``shrink_at_step`` fault or a
  reshard to another device count under the supervisor) are relaunched
  at the requested world size without consuming a restart, with a
  ``reshard`` event; the new ranks resume from the step's checkpoint and
  reshard on resume.

Workers resume themselves: "load the newest valid checkpoint if one
exists, else start fresh" (``resilience.elastic_resume``).  Heartbeats
(``resilience.Heartbeat``) are compared with the supervisor's own clock;
detection starts at the first observed beat, so a slow first step is
covered by ``attempt_timeout_s``, not mistaken for a hang.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import random
import socket
import subprocess
import tempfile
import time
from typing import (Callable, Collection, Dict, List, Mapping, Optional,
                    Sequence)

from ..faults import spawn_fail_requested
from ..resilience import (_step_checkpoints, latest_valid_checkpoint,
                          read_heartbeats)

#: the exit code of a rank that saved its step's checkpoint and asks the
#: supervisor for another world size (its heartbeat directory's
#: ``resize.json`` names it)
RESIZE_EXIT_CODE = 18
#: the file a resizing rank writes beside its heartbeat
RESIZE_FILE = "resize.json"
#: planned resizes one supervision takes before it treats another as a
#: failure (a worker that asked for a resize on every attempt would
#: otherwise relaunch forever)
MAX_RESIZES = 4


def _call_sized(fn, attempt: int, port: int, rank: int, nprocs: int):
    """Invoke a worker_argv/per_rank_env callback with the CURRENT world
    size as a 4th argument when the callable takes a 4th required
    positional (the degrade and resize policies change the world
    between attempts); 3-argument callables keep the fixed-size call."""
    try:
        params = inspect.signature(fn).parameters.values()
        nargs = sum(1 for p in params
                    if p.kind in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD)
                    and p.default is p.empty)
    except (TypeError, ValueError):
        nargs = 3
    if nargs >= 4:
        return fn(attempt, port, rank, nprocs)
    return fn(attempt, port, rank)


def free_port(avoid: Collection[int] = ()) -> int:
    """An OS-assigned free port, never one in ``avoid``.  Sockets for
    avoided ports are held open until a fresh port is found, so the OS
    cannot hand the same one straight back."""
    held: List[socket.socket] = []
    try:
        port = 0
        for _ in range(16):
            s = socket.socket()
            held.append(s)
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
            if port not in avoid:
                break
        return port
    finally:
        for s in held:
            s.close()


def backoff_schedule(n: int, base_s: float = 0.5, max_s: float = 30.0,
                     jitter: float = 0.5, seed: int = 0) -> List[float]:
    """Delays (seconds) before restarts 1..n: exponential growth capped
    at ``max_s``, times a seeded jitter factor in ``[1, 1+jitter)``
    (Python's ``random.Random(seed)``, the JAX package's schedule)."""
    rng = random.Random(seed)
    return [min(max_s, base_s * (2.0 ** i)) * (1.0 + jitter * rng.random())
            for i in range(n)]


@dataclasses.dataclass
class AttemptResult:
    port: int
    returncodes: List[Optional[int]]
    failed_rank: Optional[int]  # first rank observed dead/nonzero
    timed_out: bool
    elapsed_s: float
    tails: Dict[int, str]       # rank -> tail of combined stdout+stderr log
    spawn_error: Optional[str] = None
    #: ``ok`` | ``crash`` | ``hung`` | ``spawn`` | ``timeout`` | ``resize``
    cause: str = "crash"
    #: last heartbeat step per rank (empty when no rank ever beat)
    rank_steps: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: backoff slept after this attempt, before the next one
    backoff_s: float = 0.0
    #: world size this attempt ran with
    num_processes: int = 0
    #: a planned resize's request (``{"processes": D, "step": N}``)
    resize: Optional[Dict] = None


@dataclasses.dataclass
class ElasticReport:
    success: bool
    attempts: List[AttemptResult]
    #: attempt 0 was an instant all-rank crash; restarts were skipped
    fail_fast: bool = False

    @property
    def restarts(self) -> int:
        """Relaunches after failures (planned resizes do not count)."""
        return sum(1 for a in self.attempts[:-1] if a.cause != "resize")


# substrings identifying a rendezvous bind race in a worker tail; the
# retry with a fresh port is what a restart does: a spawn-class transient
_ADDR_IN_USE = ("address already in use", "eaddrinuse")


def _classify(spawn_error: Optional[str], hung: bool, timed_out: bool,
              failed_rank: Optional[int], tails: Dict[int, str]) -> str:
    if spawn_error is not None:
        return "spawn"
    if hung:
        return "hung"
    if timed_out:
        return "timeout"
    if failed_rank is None:
        return "ok"
    # the store lives in rank 0, but the bind error can surface in any
    # rank's bring-up: check the failed rank and rank 0
    for r in {0, failed_rank}:
        if any(pat in tails.get(r, "").lower() for pat in _ADDR_IN_USE):
            return "spawn"
    return "crash"


def _read_resize(hb_dir: str) -> Optional[Dict]:
    try:
        with open(os.path.join(hb_dir, RESIZE_FILE)) as fh:
            req = json.load(fh)
        return {"processes": int(req["processes"]),
                "step": int(req.get("step", -1))}
    except (OSError, ValueError, KeyError, TypeError):
        return None


def request_resize(processes: int, step: int) -> None:
    """Worker side of a planned resize: record the world size asked for
    in this attempt's heartbeat directory (rank 0 writes it; the caller
    then exits with :data:`RESIZE_EXIT_CODE`)."""
    hb_dir = os.environ.get("FF_HEARTBEAT_DIR")
    if not hb_dir:
        raise RuntimeError("request_resize needs FF_HEARTBEAT_DIR "
                           "(run the workers under run_elastic)")
    final = os.path.join(hb_dir, RESIZE_FILE)
    tmp = final + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"processes": int(processes), "step": int(step)}, fh)
    os.replace(tmp, final)


def _rank_env(worker_env: Dict[str, str], port: int, rank: int,
              nprocs: int) -> Dict[str, str]:
    """torchrun's variables for one rank on this host."""
    env = dict(worker_env)
    env.update({"RANK": str(rank), "WORLD_SIZE": str(nprocs),
                "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(nprocs),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    return env


def run_elastic(worker_argv: Callable[[int, int, int], Sequence[str]],
                num_processes: int,
                max_restarts: int = 2,
                attempt_timeout_s: float = 600.0,
                poll_interval_s: float = 0.5,
                env: Optional[Dict[str, str]] = None,
                grace_kill_s: float = 5.0,
                per_rank_env: Optional[
                    Callable[[int, int, int], Mapping[str, str]]] = None,
                hang_timeout_s: Optional[float] = None,
                heartbeat_root: Optional[str] = None,
                backoff_base_s: float = 0.5,
                backoff_max_s: float = 30.0,
                backoff_jitter: float = 0.5,
                backoff_seed: int = 0,
                fail_fast_window_s: float = 2.0,
                min_processes: Optional[int] = None,
                degrade_after: int = 2,
                checkpoint_dir: Optional[str] = None) -> ElasticReport:
    """Supervise ``num_processes`` workers; restart the whole group on
    any failure, at most ``max_restarts`` times.

    ``worker_argv(attempt, port, rank)`` builds each worker's argv;
    ``env`` extends os.environ for every rank; ``per_rank_env(attempt,
    port, rank)`` adds rank-specific variables on top of torchrun's
    (see the module docstring).  Both take the world size as an
    optional 4th argument.  ``checkpoint_dir`` is exported as
    ``FF_ELASTIC_CKPT_DIR``: where a rank saves the step's checkpoint
    before a planned resize.

    ``hang_timeout_s`` enables hang detection on heartbeats; between
    failed attempts the supervisor sleeps per :func:`backoff_schedule`;
    an all-rank nonzero exit within ``fail_fast_window_s`` of attempt 0
    aborts supervision with ``fail_fast=True``.  ``min_processes``
    turns on degrade-and-continue (halve the world after
    ``degrade_after`` consecutive crash/hung/timeout attempts).  A
    planned resize (every rank exiting with :data:`RESIZE_EXIT_CODE`)
    relaunches at the size the ranks asked for, at most
    :data:`MAX_RESIZES` times, and consumes no restart.

    Returns an :class:`ElasticReport`; ``success`` means some attempt
    had every worker exit 0."""
    attempts: List[AttemptResult] = []
    # the flight recorder's taps up front, so the first failure's dump
    # already holds the supervisor's event trail
    from ..fflogger import get_logger
    from ..obs.flight import flight_dump, get_flight
    get_flight()
    hb_root = heartbeat_root or tempfile.mkdtemp(prefix="ff_hb_")
    backoffs = backoff_schedule(max_restarts, backoff_base_s,
                                backoff_max_s, backoff_jitter, backoff_seed)
    prev_port: Optional[int] = None
    nproc_cur = int(num_processes)
    if min_processes is not None and not 1 <= min_processes <= num_processes:
        raise ValueError(
            f"min_processes={min_processes} must be in "
            f"[1, num_processes={num_processes}]")
    topo_fails = 0  # consecutive crash/hung/timeout at the current size
    restarts = resizes = 0
    attempt = -1
    while True:
        attempt += 1
        port = free_port(avoid=() if prev_port is None else (prev_port,))
        prev_port = port
        hb_dir = os.path.join(hb_root, f"attempt{attempt}")
        os.makedirs(hb_dir, exist_ok=True)
        worker_env = dict(os.environ)
        if env:
            worker_env.update(env)
        worker_env["FF_ELASTIC_ATTEMPT"] = str(attempt)
        worker_env["FF_HEARTBEAT_DIR"] = hb_dir
        worker_env["FF_ELASTIC_NPROCS"] = str(nproc_cur)
        if checkpoint_dir is not None:
            worker_env["FF_ELASTIC_CKPT_DIR"] = str(checkpoint_dir)
        procs: List[subprocess.Popen] = []
        # per-rank log FILES, not pipes: an undrained pipe blocks the
        # worker after ~64 KB of output
        logdir = tempfile.mkdtemp(prefix=f"ff_elastic_a{attempt}_")
        logs = []
        t0 = time.monotonic()
        failed_rank: Optional[int] = None
        timed_out = hung = resized = False
        spawn_error: Optional[str] = None
        last_hb: Dict[int, int] = {}
        last_progress = t0
        try:
            try:
                if spawn_fail_requested(worker_env, attempt):
                    raise OSError(
                        f"injected spawn_fail_attempt:{attempt} (FF_FAULT)")
                for rank in range(nproc_cur):
                    lf = open(os.path.join(logdir, f"rank{rank}.log"),
                              "w+b")
                    logs.append(lf)
                    env_r = _rank_env(worker_env, port, rank, nproc_cur)
                    if per_rank_env is not None:
                        env_r.update(_call_sized(per_rank_env, attempt,
                                                 port, rank, nproc_cur))
                    procs.append(subprocess.Popen(
                        list(_call_sized(worker_argv, attempt, port,
                                         rank, nproc_cur)),
                        stdout=lf, stderr=subprocess.STDOUT,
                        env=env_r))
            except OSError as e:
                failed_rank = len(procs)  # the rank that failed to spawn
                spawn_error = f"{type(e).__name__}: {e}"
            while spawn_error is None:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes)
                       if c is not None and c not in (0, RESIZE_EXIT_CODE)]
                if bad:
                    failed_rank = bad[0]
                    break
                if all(c is not None for c in codes):
                    resized = RESIZE_EXIT_CODE in codes
                    if resized and any(c == 0 for c in codes):
                        # half the world resized and half finished: not
                        # a resize the group agreed on
                        failed_rank = codes.index(0)
                        resized = False
                    break
                now = time.monotonic()
                if now - t0 > attempt_timeout_s:
                    timed_out = True
                    break
                if hang_timeout_s is not None:
                    hb = read_heartbeats(hb_dir)
                    if hb != last_hb:    # a new rank appeared or a step
                        last_hb = hb     # advanced: that is progress
                        last_progress = now
                    elif hb and now - last_progress > hang_timeout_s:
                        hung = True
                        break
                time.sleep(poll_interval_s)
            if (attempt == 0 and failed_rank is not None
                    and spawn_error is None
                    and time.monotonic() - t0 <= fail_fast_window_s):
                # possible config-error signature: give the remaining
                # ranks the rest of the window to exit on their own
                while (any(p.poll() is None for p in procs)
                        and time.monotonic() - t0 <= fail_fast_window_s):
                    time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            deadline = time.monotonic() + grace_kill_s
            for p in procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        tails = {}
        for r, lf in enumerate(logs):
            try:
                lf.flush()
                lf.seek(0, os.SEEK_END)
                size = lf.tell()
                lf.seek(max(0, size - 800))
                tails[r] = lf.read().decode("utf-8", "replace")
            except Exception:  # noqa: BLE001 — forensics only
                tails[r] = "<log unavailable>"
            finally:
                lf.close()
        request = _read_resize(hb_dir) if resized else None
        if resized and request is None:
            failed_rank, resized = 0, False   # no request: a crash
        cause = ("resize" if resized else
                 _classify(spawn_error, hung, timed_out, failed_rank, tails))
        result = AttemptResult(
            port=port,
            returncodes=[p.returncode for p in procs],
            failed_rank=failed_rank,
            timed_out=timed_out or hung,
            elapsed_s=round(time.monotonic() - t0, 3), tails=tails,
            spawn_error=spawn_error, cause=cause,
            rank_steps=read_heartbeats(hb_dir),
            num_processes=nproc_cur, resize=request)
        attempts.append(result)
        if cause == "ok" and all(c == 0 for c in result.returncodes):
            return ElasticReport(True, attempts)
        if cause == "resize" and resizes < MAX_RESIZES:
            resizes += 1
            get_logger("elastic").event(
                "reshard", attempt=attempt, via="supervisor",
                old_devices=nproc_cur, new_devices=request["processes"],
                step=request["step"])
            nproc_cur = request["processes"]
            topo_fails = 0
            continue
        flight_dump("elastic_attempt_failed", extra={
            "attempt": attempt, "cause": cause,
            "num_processes": nproc_cur,
            "returncodes": result.returncodes,
            "failed_rank": failed_rank,
            "tail": (result.tails.get(failed_rank, "")[-400:]
                     if failed_rank is not None else "")})
        if (attempt == 0 and cause == "crash"
                and result.elapsed_s <= fail_fast_window_s
                and result.returncodes
                and all(c not in (0, None) and c >= 0
                        for c in result.returncodes)):
            # every rank self-exited nonzero near-instantly (negative
            # codes are our own kills): an argv or config error
            return ElasticReport(False, attempts, fail_fast=True)
        if cause in ("crash", "hung", "timeout"):
            topo_fails += 1
        if (min_processes is not None and nproc_cur > min_processes
                and topo_fails >= max(1, int(degrade_after))):
            new_size = max(int(min_processes), nproc_cur // 2)
            get_logger("elastic").event(
                "degrade", attempt=attempt, cause=cause,
                from_processes=nproc_cur, to_processes=new_size,
                consecutive_failures=topo_fails)
            nproc_cur = new_size
            topo_fails = 0
        if restarts >= max_restarts:
            return ElasticReport(False, attempts)
        if backoffs[restarts] > 0:
            result.backoff_s = round(backoffs[restarts], 3)
            time.sleep(backoffs[restarts])
        restarts += 1


def latest_checkpoint(directory: str, prefix: str = "elastic") -> Optional[str]:
    """Newest ``<prefix>_step*.npz`` checkpoint in ``directory``, or
    None, by the step in the name (not mtime).  Trusts the file; the
    resume path should prefer :func:`latest_valid_checkpoint`."""
    found = _step_checkpoints(directory, prefix)
    return found[0][1] if found else None


__all__ = ["run_elastic", "AttemptResult", "ElasticReport",
           "backoff_schedule", "free_port", "latest_checkpoint",
           "latest_valid_checkpoint", "request_resize", "RESIZE_EXIT_CODE",
           "RESIZE_FILE"]
