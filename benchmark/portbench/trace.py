"""The traced window: ``torch.profiler`` over the window, its events kept
in memory (no Chrome trace is exported), and their reduction to device
time by kernel name, the device's busy intervals, and the idle gaps named
by what the host was doing.

A trace is trusted only when it is complete.  The profiler is closed
after a device synchronize, and each hand-written kernel's count in the
trace must equal the delta of its launch counter over the traced span
(``KERNELS`` in the metric files name them); a mismatch fails the run
rather than print a roofline share from a trace with missing events.
"""

from __future__ import annotations

import heapq
import importlib
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation")
# the host range that spans the measured window in a traced run
WINDOW = "bench.window"


def counter_value(path: str) -> int:
    """The launch counter at ``module:attr.attr`` (for example
    ``flexflow_tpu_torch.ops.cuda_norm:fused_layernorm.launches``)."""
    mod, attrs = path.split(":")
    obj = importlib.import_module(mod)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return int(obj)


@dataclass
class Trace:
    """The reduction of one traced span.  Times are seconds; the window
    is ``[t0, t1]`` on the trace's clock.  ``ops`` are the device
    operations inside the window as ``(name, start, end)``."""
    t0: float
    t1: float
    ops: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]] = field(repr=False,
                                                 default_factory=list)
    counts: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches
        ``pattern`` (a regular expression, searched, case ignored)."""
        rx = re.compile(pattern, re.I)
        return sum(min(e, self.t1) - max(s, self.t0)
                   for name, s, e in self.ops if rx.search(name))

    def kernel_count(self, pattern: str) -> int:
        rx = re.compile(pattern, re.I)
        return sum(1 for name, _, _ in self.ops if rx.search(name))

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            by[name[:160]] += min(e, self.t1) - max(s, self.t0)
        return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The device's idle time in the window, summed by the innermost
        host range or operator open when each gap began (``host`` when
        none was: Python between operators)."""
        host = sorted(self.host, key=lambda h: h[1])
        busy = self.busy_intervals()
        gaps = []
        prev = self.t0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = e
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        by: Dict[str, float] = defaultdict(float)
        heap: List[Tuple[float, float, str]] = []
        i = 0
        for gs, ge in gaps:   # gap starts increase
            while i < len(host) and host[i][1] <= gs:
                name, hs, he = host[i]
                heapq.heappush(heap, (-hs, he, name))
                i += 1
            while heap and heap[0][1] < gs:
                heapq.heappop(heap)
            by[heap[0][2][:160] if heap else "host"] += ge - gs
        return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])[:k]]


def _activity(ev) -> str:
    """A profiler event's kind, as ``DEVICE_ACTIVITIES`` and
    ``HOST_ACTIVITIES`` name them.  Builds of torch whose events lack
    ``activity_type`` tell them apart by device and annotation."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    on_host = str(ev.device_type()).endswith("CPU")
    if getattr(ev, "is_user_annotation", lambda: False)():
        return "user_annotation" if on_host else "gpu_user_annotation"
    return "cpu_op" if on_host else "kernel"


class TracedSpan:
    """Profile from ``start()`` to ``stop()``; ``stop`` synchronizes the
    device first.  ``kernels`` maps a kernel-name pattern to
    ``(counter path, kernels a counted launch makes)``."""

    def __init__(self, kernels: Dict[str, Tuple[str, int]], cuda: bool):
        self.kernels = kernels
        self.cuda = cuda
        self.prof = None
        self.base: Dict[str, int] = {}
        self.reduce_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.base = {p: counter_value(c) for p, (c, _) in self.kernels.items()}
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> Trace:
        """Close the profiler and reduce its events to the window, the
        span of the host range ``WINDOW`` (so no second clock has to
        agree with the profiler's).  Raises when a hand-written kernel's
        count in the trace differs from its counter's delta."""
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        t_reduce = time.monotonic()
        events = self.prof.profiler.kineto_results.events()
        base = min((ev.start_ns() for ev in events), default=0)
        ops, host = [], []
        for ev in events:
            kind = _activity(ev)
            if kind in DEVICE_ACTIVITIES:
                dest = ops
            elif kind in HOST_ACTIVITIES:
                dest = host
            else:
                continue
            s = ev.start_ns() - base
            dest.append((ev.name(), s * 1e-9, (s + ev.duration_ns()) * 1e-9))
        self.prof = None
        whole = Trace(-float("inf"), float("inf"), ops)
        counts = {}
        for pat, (ctr, per) in self.kernels.items():
            launched = (counter_value(ctr) - self.base[pat]) * per
            seen = whole.kernel_count(pat)
            if seen != launched:
                raise RuntimeError(
                    f"incomplete trace: {seen} kernels match {pat!r} but "
                    f"the counter {ctr} says {launched} ran")
            counts[pat] = seen
        marks = [h for h in host if h[0] == WINDOW]
        if len(marks) != 1:
            raise RuntimeError(f"the trace holds {len(marks)} {WINDOW!r} "
                               f"ranges, not one")
        _, t0, t1 = marks[0]
        host = [h for h in host if h[0] != WINDOW]
        inside = [o for o in ops if o[2] > t0 and o[1] < t1]
        self.reduce_s = time.monotonic() - t_reduce
        return Trace(t0, t1, inside, host, counts)
