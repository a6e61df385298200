"""Per-tenant autoscaling policy, the port of
``flexflow_tpu/serving/fleet/autoscale.py``: grow a loaded tenant's
weighted-fair share from its rolling queue-depth window, release it
after the burst.

A pure observer: the fleet dispatcher feeds it ``(tenant, queue_depth,
current_weight, now)`` at its own boundary and applies the weight it
returns (one ``fleet_autoscale`` event a change).  State is per-tenant
deques on the injected clock, so a fake clock drives the whole cycle.

* samples older than ``window_s`` drop; the window's mean depth is the
  load signal;
* mean depth >= ``high_depth``: the weight grows by ``grow``, capped at
  ``max_scale`` x the tenant's base weight (its weight when first seen);
* mean depth <= ``low_depth``: the weight decays by the same factor back
  toward (never below) the base;
* decisions are paced at ``every_s`` a tenant.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional, Tuple


class TenantAutoscaler:
    """Rolling-window weight policy for :class:`~.engine.FleetEngine`
    (pass as its ``autoscaler=``).  See the module docstring for the
    grow/decay semantics."""

    def __init__(self, window_s: float = 5.0, every_s: float = 1.0,
                 high_depth: float = 4.0, low_depth: float = 0.5,
                 grow: float = 1.5, max_scale: float = 8.0):
        if window_s <= 0 or every_s <= 0:
            raise ValueError("window_s/every_s must be > 0")
        if grow <= 1.0:
            raise ValueError(f"grow must be > 1.0, got {grow}")
        if max_scale < 1.0:
            raise ValueError(f"max_scale must be >= 1.0, got {max_scale}")
        if low_depth >= high_depth:
            raise ValueError("low_depth must be < high_depth")
        self.window_s = float(window_s)
        self.every_s = float(every_s)
        self.high_depth = float(high_depth)
        self.low_depth = float(low_depth)
        self.grow = float(grow)
        self.max_scale = float(max_scale)
        # per-tenant: (samples deque of (t, depth), base weight,
        # last decision time)
        self._win: Dict[str, Deque[Tuple[float, float]]] = {}
        self._base: Dict[str, float] = {}
        self._last: Dict[str, float] = {}

    def observe(self, name: str, depth: float, weight: float,
                now: float) -> Optional[float]:
        """Record one queue-depth sample; return the new weight when
        the policy wants a change, else None.  Called by the fleet
        dispatcher only — single-threaded by construction."""
        base = self._base.setdefault(name, float(weight))
        win = self._win.setdefault(name, deque())
        win.append((now, float(depth)))
        while win and win[0][0] < now - self.window_s:
            win.popleft()
        if now - self._last.get(name, -1e30) < self.every_s:
            return None
        mean = sum(d for _, d in win) / len(win)
        new = None
        if mean >= self.high_depth:
            new = min(base * self.max_scale, weight * self.grow)
        elif mean <= self.low_depth and weight > base:
            new = max(base, weight / self.grow)
        if new is None or abs(new - weight) < 1e-12:
            return None
        self._last[name] = now
        return new

    def forget(self, name: str) -> None:
        """Drop a departed tenant's window/base (unload path)."""
        self._win.pop(name, None)
        self._base.pop(name, None)
        self._last.pop(name, None)


__all__ = ["TenantAutoscaler"]
