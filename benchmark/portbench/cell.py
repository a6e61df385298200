"""A cell of ``BENCHMARK.json`` with everything its names point at, and
what a run of it hands to the metric readers."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    bench_dir: str

    @property
    def family(self):
        return importlib.import_module(f"families.{self.config['family']}")

    @property
    def reference(self):
        return importlib.import_module(f"reference.{self.config['family']}")

    @property
    def geometry(self) -> Dict:
        return self.family.geometry(self.config)

    def reader(self, metric: str):
        """The module of ``metrics/<metric>.py``, whose ``read(run)``
        returns the metric's value, or None where the run holds nothing
        to read."""
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        key = "portbench_metric_" + "".join(
            c if c.isalnum() else "_" for c in path)
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            sys.modules[key] = mod
        return sys.modules[key]

    def kernels(self) -> Dict[str, tuple]:
        """The hand-written kernels the cell's per-layer metrics time:
        name pattern -> (launch counter, kernels a launch makes)."""
        out: Dict[str, tuple] = {}
        for m in self.per_layer:
            out.update(getattr(self.reader(m["name"]), "KERNELS", {}))
        return out


def _load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load(workload: str, root: Optional[str] = None) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` (root: the
    directory above the benchmark's)."""
    root = root or os.path.dirname(BENCH_DIR)
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load(os.path.join(bench_dir, "traffic",
                                 f"{w['traffic']}.json"))
    limits = _load(os.path.join(bench_dir, "limits", f"{workload}.json"))

    def here(m: Dict) -> bool:
        return workload in m.get("workloads", cells)

    e2e = [m for m in bench["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e,
                per_layer, bench_dir)


@dataclass
class Run:
    """What one run of a cell measured, for the metric readers.
    ``window_s`` is the host clock's window; ``trace`` the reduction of
    the traced window (None in an untraced run); ``work`` what the driver
    counted in the window (its keys are the driver's)."""
    cell: Cell
    seed: int
    window_s: float
    work: Dict
    trace: Optional[object] = None
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, float] = field(default_factory=dict)
    checks: Dict[str, float] = field(default_factory=dict)
    memory_peak_bytes: int = 0
