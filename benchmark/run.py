"""Run one cell of the benchmark of flexflow_tpu_torch and print its
result as the last line of standard output.

    python3 benchmark/run.py --workload bert_base.train.s512 --seed 7 \\
        --seconds 20 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window.  Every run checks what its
timed path produced against the plain reference and prints each number
compared beside its limit, last on standard error and last in the
result line.  The run needs as many CUDA devices as the cell asks for,
and exits non-zero without a result when they are missing, when the
program is missing, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own kernels build under build/flexflow_tpu_torch/)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
# the port's event lines off standard output, whose last line is the
# result (warnings and errors still reach standard error)
os.environ["FF_LOG_LEVEL"] = "warning"

FORBIDDEN = ("jax", "jaxlib", "flax", "flexflow_tpu")


class RunRefused(SystemExit):
    """A run that prints no result."""


def devices(chips: int):
    """The run's device; refuses without ``chips`` CUDA devices."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise RunRefused(f"this cell needs {chips} CUDA device(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return torch.device("cuda", 0)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def metrics_of(run, trace: bool) -> dict:
    """The cell's end-to-end metrics (untraced) or its per-layer metrics
    (traced); a reader that finds nothing to read is left out."""
    cell = run.cell
    out = {}
    if not trace:
        values = dict(run.end_to_end, setup_s=run.setup_s)
        for m in cell.end_to_end:
            v = values[m["name"]]
            if v != v:
                raise RuntimeError(f"{m['name']} has no value in this run")
            out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = cell.reader(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result(run, trace: bool, device) -> dict:
    import torch

    from portbench import check

    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": run.cell.chips,
           "memory_peak_bytes": int(run.memory_peak_bytes),
           "power_limit": power_limit() if cuda else "none"}
    out = {"correct": bool(run.attempted > 0 and run.failed == 0
                           and check.judge(run.checks, run.cell.limits)),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics_of(run, trace), "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {k: {"value": run.checks[k] if run.checks[k] == run.checks[k]
                           else None, "limit": lim}
                     for k, lim in run.cell.limits.items()}
    return out


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import cell as cell_mod
    cell = cell_mod.load(args.workload)
    device = device if device is not None else devices(cell.chips)
    kind = cell.traffic["kind"]
    if kind == "train":
        from portbench import train as driver
    elif kind == "generate":
        from portbench import generate as driver
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    run = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     device, T_START)
    res = result(run, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        raise RunRefused(f"loaded in this process: {', '.join(bad[:20])}")
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
