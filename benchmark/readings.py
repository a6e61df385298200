"""The readings a cell's correctness limits are set from, on the card:

    python3 benchmark/readings.py --workload bert_base.train.s512 \\
        --seeds 11,12,13 [--seconds 10]

For each seed, one JSON line on standard output with the numbers that
``run.py`` compares, read three ways: ``program`` (what the program's
timed path produced, against the float32 reference), ``control`` (the
reference itself with every matrix product's operands in fp8, the
precision below the configuration's bf16, in the program's place) and,
for a training cell, ``half_batch`` (the reference on half of each
batch, its loss the mean over those rows, in the program's place).  A
generation cell's seeds each serve the cell's own traffic for
``--seconds`` after its warm-up, as a run's window does.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)

import run as harness  # noqa: E402  (sets the caches and the log level)


def _leaves(prog: dict, ref: dict, keep) -> dict:
    """Each kept leaf's gap as ``check.worst_leaf`` measures it: the
    worst three and the median."""
    import statistics
    med = statistics.median(ref[k] for k in keep)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}
    worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
    return {"worst": [[k, gaps[k], prog[k], ref[k]] for k in worst],
            "median": statistics.median(gaps.values())}


def diagnose(prog: dict, ref: dict) -> dict:
    from portbench import check
    keep = check.kept_leaves(ref["grad_norms"])
    return {"kept": len(keep), "leaves": len(ref["grad_norms"]),
            "grad": _leaves(prog["grad_norms"], ref["grad_norms"], keep),
            "change": _leaves(prog["change_norms"], ref["change_norms"],
                              keep)}


def train_readings(cell, seed: int, device) -> dict:
    import torch

    from portbench import check, train

    model, _, record = train.program_steps(cell, seed, device)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ref = train.reference_steps(cell, seed, device)
    plain = train.reference_steps(cell, seed, device, "bf16")
    ctrl = train.reference_steps(cell, seed, device, "fp8")
    half = train.reference_steps(
        cell, seed, device, rows=slice(0, cell.traffic["batch"] // 2))
    return {"program": check.train_numbers(record, ref, plain),
            "control": check.train_numbers(ctrl, ref, plain),
            "half_batch": check.train_numbers(half, ref, plain),
            "diagnose": {"program": diagnose(record, ref),
                         "control": diagnose(ctrl, ref)},
            "losses": {"program": record["losses"],
                       "reference": ref["losses"],
                       "control": ctrl["losses"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    from portbench import cell as cell_mod, generate
    cell = cell_mod.load(args.workload)
    device = harness.devices(cell.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        if cell.traffic["kind"] == "train":
            out = train_readings(cell, seed, device)
        else:
            r = generate.run(cell, seed, args.seconds, False, device, t0,
                             control=True)
            out = {"program": {"logit_gap": r.checks["logit_gap"]},
                   "control": {"logit_gap": r.checks["control_gap"]},
                   "checked_requests": r.work["checked_requests"],
                   "checked_tokens": r.work["checked_tokens"],
                   "attempted": r.attempted, "failed": r.failed}
        out.update(workload=args.workload, seed=seed,
                   seconds=round(time.monotonic() - t0, 3))
        print(json.dumps(out), flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
