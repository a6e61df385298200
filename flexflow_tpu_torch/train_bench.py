"""``train-bench``: the training loop's dispatch microbenchmark, the port
of ``flexflow_tpu/train_bench.py``.

It records ``fit()``'s steps/s through the real loop at
``steps_per_dispatch=K`` for K in {1, 4, 8, 16} on a model small enough
that a step's device work is comparable to its host work (two dense
layers on a batch of 32).  In the JAX package a window of K steps is
one fused dispatch, so K amortises the host cost K-fold; in the port a
window is its K eager steps back to back (``FFModel.train_window``), so
the rows measure what K changes here: the staging of K batches at once
and the per-window host work, not the launches a step.

Run: ``python -m flexflow_tpu_torch.cli train-bench [--ks 1,4,8,16]
[--steps 64] [--batch 32] [--epochs 4] [--hidden 64] [--seed 0]
[--device cuda|cpu] [--out f.json]``: JSON on stdout either way.  The
device is the card unless ``--device cpu`` is given; the clock stops
after ``torch.cuda.synchronize`` on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np


def _build_model(k: int, batch_size: int, hidden: int, seed: int,
                 compute_dtype: str = "float32", device=None):
    """The small model: two dense layers on a batch of ``batch_size``
    rows of 16 features, 10 classes, SGD lr 0.05."""
    import flexflow_tpu_torch as ft

    cfg = ft.FFConfig(batch_size=batch_size, compute_dtype=compute_dtype,
                      seed=seed)
    cfg.steps_per_dispatch = k
    m = ft.FFModel(cfg, device=device)
    x = m.create_tensor((batch_size, 16), name="x")
    t = m.dense(x, hidden, activation="relu")
    t = m.dense(t, 10)
    m.compile(ft.SGDOptimizer(lr=0.05), metrics=["accuracy"])
    m.init_layers(seed=seed)
    return m


def _data(steps: int, batch_size: int, seed: int):
    rng = np.random.default_rng(seed)
    n = steps * batch_size
    x = rng.standard_normal((n, 16)).astype(np.float32)
    y = rng.integers(0, 10, (n, 1)).astype(np.int32)
    return x, y


def bench_k(k: int, steps: int = 64, batch_size: int = 32,
            epochs: int = 4, hidden: int = 64, seed: int = 0,
            compute_dtype: str = "float32", device=None,
            init: Optional[Callable] = None) -> Dict:
    """steps/s of ``fit()`` at ``steps_per_dispatch=k``: one warm epoch
    first, then ``epochs`` timed epochs, the clock stopped after the
    device has finished them.  ``device`` defaults to the process
    default (the card).  ``init(model)``, when given, runs after
    ``init_layers`` (a parity check loads another model's weights
    there)."""
    import torch

    from .analysis import comm_plan_digest_for_model
    from .search.calibration import device_kind

    model = _build_model(k, batch_size, hidden, seed,
                         compute_dtype=compute_dtype, device=device)
    if init is not None:
        init(model)
    plan_digest = comm_plan_digest_for_model(model)
    x, y = _data(steps, batch_size, seed)
    model.warmup_compile(x[:batch_size], y[:batch_size])
    model.fit(x, y, epochs=1, verbose=False)  # warm: loader, allocator
    t0 = time.perf_counter()
    model.fit(x, y, epochs=epochs, verbose=False)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    n_steps = steps * epochs
    return {
        "steps_per_dispatch": k,
        "steps_timed": n_steps,
        "steps_per_sec": round(n_steps / dt, 2),
        "ms_per_step": round(dt / n_steps * 1e3, 4),
        "dispatches": -(-steps // k) * epochs,
        "batch_size": batch_size,
        "final_loss": round(float(model.last_epoch_losses[-1]), 6),
        # the static plan digest of `explain`: rows with different
        # plans are different populations
        "comm_plan_digest": plan_digest,
        "precision_policy": model.config.precision_policy(),
        "device": device_kind(model.device),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="flexflow-tpu-torch train-bench",
        description="the training loop's dispatch microbenchmark: fit() "
                    "steps/s across steps_per_dispatch values")
    ap.add_argument("--ks", default="1,4,8,16",
                    help="comma-separated steps_per_dispatch values")
    ap.add_argument("--steps", type=int, default=64,
                    help="train steps per epoch (dataset size / batch)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=4,
                    help="timed epochs per K (one warm epoch on top)")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the device to run on (default: the card)")
    ap.add_argument("--calibration", default="",
                    help="CalibrationTable JSON whose digest the rows "
                         "record (the table does not alter the run)")
    ap.add_argument("--out", default="",
                    help="also write the JSON payload here")
    args = ap.parse_args(argv)
    ks = [int(v) for v in args.ks.split(",") if v.strip()]
    if any(v < 1 for v in ks):
        ap.error(f"--ks values must be >= 1, got {ks}")

    # resolve the provenance digest before the measured run: a typo'd
    # --calibration fails at once, not after minutes of timed epochs
    from .search.calibration import CalibrationTable, device_kind
    try:
        digest = (CalibrationTable.load(args.calibration).digest
                  if args.calibration else None)
    except (OSError, ValueError) as e:
        ap.error(f"cannot load --calibration {args.calibration!r}: {e}")
    device = _device(args.device)

    # this bench's stdout is the payload: silence the epoch events
    from .fflogger import get_logger
    log = get_logger("ff")
    prev_level = log.level
    log.level = 100
    try:
        results = [bench_k(k, steps=args.steps, batch_size=args.batch,
                           epochs=args.epochs, hidden=args.hidden,
                           seed=args.seed, device=device)
                   for k in ks]
    finally:
        log.level = prev_level
    base = next((r for r in results if r["steps_per_dispatch"] == 1),
                results[0])
    kind = device_kind(device)
    for r in results:
        r["speedup_vs_k1"] = round(
            r["steps_per_sec"] / base["steps_per_sec"], 3)
        r["device_kind"] = kind
        r["calibration_digest"] = digest
        r["estimator"] = "measured"  # a real run, not a simulator's
    payload = {
        "bench": "train-bench",
        "backend": device.type,
        "steps_per_epoch": args.steps,
        "device_kind": kind,
        "calibration_digest": digest,
        "precision_policy": (results[0].get("precision_policy")
                             if results else None),
        "comm_plan_digest": (results[0].get("comm_plan_digest")
                             if results else None),
        "results": results,
    }
    text = json.dumps(payload, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"# wrote {args.out}", file=sys.stderr)


def _device(name: Optional[str]):
    """The bench's device: ``name`` when given, else the process
    default (the runner's ``--device``), else the card; without a card
    it raises ``default_device()``'s error."""
    import torch

    from .model import default_device
    return torch.device(name) if name is not None else default_device()


if __name__ == "__main__":
    main()
