"""``precision-bench``: what the precision axis and int8 weight
quantization are worth, the port of ``flexflow_tpu/precision_bench.py``.

Three sections, one JSON payload:

* **search**: MCMC over the transformer zoo graph on a float32-charged
  simulator, with and without the precision axis: the mixed-precision
  strategy's simulated step time against the all-float32 baseline
  (``mixed_beats_baseline``, recorded as it comes out), and how many ops
  the axis moved to bf16.  Seeded and analytic, so independent of the
  host; the device spec is the port's default, ``H100_SXM_SPEC``
  (``spec=`` takes another, such as the JAX package's, under which the
  walks are the JAX package's);
* **train**: measured ``fit()`` steps/s under the bf16 and float32
  global policies (``FFConfig.compute_dtype``), through train-bench's
  ``bench_k`` at K=1;
* **serve**: measured serving rows/s, int8 weight-quantized against the
  full-precision baseline (same model, same engine knobs), with the
  quantization report: ``max_abs_err`` against the symmetric-rounding
  ``error_bound`` and ``bound_ok`` (the engine refuses to serve when it
  fails);

plus provenance (``device_kind``, ``backend``, the policy tag of each
row).

Run: ``python -m flexflow_tpu_torch.cli precision-bench [--budget 300]
[--devices 8] [--steps 48] [--epochs 2] [--requests 192] [--seed 0]
[--device cuda|cpu] [--out f.json]``: JSON on stdout either way.  The
train and serve sections run on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict


def bench_search(budget: int = 300, seed: int = 0, num_devices: int = 8,
                 spec=None, device: str = "cuda") -> Dict:
    """The precision axis's win on the zoo transformer, simulated on a
    float32-charged objective (``dtype_bytes=4``).  ``spec`` defaults to
    ``H100_SXM_SPEC``; ``device`` names whose kernel rules the objective
    charges (on ``"cuda"`` attention runs the flash kernels, whose scores
    never reach device memory; ``"cpu"`` charges the dense path, as the
    JAX package's objective does)."""
    from .config import FFConfig
    from .models import build_transformer
    from .search.cost_model import H100_SXM_SPEC
    from .search.mcmc import search
    from .search.simulator import Simulator

    spec = H100_SXM_SPEC if spec is None else spec
    cfg = FFConfig(batch_size=32, compute_dtype="float32")
    # the graph only: nothing is allocated before init_layers
    model, _, _ = build_transformer(cfg, num_layers=2, d_model=128,
                                    num_heads=4, d_ff=256, seq_len=64,
                                    vocab_size=1000, device="cpu")

    def run(precision_axis: bool):
        sim = Simulator(spec=spec, num_devices=num_devices, dtype_bytes=4,
                        compute_dtype="float32", device=device)
        return search(model.layers, num_devices, budget=budget,
                      seed=seed, sim=sim, precision_axis=precision_axis)

    best, mesh, mixed_t = run(True)
    _, _, base_t = run(False)
    n_bf16 = sum(1 for pc in best.values() if pc.precision == "bf16")
    n_f32 = sum(1 for pc in best.values() if pc.precision == "f32")
    return {
        "graph": "transformer",
        "num_devices": num_devices,
        "budget": budget,
        "baseline_all_f32_ms": round(base_t * 1e3, 6),
        "mixed_precision_ms": round(mixed_t * 1e3, 6),
        "speedup": round(base_t / mixed_t, 4) if mixed_t else None,
        "mixed_beats_baseline": mixed_t < base_t,
        "bf16_ops": n_bf16,
        "f32_pinned_ops": n_f32,
        "best_mesh": {a: s for a, s in mesh.items() if s > 1},
        "precision_policy": "f32+mixed(search)",
    }


def bench_train(steps: int = 48, epochs: int = 2, seed: int = 0,
                device=None) -> Dict:
    """Measured ``fit()`` steps/s, bf16 against float32 global policy
    (train-bench's ``bench_k`` at K=1)."""
    from .train_bench import bench_k

    rows = {}
    for dtype in ("float32", "bfloat16"):
        r = bench_k(1, steps=steps, epochs=epochs, seed=seed,
                    compute_dtype=dtype, device=device)
        rows[dtype] = {"steps_per_sec": r["steps_per_sec"],
                       "ms_per_step": r["ms_per_step"],
                       "precision_policy": r["precision_policy"]}
    f32 = rows["float32"]["steps_per_sec"]
    bf16 = rows["bfloat16"]["steps_per_sec"]
    return {**rows, "bf16_over_f32": round(bf16 / max(1e-9, f32), 3)}


def bench_serve(requests: int = 192, max_batch: int = 32,
                hidden: int = 256, seed: int = 0, device=None) -> Dict:
    """Measured serving rows/s, int8-quantized against baseline: same
    graph, weights and knobs, the best of two runs each (host hiccups
    only inflate a wall-clock sample)."""
    import flexflow_tpu_torch as ft

    from .fflogger import silenced
    from .serving.bench import NFEAT, make_requests
    from .serving.engine import ServingEngine

    def build(quantize: str):
        cfg = ft.FFConfig(batch_size=max_batch, compute_dtype="float32",
                          seed=seed, serve_max_batch=max_batch,
                          serve_quantize=quantize)
        m = ft.FFModel(cfg, device=device)
        x = m.create_tensor((max_batch, NFEAT), name="x")
        t = m.dense(x, hidden, activation="relu")
        t = m.dense(t, hidden, activation="relu")
        t = m.dense(t, 10)
        m.compile(ft.SGDOptimizer(lr=0.05))
        m.init_layers(seed=seed)
        return m

    reqs = make_requests(requests, 1, 8, seed)
    rows_total = sum(r.shape[0] for r in reqs)

    def maxrate(model) -> float:
        best = 0.0
        for _ in range(2):
            with silenced("serve"), ServingEngine(model) as eng:
                t0 = time.perf_counter()
                futs = [eng.submit(r) for r in reqs]
                for f in futs:
                    f.result(timeout=120)
                dt = time.perf_counter() - t0
            best = max(best, rows_total / dt)
        return round(best, 2)

    base_model = build("")
    base_rps = maxrate(base_model)
    q_model = build("int8")
    with silenced("serve"):
        q_rps = maxrate(q_model)
    qrep = q_model._quant_report
    return {
        "requests": requests,
        "rows": rows_total,
        "baseline_rows_per_s": base_rps,
        "int8_rows_per_s": q_rps,
        "int8_over_baseline": round(q_rps / max(1e-9, base_rps), 3),
        "baseline_policy": base_model.config.precision_policy(),
        "int8_policy": q_model.config.precision_policy(),
        "quality": {
            "max_abs_err": qrep["max_abs_err"],
            "error_bound": qrep["error_bound"],
            "bound_ok": qrep["bound_ok"],
            "weights_quantized": len(qrep["weights"]),
            "bytes_before": qrep["bytes_before"],
            "bytes_after": qrep["bytes_after"],
        },
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="flexflow-tpu-torch precision-bench",
        description="the precision axis and int8 serving, measured")
    ap.add_argument("--budget", type=int, default=300,
                    help="MCMC iterations per search leg")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--steps", type=int, default=48,
                    help="train steps per epoch")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--requests", type=int, default=192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the device to run on (default: the card)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from .fflogger import get_logger
    from .search.calibration import device_kind
    from .train_bench import _device
    device = _device(args.device)
    log = get_logger("ff")
    prev_level = log.level
    log.level = 100  # this bench's stdout is the payload
    try:
        payload = {
            "bench": "precision-bench",
            "backend": device.type,
            "device_kind": device_kind(device),
            "seed": args.seed,
            "search": bench_search(args.budget, args.seed, args.devices),
            "train": bench_train(args.steps, args.epochs, args.seed,
                                 device=device),
            "serve": bench_serve(args.requests, seed=args.seed,
                                 device=device),
        }
    finally:
        log.level = prev_level
    text = json.dumps(payload, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
