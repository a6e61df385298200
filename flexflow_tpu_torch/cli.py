"""``flexflow-tpu-torch`` console entry, the port of ``flexflow_tpu/cli.py``
— the reference's ``flexflow_python`` runner (python/Makefile,
flexflow_top.py:164-220): parses the FlexFlow flag set into an FFConfig,
installs it as the process default, and executes the user script.

    flexflow-tpu-torch my_model.py -b 64 -e 10 --lr 0.01
    python -m flexflow_tpu_torch.cli --device cpu my_model.py -b 16

The script runs under CPython with ``FFConfig.parse_args``'s result
available via :func:`flexflow_tpu_torch.get_default_config` (``FFModel()``,
keras ``compile`` and ``nn_compat.Module`` read it; scripts may also call
``FFConfig.parse_args()`` themselves, same flags).  ``--device cuda|cpu``
(by default what ``FLEXFLOW_PLATFORM`` names, else cuda) installs the
device entry points run on; without a card and without ``--device cpu``
the runner stops with ``default_device()``'s error rather than fall back
to the CPU.  The script's ``flexflow_tpu`` imports resolve to the port
(``script_imports.py``), so the repo's ``examples/`` run unchanged;
``import jax`` in it raises ImportError, and a process that already
holds jax or the JAX package exits 2.

Built-in verbs: ``lint`` (``--concurrency``: the lock-discipline pass
over the port's tree, ``analysis/concurrency.py``) and ``explain``
(device-free, over the port's ``analysis``), ``elastic`` (over
``parallel.elastic.run_elastic``), ``calibrate``, ``calibrate-bench``
(``search.calibration``), ``search-bench`` (``search.bench``),
``trace`` (``obs.trace.trace_main``: export or summarise a raw span
file) and ``flight`` (``obs.flight.flight_main``: find and show flight
dumps), and the benches ``train-bench`` (``train_bench``),
``serve-bench`` (``serving.bench``) and ``precision-bench``
(``precision_bench``), which take ``--device`` like a script and run on
the card by default.  ``--metrics-port P`` (with ``--metrics-host``,
loopback by default) serves the process metrics registry at
``GET /metrics`` while the script runs.
"""

from __future__ import annotations

import os
import runpy
import sys

from .config import FFConfig

PROG = "flexflow-tpu-torch"

# the benches among the verbs: each takes --device (the card by default)
BENCHES = {
    "train-bench": "train_bench",
    "serve-bench": "serving.bench",
    "precision-bench": "precision_bench",
}


def _usage() -> str:
    return (f"usage: {PROG} [--device cuda|cpu] <script.py> "
            f"[FlexFlow flags]\n"
            f"       {PROG} elastic [supervisor flags] -- <script.py> "
            f"[script args]\n"
            f"       {PROG} search-bench [flags]\n"
            f"       {PROG} train-bench [--device cuda|cpu] [flags]\n"
            f"       {PROG} serve-bench [--overload | --generate "
            f"[--prefix | --speculate] | --fleet | --disagg] "
            f"[--device cuda|cpu] [flags]\n"
            f"       {PROG} precision-bench [--device cuda|cpu] "
            f"[--out f.json]\n"
            f"       {PROG} calibrate [--out table.json | --check "
            f"FILE...] [--device cuda|cpu]\n"
            f"       {PROG} calibrate-bench --table table.json "
            f"[--out report.json]\n"
            f"       {PROG} lint --model NAME [--strategy s.pb] "
            f"[--devices N] [--json]\n"
            f"       {PROG} lint --fleet fleet.json [--hbm-gb G] [--json]\n"
            f"       {PROG} explain --model NAME [--strategy s.pb] "
            f"[--mesh n=4,c=2] [--json]\n"
            f"       {PROG} explain --fleet fleet.json [--json]\n"
            f"       {PROG} lint --concurrency [--json]\n"
            f"       {PROG} trace export RAW.json [--out f.json] | "
            f"trace summary RAW.json\n"
            f"       {PROG} flight dump|show [--dir D]\n"
            "flags (reference model.cc:1221-1289): -e -b --lr --wd -d "
            "--budget --alpha --search-mode --best-known "
            "--reshard-budget -s/-import -ll:gpu "
            "-ll:cpu --nodes --profiling --seed --remat "
            "--steps-per-dispatch --pad-tail --calibration "
            "--cost-estimator "
            "--serve-max-batch --serve-max-wait-ms --serve-buckets "
            "--serve-max-queue-rows --serve-admission "
            "--serve-starvation-ms --trace-sample-rate --metrics-port "
            "--metrics-host")


def _take_device(argv):
    """(argv without ``--device X``, X or None); exits 2 on a bad or
    missing value."""
    if "--device" not in argv:
        return argv, None
    i = argv.index("--device")
    if i + 1 >= len(argv) or argv[i + 1] not in ("cuda", "cpu"):
        print(f"{PROG}: --device takes cuda or cpu", file=sys.stderr)
        raise SystemExit(2)
    return argv[:i] + argv[i + 2:], argv[i + 1]


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    # built-in subcommands (no user script involved)
    if argv and argv[0] == "search-bench":
        # search-throughput microbenchmark: delta vs full re-simulation
        # (JSON to stdout)
        from .search.bench import main as bench_main
        bench_main(argv[1:])
        return
    if argv and argv[0] in BENCHES:
        raise SystemExit(run_bench(argv[0], argv[1:]))
    if argv and argv[0] == "trace":
        # export/inspect recorded request-span traces (host files only:
        # --device is taken and has nothing to select)
        from .obs.trace import trace_main
        raise SystemExit(trace_main(_take_device(argv[1:])[0]))
    if argv and argv[0] == "flight":
        # flight-recorder post-mortem dumps (host files only)
        from .obs.flight import flight_main
        raise SystemExit(flight_main(_take_device(argv[1:])[0]))
    if argv and argv[0] == "calibrate":
        # harvest measured op/dispatch timings into a CalibrationTable,
        # or --check existing artifacts
        from .search.calibration import calibrate_main
        raise SystemExit(calibrate_main(argv[1:]))
    if argv and argv[0] == "calibrate-bench":
        # sim-vs-measured MAPE sweep, analytic vs calibrated estimators
        from .search.calibration import calibrate_bench_main
        raise SystemExit(calibrate_bench_main(argv[1:]))
    if argv and argv[0] == "elastic":
        # supervised multi-process training with restart-from-checkpoint
        raise SystemExit(elastic_main(argv[1:]))
    if argv and argv[0] == "lint":
        # static strategy/graph verifier
        raise SystemExit(lint_main(argv[1:]))
    if argv and argv[0] == "explain":
        # device-free sharding/communication/memory report for a
        # strategy on a mesh you may not own yet
        raise SystemExit(explain_main(argv[1:]))
    argv, device = _take_device(argv)
    script = None
    for a in argv:
        if a.endswith(".py"):
            script = a
            break
    if script is None:
        print(_usage(), file=sys.stderr)
        raise SystemExit(2)
    flags = [a for a in argv if a != script]
    from . import script_imports
    mixing = script_imports.mixing_error()
    if mixing:
        print(f"{PROG}: {mixing}", file=sys.stderr)
        raise SystemExit(2)
    cfg = FFConfig.parse_args(flags)
    from .config import set_default_config
    _install_device(device)
    set_default_config(cfg)
    # a fatal uncaught exception in the user script dumps the flight
    # ring before the traceback prints; --metrics-port exposes the
    # process registry
    from .obs.flight import install_excepthook
    install_excepthook()
    if cfg.metrics_port > 0:
        from .obs.registry import start_metrics_server
        server = start_metrics_server(cfg.metrics_port,
                                      host=cfg.metrics_host)
        print(f"[obs] metrics on {cfg.metrics_host}:"
              f"{server.server_port}/metrics", file=sys.stderr)
    # bring up the process group when this is one rank of a world
    # (torchrun's or the elastic supervisor's variables; a single
    # process is a no-op).  --nodes > 1 makes the multi-process
    # requirement explicit: the world is one rank a device of every
    # node, and failing to form it is an error, not disconnected
    # replicas.
    from .parallel.distributed import initialize_distributed
    initialize_distributed(
        world_size=cfg.num_devices if cfg.num_nodes > 1 else None,
        device_type=device)
    # the script sees the remaining argv like any __main__, and its
    # flexflow_tpu imports resolve to the port (script_imports.py)
    sys.argv = [script] + flags
    script_imports.install(script)
    runpy.run_path(script, run_name="__main__")


def _install_device(device) -> None:
    """Install ``device``, where given, as the process default (else the
    default stays what ``FLEXFLOW_PLATFORM`` installed at import, or the
    card); with no card and no ``--device cpu`` exit 1 with
    ``default_device()``'s error, running nothing."""
    from .config import set_default_device
    from .model import default_device
    if device:
        set_default_device(device)
    try:
        default_device()
    except RuntimeError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        raise SystemExit(1)


def run_bench(verb: str, argv) -> int:
    """Run the bench ``verb`` on the runner's ``--device`` (the card by
    default); returns its exit code."""
    import importlib

    argv, device = _take_device(list(argv))
    _install_device(device)
    mod = importlib.import_module(f".{BENCHES[verb]}", __package__)
    mod.main(argv)
    return 0


def _lint_builders():
    """Builtin-model registry for ``lint``/``explain``: name -> builder
    of the graph (on the CPU: nothing is allocated or run).  Lazy
    imports keep ``lint --help`` fast."""
    from .models import (build_alexnet, build_candle_uno, build_dlrm,
                         build_inception_v3, build_nmt, build_resnet50,
                         build_transformer)
    cpu = "cpu"
    return {
        "transformer": lambda cfg: build_transformer(cfg, device=cpu)[0],
        # 8 tables make the default interact width (8*64+64) match
        # mlp_top[0]=576 (the reference run-script shape)
        "dlrm": lambda cfg: build_dlrm(
            cfg, embedding_size=(1000000,) * 8, device=cpu)[0],
        "alexnet": lambda cfg: build_alexnet(cfg, device=cpu)[0],
        "resnet": lambda cfg: build_resnet50(cfg, device=cpu)[0],
        "inception": lambda cfg: build_inception_v3(cfg, device=cpu)[0],
        "nmt": lambda cfg: build_nmt(cfg, device=cpu)[0],
        "candle_uno": lambda cfg: build_candle_uno(cfg, device=cpu)[0],
    }


def _load_calibration(path: str, what: str):
    """The DeviceSpec of a CalibrationTable: its measured spec overrides,
    and its ``xla_temp_factor`` (the JAX package's name for the measured
    peak over the analytic high-water, which its CLI hands the memory
    gate) as the port's ``DeviceSpec.temp_factor``, the factor the gate
    charges.  None on a load failure (printed)."""
    import dataclasses

    from .search.calibration import CalibrationTable, calibrated_spec
    try:
        table = CalibrationTable.load(path)
    except (OSError, ValueError) as e:
        print(f"{what}: cannot load {path}: {e}", file=sys.stderr)
        return None
    spec = calibrated_spec(table)
    if table.xla_temp_factor:
        spec = dataclasses.replace(spec,
                                   temp_factor=float(table.xla_temp_factor))
    return spec


def _parse_mesh(text: str, what: str):
    """``n=4,c=2`` as {axis: size}; None after printing the problem."""
    from .parallel.mesh import AbstractMesh
    try:
        mesh_shape = {k: int(v) for k, v in
                      (kv.split("=") for kv in text.split(","))}
        AbstractMesh(mesh_shape)  # axis-name/size validation
    except ValueError as e:
        print(f"{what}: bad --mesh {text!r} (want n=4,c=2): {e}",
              file=sys.stderr)
        return None
    return mesh_shape


def _load_strategies(path: str, what: str):
    """(ok, strategies or None): the strategy file, or None without one."""
    if not path:
        return True, None
    from .strategy.proto import load_strategy_file
    try:
        return True, load_strategy_file(path)
    except (OSError, ValueError) as e:
        print(f"{what}: cannot load {path}: {e}", file=sys.stderr)
        return False, None


def lint_main(argv) -> int:
    """``flexflow-tpu-torch lint --model transformer --strategy s.pb``:
    run the static verifier (flexflow_tpu_torch.analysis) over a builtin
    model graph + a strategy file and print structured FFxxx
    diagnostics.  Exit codes: 0 clean (INFO/WARN only), 1 any ERROR
    diagnostic, 2 usage/load failure.  Entirely device-free: a
    1024-device strategy lints on a laptop (no mesh is built, nothing
    runs)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog=f"{PROG} lint",
        description="statically verify a strategy against a builtin "
                    "model graph, or a whole model fleet's co-residency "
                    "(--fleet)")
    parser.add_argument("--model",
                        help=f"builtin graph: "
                             f"{', '.join(sorted(_lint_builders()))}")
    parser.add_argument("--fleet", default="",
                        help="fleet registry JSON: run the static "
                             "co-residency gate over every tenant "
                             "(summed FF108 + KV bytes vs the device "
                             "memory budget — FF130 on overflow) instead "
                             "of a single-model lint")
    parser.add_argument("--strategy", default="",
                        help="strategy .pb (reference wire format); "
                             "omit to lint the graph alone")
    parser.add_argument("--devices", type=int, default=0,
                        help="machine size device ids must fit "
                             "(default: inferred mesh product)")
    parser.add_argument("--mesh", default="",
                        help="mesh factorization, e.g. n=4,c=2 "
                             "(default: inferred from the strategy)")
    parser.add_argument("-b", "--batch-size", type=int, default=64)
    parser.add_argument("--hbm-gb", type=float, default=0.0,
                        help="per-device memory budget override in GB "
                             "(default: attached/assumed device spec)")
    parser.add_argument("--calibration", default="",
                        help="CalibrationTable JSON (calibrate): applies "
                             "its measured DeviceSpec overrides and "
                             "xla_temp_factor (as the spec's "
                             "temp_factor) to the FF108 memory pass, so "
                             "lint judges the same calibrated budget "
                             "the search does")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable report on stdout")
    parser.add_argument("--concurrency", action="store_true",
                        help="run the whole-program lock-discipline "
                             "pass (FF150-FF154) over flexflow_tpu_torch/ "
                             "instead of a model/strategy lint")
    parser.add_argument("--no-resharding", action="store_true",
                        help="skip the FF109 hotspot report")
    parser.add_argument("--serve-slots", type=int, default=0,
                        help="size a token-generation deployment: add "
                             "the KV cache for N concurrent decode "
                             "slots to the FF108/FF121 memory gates")
    parser.add_argument("--serve-seq", type=int, default=0,
                        help="generation cache length per slot "
                             "(default: the model's sequence length)")
    parser.add_argument("--serve-kv-page", type=int, default=0,
                        help="KV page size of the deployment being "
                             "sized (default: the engine default) — "
                             "pass the same value the engine runs "
                             "with, or lint charges a different pool")
    parser.add_argument("--serve-kv-pages", type=int, default=0,
                        help="KV pool pages (0 = auto, the dense "
                             "worst case slots x ceil(seq/page))")
    args = parser.parse_args(argv)

    if args.concurrency:
        from .analysis.concurrency import concurrency_main
        return concurrency_main(as_json=args.json)
    if args.fleet:
        return _lint_fleet(args)
    builders = _lint_builders()
    if args.model is None:
        print("lint: --model is required (or --fleet / --concurrency "
              "for the whole-tree gates)", file=sys.stderr)
        return 2
    if args.model not in builders:
        print(f"lint: unknown model {args.model!r} (have "
              f"{', '.join(sorted(builders))})", file=sys.stderr)
        return 2
    cfg = FFConfig(batch_size=args.batch_size)
    model = builders[args.model](cfg)

    ok, strategies = _load_strategies(args.strategy, "lint")
    if not ok:
        return 2
    mesh_shape = None
    if args.mesh:
        mesh_shape = _parse_mesh(args.mesh, "lint")
        if mesh_shape is None:
            return 2

    spec = None
    if args.calibration:
        spec = _load_calibration(args.calibration, "lint")
        if spec is None:
            return 2
    if args.hbm_gb > 0:
        import dataclasses

        from .search.cost_model import spec_for_device
        spec = dataclasses.replace(spec or spec_for_device(),
                                   hbm_capacity=args.hbm_gb * 1e9)

    kv_bytes = 0.0
    if args.serve_kv_page < 0 or args.serve_kv_pages < 0:
        print("lint: --serve-kv-page/--serve-kv-pages must be >= 0 "
              "(0 = default/auto)", file=sys.stderr)
        return 2
    if args.serve_slots > 0:
        # the generation engine's preallocated KV cache — the SAME
        # scalar the runtime reports (analysis.kv_memory), so the FF108
        # gate and the engine cannot disagree about deployment fit
        from .analysis.kv_memory import (default_serve_seq, dtype_bytes,
                                         kv_cache_bytes)
        seq = args.serve_seq or default_serve_seq(model.input_tensors)
        if not seq or seq <= 0:
            print("lint: --serve-slots needs --serve-seq (the model "
                  "has no sequence-shaped input to default from)",
                  file=sys.stderr)
            return 2
        shape_for_kv = mesh_shape
        if shape_for_kv is None:
            from .analysis.strategy_passes import infer_mesh_shape
            shape_for_kv, _ = infer_mesh_shape(
                strategies or {}, model.layers, args.devices or 10 ** 9)
        kv_bytes = kv_cache_bytes(
            model.layers, shape_for_kv, args.serve_slots, seq,
            kv_dtype_bytes=dtype_bytes(cfg.compute_dtype),
            page_size=args.serve_kv_page,
            num_pages=args.serve_kv_pages)

    from .analysis import verify
    report = verify(
        model.layers, strategies, mesh_shape=mesh_shape,
        num_devices=args.devices or None,
        input_tensors=model.input_tensors,
        final_tensors=model.layers[-1].outputs if model.layers else (),
        parameters=model.parameters, spec=spec,
        check_resharding=not args.no_resharding,
        extra_state_bytes=kv_bytes)
    print(report.render_json() if args.json else report.render_text())
    return 1 if report.errors else 0


def _load_fleet_registry(path: str, what: str):
    """Load + schema-validate a fleet registry JSON for lint/explain
    (returns the registry or prints the problems and returns None)."""
    import json as _json

    from .serving.fleet import ModelRegistry, validate_fleet_json
    try:
        with open(path) as f:
            obj = _json.load(f)
    except (OSError, ValueError) as e:
        print(f"{what}: cannot load {path}: {e}", file=sys.stderr)
        return None
    probs = validate_fleet_json(obj)
    if probs:
        for p in probs:
            print(f"{what}: {path}: {p}", file=sys.stderr)
        return None
    try:
        return ModelRegistry.from_json(obj)
    except ValueError as e:
        print(f"{what}: {path}: {e}", file=sys.stderr)
        return None


def _lint_fleet(args) -> int:
    """``lint --fleet fleet.json``: the device-free co-residency gate —
    does the whole fleet FIT in the device's memory?  Sums the
    FF108-accounted per-device peak (+ KV caches for generation tenants)
    across every tenant; exit 1 on FF130 (over budget), with an FF131
    INFO breakdown row per tenant either way."""
    registry = _load_fleet_registry(args.fleet, "lint")
    if registry is None:
        return 2
    spec = None
    if args.calibration:
        spec = _load_calibration(args.calibration, "lint")
        if spec is None:
            return 2
    hbm_gb = args.hbm_gb if args.hbm_gb > 0 else registry.hbm_gb
    from .serving.fleet import fleet_gate_report
    report, _rows = fleet_gate_report(registry, hbm_gb=hbm_gb,
                                      device_spec=spec)
    print(report.render_json() if args.json else report.render_text())
    return 1 if report.errors else 0


def explain_main(argv) -> int:
    """``flexflow-tpu-torch explain --model M --strategy s.pb --mesh
    n=16,c=4``: the static what-will-the-runtime-do report — propagated
    shardings, predicted FF120 replicate fallbacks, the per-edge
    communication plan (reshard/allgather/allreduce volumes +
    ``comm_plan_digest``), and the liveness memory timeline with its
    peak-owning ops.  Entirely device-free.  Exit codes: 0 report
    produced, 2 usage/load failure (unlike lint, explain REPORTS — it
    does not gate; run lint for the pass/fail judgement)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog=f"{PROG} explain",
        description="device-free sharding / communication / memory "
                    "report for a strategy")
    parser.add_argument("--model",
                        help=f"builtin graph: "
                             f"{', '.join(sorted(_lint_builders()))}")
    parser.add_argument("--fleet", default="",
                        help="fleet registry JSON: report every "
                             "tenant's per-device residency breakdown "
                             "(params + KV + FF108 peak) and the fleet "
                             "total instead of a single-model report")
    parser.add_argument("--strategy", default="",
                        help="strategy .pb; omit for the default "
                             "data-parallel plan")
    parser.add_argument("--mesh", default="",
                        help="mesh factorization, e.g. n=16,c=4 "
                             "(default: inferred from the strategy)")
    parser.add_argument("--devices", type=int, default=0,
                        help="machine size (default: mesh product)")
    parser.add_argument("-b", "--batch-size", type=int, default=64)
    parser.add_argument("--hbm-gb", type=float, default=0.0,
                        help="per-device memory budget override in GB")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable report on stdout")
    parser.add_argument("--out", default="",
                        help="also write the JSON report here")
    parser.add_argument("--serve-slots", type=int, default=0,
                        help="size a token-generation deployment: "
                             "report the KV cache for N decode slots "
                             "inside the memory timeline")
    parser.add_argument("--serve-seq", type=int, default=0,
                        help="generation cache length per slot "
                             "(default: the model's sequence length)")
    parser.add_argument("--serve-kv-page", type=int, default=0,
                        help="KV page size of the deployment being "
                             "explained (default: the engine default)")
    parser.add_argument("--serve-kv-pages", type=int, default=0,
                        help="KV pool pages (0 = auto, the dense "
                             "worst case)")
    args = parser.parse_args(argv)

    if args.fleet:
        return _explain_fleet(args)
    builders = _lint_builders()
    if args.model is None:
        print("explain: --model is required (or --fleet for the "
              "residency breakdown)", file=sys.stderr)
        return 2
    if args.model not in builders:
        print(f"explain: unknown model {args.model!r} (have "
              f"{', '.join(sorted(builders))})", file=sys.stderr)
        return 2
    cfg = FFConfig(batch_size=args.batch_size)
    model = builders[args.model](cfg)

    ok, strategies = _load_strategies(args.strategy, "explain")
    if not ok:
        return 2
    mesh_shape = None
    if args.mesh:
        mesh_shape = _parse_mesh(args.mesh, "explain")
        if mesh_shape is None:
            return 2

    spec = None
    if args.hbm_gb > 0:
        import dataclasses

        from .search.cost_model import spec_for_device
        spec = dataclasses.replace(spec_for_device(),
                                   hbm_capacity=args.hbm_gb * 1e9)

    if args.serve_kv_page < 0 or args.serve_kv_pages < 0:
        print("explain: --serve-kv-page/--serve-kv-pages must be >= 0 "
              "(0 = default/auto)", file=sys.stderr)
        return 2
    serve_seq = args.serve_seq
    if args.serve_slots > 0 and serve_seq <= 0:
        from .analysis.kv_memory import default_serve_seq
        serve_seq = default_serve_seq(model.input_tensors) or 0
        if serve_seq <= 0:
            print("explain: --serve-slots needs --serve-seq (the model "
                  "has no sequence-shaped input to default from)",
                  file=sys.stderr)
            return 2

    from .analysis import explain_report, render_explain_text
    rep = explain_report(
        args.model, model.layers, strategies, mesh_shape=mesh_shape,
        num_devices=args.devices or None, spec=spec,
        serve_slots=args.serve_slots, serve_seq=serve_seq,
        serve_kv_page=args.serve_kv_page,
        serve_kv_pages=args.serve_kv_pages)
    _emit(rep, args, render_explain_text)
    return 0


def _emit(rep, args, render) -> None:
    """Print an explain payload (JSON or text) and write ``--out``."""
    import json as _json
    print(_json.dumps(rep, indent=2) if args.json else render(rep))
    if args.out:
        with open(args.out, "w") as f:
            f.write(_json.dumps(rep, indent=2) + "\n")
        print(f"# wrote {args.out}", file=sys.stderr)


def _explain_fleet(args) -> int:
    """``explain --fleet fleet.json``: per-tenant residency breakdown
    (params / KV / FF108 peak bytes, each tenant's mesh) + the fleet
    total vs the memory budget — the report half of the co-residency
    gate (run ``lint --fleet`` for the pass/fail judgement)."""
    registry = _load_fleet_registry(args.fleet, "explain")
    if registry is None:
        return 2
    from .serving.fleet import fleet_gate_report
    from .serving.fleet.gate import resolve_budget
    hbm_gb = args.hbm_gb or registry.hbm_gb
    report, rows = fleet_gate_report(registry, hbm_gb=hbm_gb)
    # the verdict IS the gate's: FF130 present <=> over budget — the
    # report half must never re-derive (and potentially contradict)
    # what lint --fleet gates on
    budget = resolve_budget(hbm_gb)
    total = sum(r["ff108_bytes"] for r in rows)
    rep = {
        "fleet": args.fleet,
        "hbm_budget_gb": round(budget / 1e9, 3),
        "total_gb": round(total / 1e9, 3),
        "fits": not report.errors,
        "tenants": rows,
    }

    def render(rep):
        lines = [f"fleet {args.fleet}: {len(rows)} tenant(s), "
                 f"{rep['total_gb']} GB / {rep['hbm_budget_gb']} GB "
                 f"budget — {'FITS' if rep['fits'] else 'OVER'}"]
        for r in rows:
            kv = (f", kv {r['kv_bytes'] / 1e9:.3f} GB "
                  f"({r['kv_slots']}x{r['kv_seq']})"
                  if r["kv_bytes"] else "")
            lines.append(
                f"  {r['name']} [{r['engine']}] mesh {r['mesh']}: "
                f"peak {r['ff108_bytes'] / 1e9:.3f} GB (params "
                f"{r['params_bytes'] / 1e9:.3f} GB{kv})")
        return "\n".join(lines)

    _emit(rep, args, render)
    return 0


def elastic_main(argv) -> int:
    """``flexflow-tpu-torch elastic [flags] -- <script.py> [script
    args]``: run ``--nprocs`` copies of the script under the elastic
    supervisor (``parallel/elastic.py``) — heartbeat hang detection,
    failure classification, backoff-with-jitter restarts, degrade and
    planned resizes.

    Each worker runs ``python -m flexflow_tpu_torch.cli`` on the script
    (so FlexFlow flags after it parse into the default FFConfig) with
    torchrun's variables in its environment (a fresh port per attempt),
    which the runner's ``initialize_distributed()`` picks up.  Scripts
    resume via ``resilience.elastic_resume(model, workdir)``; the
    supervisor exports ``FF_ELASTIC_WORKDIR`` from ``--workdir``, and
    ``FF_ELASTIC_CKPT_DIR`` (where ranks save before a planned resize)
    as the same directory.  Returns the process exit code (0 on
    recovered success)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog=f"{PROG} elastic",
        description="supervise an elastic multi-process training run")
    parser.add_argument("--nprocs", type=int, default=1,
                        help="worker processes per attempt")
    parser.add_argument("--max-restarts", type=int, default=2)
    parser.add_argument("--attempt-timeout", type=float, default=3600.0,
                        metavar="S")
    parser.add_argument("--hang-timeout", type=float, default=None,
                        metavar="S",
                        help="kill an attempt when no rank's heartbeat "
                             "step advances for S seconds (off unless "
                             "set; workers must beat via "
                             "flexflow_tpu_torch.resilience.Heartbeat)")
    parser.add_argument("--workdir", default=".",
                        help="checkpoint directory exported to workers "
                             "as FF_ELASTIC_WORKDIR")
    parser.add_argument("--min-procs", type=int, default=None,
                        help="degrade-and-continue floor: after "
                             "--degrade-after consecutive crash/hang/"
                             "timeout attempts, HALVE the group (not "
                             "below this) and resume on the surviving "
                             "mesh instead of retrying the dead "
                             "topology")
    parser.add_argument("--degrade-after", type=int, default=2,
                        metavar="N",
                        help="consecutive topology-class failures "
                             "before a degrade step (default 2)")
    parser.add_argument("--backoff-base", type=float, default=0.5,
                        metavar="S")
    parser.add_argument("--backoff-max", type=float, default=30.0,
                        metavar="S")
    parser.add_argument("--backoff-seed", type=int, default=0)
    if "--" not in argv:
        parser.error(f"separate the worker script with '--': "
                     f"{PROG} elastic --nprocs 2 -- train.py -b 64")
    split = argv.index("--")
    args = parser.parse_args(argv[:split])
    worker_cmd = argv[split + 1:]
    if not worker_cmd:
        parser.error("no worker script given after '--'")

    from .parallel.elastic import run_elastic

    # a missing checkpoint dir would fail every attempt's first save
    os.makedirs(args.workdir, exist_ok=True)
    workdir = os.path.abspath(args.workdir)

    def worker_argv(attempt, port, rank):
        # through the runner, not bare python: FlexFlow flags after the
        # script still parse into the default FFConfig, and main()'s
        # initialize_distributed() reads torchrun's variables
        return [sys.executable, "-m", "flexflow_tpu_torch.cli", *worker_cmd]

    report = run_elastic(
        worker_argv, num_processes=args.nprocs,
        max_restarts=args.max_restarts,
        attempt_timeout_s=args.attempt_timeout,
        hang_timeout_s=args.hang_timeout,
        env={"FF_ELASTIC_WORKDIR": workdir},
        backoff_base_s=args.backoff_base, backoff_max_s=args.backoff_max,
        backoff_seed=args.backoff_seed,
        min_processes=args.min_procs, degrade_after=args.degrade_after,
        checkpoint_dir=workdir)
    for i, a in enumerate(report.attempts):
        steps = (" steps=" + ",".join(
            f"r{r}:{s}" for r, s in sorted(a.rank_steps.items()))
            if a.rank_steps else "")
        detail = f" ({a.spawn_error})" if a.spawn_error else ""
        print(f"elastic attempt {i}: cause={a.cause} "
              f"nprocs={a.num_processes} "
              f"rc={a.returncodes} elapsed={a.elapsed_s}s"
              f"{steps}{detail}", file=sys.stderr)
        if a.cause != "ok" and a.failed_rank is not None:
            tail = a.tails.get(a.failed_rank, "").strip()
            if tail:
                print(f"  rank {a.failed_rank} tail: ...{tail[-400:]}",
                      file=sys.stderr)
    if report.success:
        print(f"elastic: success after {report.restarts} restart(s)",
              file=sys.stderr)
        return 0
    print("elastic: FAILED"
          + (" (fail-fast: instant all-rank crash on attempt 0 — "
             "likely an argv/config error)" if report.fail_fast else
             f" after {len(report.attempts)} attempt(s)"),
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    main()
