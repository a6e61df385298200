"""The port's command line (``flexflow_tpu_torch/cli.py``) and
``FFConfig.parse_args`` against the JAX package's, on the CPU.

``parse_args`` is held flag by flag over the JAX parser's whole flag set:
each flag gives equal ``FFConfig`` fields in both packages and each bad
value the same ValueError.  The runner runs a script in a subprocess with
the parsed flags installed (``FFModel()`` picks them up) on
``--device cpu``, and without it on a machine with no card stops with
``default_device()``'s error.  ``lint --json`` and ``explain --json``
print what the port's verifier and ``explain_report`` give when called
directly, with the JAX CLI's keys; ``lint --calibration`` hands the
table's ``xla_temp_factor`` to the memory gate as ``temp_factor``.
``serve-bench --generate`` (with ``--prefix`` and ``--speculate``),
``--fleet`` and ``--disagg`` exit 0 on ``--device cpu`` with their
bench's payload (the verbs of the tooling plane:
``tests/test_torch_tooling.py``; the benches against the JAX package's:
``tests/test_torch_gen_bench.py``, ``tests/test_torch_fleet_bench.py``,
``tests/test_torch_disagg_bench.py``).
"""

import dataclasses
import inspect
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one case a flag (and every spelling) of the JAX package's parser, with
# the unknown-flag pass-through and a full reference command line
FLAG_CASES = [
    ["-e", "5"], ["--epochs", "3"], ["-b", "128"], ["--batch-size", "7"],
    ["--lr", "0.1"], ["--learning-rate", "0.3"], ["--wd", "0.001"],
    ["--weight-decay", "0.2"], ["-p", "3"], ["--print-freq", "0"],
    ["-d", "data.npz"], ["--dataset", "d"], ["--budget", "100"],
    ["--alpha", "0.2"], ["--chains", "0"], ["--search-precision"],
    ["--search-mode", "HYBRID"], ["--best-known", "bk.json"],
    ["--reshard-budget", "5"], ["--calibration", "t.json"],
    ["--cost-estimator", "Table"], ["--overlap"], ["-s", "out.pb"],
    ["--export", "o.pb"], ["-import", "in.pb"], ["--import", "i.pb"],
    ["-ll:tpu", "4"], ["-ll:gpu", "2"], ["-ll:cpu", "3"],
    ["--nodes", "2"], ["--profiling"], ["--seed", "7"], ["--remat"],
    ["--conv-layout", "NHWC"], ["--accum-steps", "2"],
    ["--steps-per-dispatch", "4"], ["--pad-tail"],
    ["--serve-max-batch", "16"], ["--serve-max-wait-ms", "1.5"],
    ["--serve-buckets", "2,4"], ["--serve-quantize", "INT8"],
    ["--compute-dtype", "Float32"], ["--param-dtype", "bfloat16"],
    ["--serve-model-name", "m"], ["--serve-max-queue-rows", "9"],
    ["--serve-admission", "Reject"], ["--serve-starvation-ms", "3"],
    ["--serve-gen-slots", "4"], ["--serve-gen-max-seq", "64"],
    ["--serve-gen-max-new", "5"], ["--serve-kv-page", "8"],
    ["--serve-kv-pages", "40"], ["--serve-prefix-cache", "OFF"],
    ["--serve-prefill-chunk", "32"], ["--serve-spec-gamma", "3"],
    ["--serve-spec-gamma-max", "6"], ["--serve-spec-policy", "adaptive"],
    ["--trace-sample-rate", "0.5"], ["--metrics-port", "9090"],
    ["--metrics-host", "0.0.0.0"], ["-ll:fsize", "1024", "-b", "8"],
    ["-e", "5", "-b", "128", "--lr", "0.1", "--wd", "0.001", "-ll:gpu",
     "4", "--nodes", "2", "--budget", "100", "--alpha", "0.2",
     "--profiling", "-s", "out.pb", "-import", "in.pb", "--seed", "7",
     "-p", "3"],
]

BAD_CASES = [
    ["--search-mode", "anneal"], ["--serve-quantize", "int4"],
    ["--compute-dtype", "fp8"], ["--param-dtype", "int8"],
    ["--serve-prefix-cache", "maybe"], ["--serve-spec-policy", "greedy"],
    ["-e", "five"], ["--lr", "fast"],
]


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_flag_cases_cover_the_jax_parser():
    """Every flag the JAX parser reads has a case here."""
    src = inspect.getsource(ff.FFConfig.parse_args)
    flags = set(re.findall(r'"(-[-\w:]+)"', src))
    covered = {a for case in FLAG_CASES for a in case if a.startswith("-")}
    assert flags <= covered, sorted(flags - covered)
    assert ({f.name for f in dataclasses.fields(ft.FFConfig)}
            == {f.name for f in dataclasses.fields(ff.FFConfig)})


@pytest.mark.parametrize("argv", FLAG_CASES, ids=" ".join)
def test_parse_args_equals_the_jax_parser(argv):
    got = ft.FFConfig.parse_args(list(argv))
    want = ff.FFConfig.parse_args(list(argv))
    assert _fields(got) == _fields(want)
    assert got.num_devices == want.num_devices


@pytest.mark.parametrize("argv", BAD_CASES, ids=" ".join)
def test_parse_args_refuses_as_the_jax_parser(argv):
    with pytest.raises(ValueError) as want:
        ff.FFConfig.parse_args(list(argv))
    with pytest.raises(ValueError) as got:
        ft.FFConfig.parse_args(list(argv))
    assert str(got.value) == str(want.value)


def test_parse_args_reads_sys_argv(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train.py", "-b", "24", "-e", "2"])
    cfg = ft.FFConfig.parse_args()
    assert (cfg.batch_size, cfg.epochs) == (24, 2)


@pytest.mark.parametrize("dims", [(2, 1), (4, 2, 1), (1, 1, 3, 1)])
def test_parallel_config_num_parts_and_with_dims(dims):
    jpc = ff.ParallelConfig(dims=(1,) * len(dims), memory_types=(1,),
                            precision="bf16")
    ppc = ft.ParallelConfig(dims=(1,) * len(dims), memory_types=(1,),
                            precision="bf16")
    j, p = jpc.with_dims(dims), ppc.with_dims(dims)
    assert p.num_parts == j.num_parts == int(torch.tensor(dims).prod())
    assert (p.dims, p.device_ids, tuple(p.memory_types), p.precision) == (
        j.dims, j.device_ids, tuple(j.memory_types), j.precision)


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def _runner(args, env=None, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.cli", *args],
        capture_output=True, text=True, cwd=REPO, env=env or _env(),
        timeout=timeout)


SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import flexflow_tpu_torch as ft

    cfg = ft.get_default_config()
    assert cfg.batch_size == 16, cfg.batch_size
    assert cfg.epochs == 2, cfg.epochs
    assert sys.argv[1:] == ["-b", "16", "-e", "2"], sys.argv
    model = ft.FFModel()     # picks up the default config and device
    assert model.config.batch_size == 16 and model.device.type == "cpu"
    x = model.create_tensor((16, 8), name="x")
    t = model.dense(x, 16, activation="relu")
    t = model.dense(t, 4)
    model.compile(ft.SGDOptimizer(lr=0.1),
                  "sparse_categorical_crossentropy", [], final_tensor=t)
    model.init_layers(seed=0)
    rng = np.random.default_rng(0)
    loss = model.train_batch(
        rng.standard_normal((16, 8)).astype(np.float32),
        rng.integers(0, 4, (16, 1)).astype(np.int32))
    print("CLI_OK", float(loss))
""")


def test_runner_runs_script_with_default_config(tmp_path):
    """The runner executes a script with the parsed config and the
    device installed (the JAX runner's contract, plus --device)."""
    script = tmp_path / "train.py"
    script.write_text(SCRIPT)
    out = _runner(["--device", "cpu", str(script), "-b", "16", "-e", "2"])
    assert out.returncode == 0, out.stderr
    assert "CLI_OK" in out.stdout
    # the flags may come first too
    out = _runner(["-b", "16", "--device", "cpu", str(script), "-e", "2"])
    assert out.returncode == 0, out.stderr


def test_runner_script_crash_dumps_the_flight_ring(tmp_path):
    """A fatal exception in the script dumps the flight ring (the
    runner's excepthook) before the traceback."""
    script = tmp_path / "boom.py"
    script.write_text("raise RuntimeError('boom in the script')\n")
    out = _runner(["--device", "cpu", str(script)],
                  env=_env(FF_FLIGHT_DIR=str(tmp_path / "flight")))
    assert out.returncode == 1 and "boom in the script" in out.stderr
    dumps = os.listdir(tmp_path / "flight")
    assert len(dumps) == 1 and dumps[0].startswith(
        "flight_fatal_exception_")
    with open(tmp_path / "flight" / dumps[0]) as f:
        payload = json.load(f)
    assert payload["extra"]["type"] == "RuntimeError"


def test_runner_without_a_card_fails_loudly(tmp_path):
    """No card and no --device cpu: the runner stops with
    default_device()'s error and never runs the script on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = tmp_path / "train.py"
    script.write_text(SCRIPT)
    out = _runner([str(script), "-b", "16", "-e", "2"])
    assert out.returncode == 1
    assert "pass device='cpu'" in out.stderr
    assert "CLI_OK" not in out.stdout


@pytest.mark.parametrize("args", [
    ["--device", "tpu", "x.py"], ["--device"], ["-b", "16"]])
def test_runner_usage_errors_exit_2(args):
    with pytest.raises(SystemExit) as e:
        cli.main(args)
    assert e.value.code == 2


SERVE_BENCH_MODES = {
    "--generate": (["--generate", "--requests", "4", "--d-model", "16",
                    "--heads", "2", "--layers", "1", "--max-seq", "16",
                    "--long-new", "6", "--mults", "1"], "serve-generate"),
    "--prefix": (["--generate", "--prefix", "--requests", "4",
                  "--d-model", "16", "--heads", "2", "--layers", "1",
                  "--long-new", "4", "--slots", "2"], "gen-prefix"),
    "--speculate": (["--generate", "--speculate", "--requests", "2",
                     "--d-model", "16", "--heads", "2", "--layers", "2",
                     "--max-seq", "16", "--new-tokens", "4",
                     "--slots", "2"], "gen-spec"),
    "--fleet": (["--fleet", "--requests", "16", "--cell-seconds", "0.1",
                 "--hidden-a", "8", "--hidden-b", "8", "--max-batch", "4"],
                "fleet-bench"),
    "--disagg": (["--disagg", "--requests", "1", "--prompt-lo", "20",
                  "--prompt-hi", "24", "--victim-new", "8", "--slots", "2",
                  "--max-seq", "48", "--d-model", "16", "--num-heads", "2",
                  "--layers", "1", "--repeats", "1", "--chunks", "8",
                  "--pf-chunk", "8"], "disagg"),
}


@pytest.mark.parametrize("mode", sorted(SERVE_BENCH_MODES))
def test_serve_bench_modes_run_on_the_cpu(mode, capsys):
    """Each of serve-bench's bench modes exits 0 on ``--device cpu`` and
    prints its bench's JSON payload."""
    from flexflow_tpu_torch.fflogger import silenced
    args, bench = SERVE_BENCH_MODES[mode]
    try:
        with silenced("ff", "serve"):
            rc, out = _run_main(["serve-bench", *args, "--device", "cpu"],
                                capsys)
    finally:
        ft.set_default_device(None)
    assert rc == 0
    payload = json.loads(out)
    assert payload["bench"] == bench and payload["backend"] == "cpu"


def _run_main(argv, capsys, main=cli.main):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code, capsys.readouterr().out


def _alexnet_strategy(tmp_path, degree=4):
    from flexflow_tpu_torch.strategy.proto import save_strategy_file
    m = ft.build_alexnet(ft.FFConfig(batch_size=64), device="cpu")[0]
    path = str(tmp_path / "dp.pb")
    save_strategy_file(path, {
        op.name: ft.ParallelConfig.data_parallel(
            degree, op.outputs[0].num_dims) for op in m.layers})
    return m, path


def test_lint_json_equals_the_verifier_and_the_jax_keys(tmp_path, capsys):
    """``lint --json`` prints the port's verifier report for the same
    graph and strategy, with the JAX CLI's keys."""
    from flexflow_tpu.cli import main as jax_main
    from flexflow_tpu_torch.analysis import verify
    from flexflow_tpu_torch.strategy.proto import load_strategy_file
    m, path = _alexnet_strategy(tmp_path)
    rc, out = _run_main(["lint", "--model", "alexnet", "--strategy", path,
                         "--json"], capsys)
    got = json.loads(out)
    want = verify(m.layers, load_strategy_file(path),
                  input_tensors=m.input_tensors,
                  final_tensors=m.layers[-1].outputs,
                  parameters=m.parameters)
    assert got == json.loads(want.render_json())
    assert rc == (1 if want.errors else 0)
    jrc, jout = _run_main(["lint", "--model", "alexnet", "--strategy",
                           path, "--json"], capsys, jax_main)
    jgot = json.loads(jout)
    assert set(got) == set(jgot)
    assert all(set(d) == set(jgot["diagnostics"][0])
               for d in got["diagnostics"]) or not jgot["diagnostics"]
    assert {d["code"] for d in got["diagnostics"]} == {
        d["code"] for d in jgot["diagnostics"]}


def test_explain_json_equals_explain_report_and_the_jax_keys(capsys):
    """``explain --json`` prints the port's ``explain_report`` for the
    same graph and mesh, with the JAX CLI's keys."""
    from flexflow_tpu.cli import main as jax_main
    from flexflow_tpu_torch.analysis import explain_report
    rc, out = _run_main(["explain", "--model", "transformer", "--mesh",
                         "n=4", "--json"], capsys)
    assert rc == 0
    got = json.loads(out)
    m = ft.build_transformer(ft.FFConfig(batch_size=64), device="cpu")[0]
    want = explain_report("transformer", m.layers, None,
                          mesh_shape={"n": 4})
    assert got == json.loads(json.dumps(want))
    jrc, jout = _run_main(["explain", "--model", "transformer", "--mesh",
                           "n=4", "--json"], capsys, jax_main)
    jgot = json.loads(jout)
    assert jrc == 0 and set(got) == set(jgot)
    for key, value in jgot.items():
        if isinstance(value, dict):
            assert set(got[key]) == set(value), key


def test_explain_text_and_out_file(tmp_path, capsys):
    out_path = str(tmp_path / "rep.json")
    rc, out = _run_main(["explain", "--model", "alexnet", "--out",
                         out_path], capsys)
    assert rc == 0 and "alexnet" in out
    from flexflow_tpu_torch.analysis import validate_explain_json
    with open(out_path) as f:
        assert validate_explain_json(json.load(f)) == []


def _table(tmp_path, factor):
    from flexflow_tpu_torch.search.calibration import CalibrationTable
    t = CalibrationTable(device_kind="NVIDIA H100 80GB HBM3")
    t.xla_temp_factor = factor
    path = str(tmp_path / f"t{factor}.json")
    t.save(path)
    return path


def test_lint_calibration_maps_xla_temp_factor(tmp_path, capsys):
    """The table's ``xla_temp_factor`` reaches the memory gate as the
    spec's ``temp_factor``: a factor past the card's memory turns FF108
    into an error, the table's own factor leaves it clean, and the JSON
    equals the verifier called with the mapped spec."""
    from flexflow_tpu_torch.analysis import verify
    from flexflow_tpu_torch.search.calibration import (CalibrationTable,
                                                       calibrated_spec)
    from flexflow_tpu_torch.strategy.proto import load_strategy_file
    m, path = _alexnet_strategy(tmp_path)
    for factor, code in ((2.5, 0), (5000.0, 1)):
        table = _table(tmp_path, factor)
        spec = cli._load_calibration(table, "lint")
        assert spec.temp_factor == factor
        assert spec == dataclasses.replace(
            calibrated_spec(CalibrationTable.load(table)),
            temp_factor=factor)
        rc, out = _run_main(["lint", "--model", "alexnet", "--strategy",
                             path, "--calibration", table, "--json"],
                            capsys)
        assert rc == code
        want = verify(m.layers, load_strategy_file(path),
                      input_tensors=m.input_tensors,
                      final_tensors=m.layers[-1].outputs,
                      parameters=m.parameters, spec=spec)
        assert json.loads(out) == json.loads(want.render_json())
        ff108 = [d for d in json.loads(out)["diagnostics"]
                 if d["code"] == "FF108"]
        assert bool(ff108) == bool(code)
    rc, _ = _run_main(["lint", "--model", "alexnet", "--calibration",
                       str(tmp_path / "missing.json")], capsys)
    assert rc == 2


@pytest.mark.parametrize("args", [
    ["lint"], ["lint", "--model", "vgg"], ["explain"],
    ["explain", "--model", "vgg"],
    ["lint", "--model", "alexnet", "--mesh", "n=four"],
    ["explain", "--model", "alexnet", "--strategy", "/nonexistent.pb"],
    ["lint", "--model", "transformer", "--serve-kv-page", "-1"]])
def test_lint_and_explain_usage_errors_exit_2(args, capsys):
    rc, _ = _run_main(args, capsys)
    assert rc == 2


def test_calibrate_check_and_search_bench_verbs(capsys):
    """``calibrate --check`` validates the seed table; ``search-bench``
    prints its JSON payload, priced for the CPU here."""
    seed = os.path.join(REPO, "flexflow_tpu_torch", "search",
                        "calibration_seed.json")
    rc, _ = _run_main(["calibrate", "--check", seed], capsys)
    assert rc == 0
    cli.main(["search-bench", "--devices", "4", "--steps", "8",
              "--budget", "8", "--graphs", "mlp", "--min-time", "0.01",
              "--device", "cpu"])
    payload = json.loads(capsys.readouterr().out)
    assert payload["results"][0]["graph"] == "mlp"


ELASTIC_SCRIPT = textwrap.dedent("""
    import os
    import torch.distributed as dist
    import flexflow_tpu_torch as ft

    assert dist.is_initialized() and dist.get_world_size() == 2
    assert ft.get_default_config().batch_size == 8
    assert ft.FFModel().device.type == "cpu"
    open(os.path.join(os.environ["FF_ELASTIC_WORKDIR"],
                      f"rank{dist.get_rank()}"), "w").close()
""")


def test_elastic_runs_workers_through_the_runner(tmp_path):
    """``elastic --nprocs 2 -- --device cpu script.py -b 8``: each worker
    is the runner with torchrun's variables, so its process group comes
    up (gloo on the CPU) and the flags reach its default config."""
    script = tmp_path / "worker.py"
    script.write_text(ELASTIC_SCRIPT)
    work = tmp_path / "work"
    out = _runner(["elastic", "--nprocs", "2", "--max-restarts", "0",
                   "--attempt-timeout", "200", "--workdir", str(work),
                   "--", "--device", "cpu", str(script), "-b", "8"])
    assert out.returncode == 0, out.stderr
    assert "elastic: success after 0 restart(s)" in out.stderr
    assert sorted(os.listdir(work)) == ["rank0", "rank1"]
