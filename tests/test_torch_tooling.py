"""The port's tooling plane against the JAX package's, on the CPU.

* ``trace_main`` and ``flight_main`` of both packages, run on the same
  files (valid, invalid, missing, an empty directory), print the same
  stdout and return the same exit codes.
* ``start_metrics_server`` serves ``render()`` bit for bit, answers 404
  off ``/metrics``, and two registries fed the same series serve the
  same text in both packages.
* ``fit`` records as many ``train_window`` spans as the JAX ``fit`` on
  the same data, with the same ``epoch``, ``step0`` and ``steps``, at
  ``steps_per_dispatch`` 2 and 4 with a padded tail; the one-step path
  records none, as in the JAX package.  ``trace_dir`` writes a
  ``torch.profiler`` Chrome trace that ``json.load`` reads, with the
  ``train_window#<step>`` (or ``train#<step>``) ranges in it.
* ``warmup_compile`` leaves parameters, optimizer state and the step
  counter bit-equal, and names the kernel libraries a step launches.
* The runner's ``trace``, ``flight``, ``--metrics-port`` and bench verbs
  exit as the JAX runner's do; ``serve-bench --generate``, ``--fleet``
  and ``--disagg`` reach their own parsers, whose usage errors exit 2
  as the JAX runner's.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu import cli as jax_cli
from flexflow_tpu.obs import flight as jax_flight
from flexflow_tpu.obs import registry as jax_registry
from flexflow_tpu.obs import trace as jax_trace
from flexflow_tpu.parallel.mesh import MachineMesh
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import cli
from flexflow_tpu_torch.fflogger import silenced
from flexflow_tpu_torch.obs import flight as port_flight
from flexflow_tpu_torch.obs import registry as port_registry
from flexflow_tpu_torch.obs import trace as port_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS, NFEAT, NCLS = 4, 8, 3


@pytest.fixture(autouse=True)
def _no_default_device():
    yield
    ft.set_default_device(None)


def _call(main, argv):
    """(exit code, stdout) of a CLI entry point; a normal return is 0."""
    out = io.StringIO()
    err = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return (0 if rc is None else rc), out.getvalue()


# ---------------------------------------------------------------------------
# trace and flight CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trace_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("traces")
    tr = port_trace.Tracer()
    tr.configure(sample_rate=1.0)
    for i, phase in enumerate(("completed", "completed", "shed")):
        tid = tr.new_trace()
        tr.span("queue", tid, 1.0 + i, 1.25 + i)
        tr.span("request", tid, 1.0 + i, 1.5 + i, phase=phase)
    tr.span("dispatch", None, 1.1, 1.2, cat="serve", tid="dispatcher")
    tr.save(str(d / "raw.json"))
    bad = json.loads((d / "raw.json").read_text())
    bad["spans"][1]["args"]["phase"] = "vanished"
    (d / "bad_phase.json").write_text(json.dumps(bad))
    (d / "bad_schema.json").write_text(json.dumps({"schema": "x",
                                                   "spans": []}))
    (d / "not_json.json").write_text("{not json")
    return d


@pytest.mark.parametrize("argv", [
    ["export", "raw.json"], ["summary", "raw.json"],
    ["export", "bad_phase.json"], ["summary", "bad_schema.json"],
    ["export", "not_json.json"], ["export", "missing.json"], []],
    ids=lambda a: "-".join(a) or "no-verb")
def test_trace_main_equals_the_jax_cli(trace_files, argv):
    argv = [str(trace_files / a) if a.endswith(".json") else a
            for a in argv]
    got = _call(port_trace.trace_main, argv)
    assert got == _call(jax_trace.trace_main, argv)
    if argv and argv[0] == "export" and got[0] == 0:
        chrome = json.loads(got[1])
        assert port_trace.validate_chrome_trace(chrome) == []
        assert len(chrome["traceEvents"]) == 7


def test_trace_export_out_file_equals_the_jax_cli(trace_files, tmp_path):
    outs = []
    for name, main in (("port", port_trace.trace_main),
                       ("jax", jax_trace.trace_main)):
        out = tmp_path / f"{name}.json"
        assert _call(main, ["export", str(trace_files / "raw.json"),
                            "--out", str(out)]) == (0, "")
        outs.append(out.read_text())
    assert outs[0] == outs[1]


@pytest.fixture(scope="module")
def flight_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("flight")
    rec = port_flight.FlightRecorder()
    rec.record_event({"cat": "serve", "event": "serve_health",
                      "t": 1.0, "state": "degraded"})
    rec.record_span({"name": "dispatch", "trace": "t00000001",
                     "t0_ns": 1000, "t1_ns": 251000, "args": {"rows": 4}})
    with silenced("obs"):
        assert rec.dump("probe", directory=str(d / "dumps"), force=True)
    (d / "empty").mkdir()
    (d / "bad.json").write_text(json.dumps({"schema": "ff-flight-v1"}))
    return d


@pytest.mark.parametrize("argv", [
    ["dump", "--dir", "dumps"], ["dump", "--dir", "dumps", "--json"],
    ["show", "--dir", "dumps"], ["show", "--dir", "dumps", "--last", "1"],
    ["show", "--dir", "dumps", "--last", "0"], ["dump", "--dir", "empty"],
    ["show", "bad.json"], ["show", "missing.json"], ["dump"], []],
    ids=lambda a: "-".join(a) or "no-verb")
def test_flight_main_equals_the_jax_cli(flight_dir, argv, monkeypatch):
    monkeypatch.delenv("FF_FLIGHT_DIR", raising=False)
    argv = [str(flight_dir / a) if a in ("dumps", "empty")
            or a.endswith(".json") else a for a in argv]
    got = _call(port_flight.flight_main, argv)
    assert got == _call(jax_flight.flight_main, argv)
    want_rc = {"empty": 1, "bad.json": 1, "missing.json": 1}
    rcs = [rc for k, rc in want_rc.items() if any(a.endswith(k)
                                                  for a in argv)]
    assert got[0] == (rcs[0] if rcs else (0 if len(argv) > 1 else 2))


def test_flight_dump_reads_the_env_directory(flight_dir, monkeypatch):
    monkeypatch.setenv("FF_FLIGHT_DIR", str(flight_dir / "dumps"))
    got = _call(port_flight.flight_main, ["dump"])
    assert got == _call(jax_flight.flight_main, ["dump"])
    assert got[0] == 0 and got[1].strip().startswith(
        str(flight_dir / "dumps" / "flight_probe_"))


# ---------------------------------------------------------------------------
# the metrics endpoint
# ---------------------------------------------------------------------------

def _feed(mod):
    reg = mod.MetricsRegistry()
    reg.counter("ff_serve_requests_total", "Requests",
                ("model", "eng")).labels(model="a", eng="1").inc(3)
    reg.gauge("ff_train_dispatch_ms", "Mean ms").labels().set(2.5)
    h = reg.histogram("ff_serve_latency_seconds", "Latency", ("model",))
    for v in (0.0007, 0.003, 0.2):
        h.labels(model="a").observe(v)
    return reg


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_metrics_server_serves_render_bit_for_bit():
    reg = _feed(port_registry)
    server = port_registry.start_metrics_server(0, registry=reg)
    try:
        assert server.server_address[0] == "127.0.0.1"
        status, ctype, body = _get(server.server_port, "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert body == reg.render().encode()
        assert port_registry.validate_prometheus_text(body.decode()) == []
        reg.counter("ff_serve_requests_total", "Requests",
                    ("model", "eng")).labels(model="a", eng="1").inc()
        assert _get(server.server_port, "/metrics?x=1")[2] == \
            reg.render().encode()
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.server_port, "/other")
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


def test_metrics_servers_of_both_packages_serve_the_same_text():
    texts = []
    for mod in (port_registry, jax_registry):
        server = mod.start_metrics_server(0, registry=_feed(mod))
        try:
            texts.append(_get(server.server_port, "/metrics")[2])
        finally:
            server.shutdown()
            server.server_close()
    assert texts[0] == texts[1] and b"ff_serve_latency_seconds_bucket" \
        in texts[0]


def test_start_metrics_server_is_exported():
    from flexflow_tpu_torch import obs
    assert obs.start_metrics_server is port_registry.start_metrics_server
    assert "start_metrics_server" in obs.__all__


# ---------------------------------------------------------------------------
# fit's spans, the profiler and warmup_compile
# ---------------------------------------------------------------------------

def _mlp(pkg, k=1, pad=False, rate=1.0, trace_dir=""):
    cfg = pkg.FFConfig(batch_size=BS, compute_dtype="float32")
    cfg.steps_per_dispatch = k
    cfg.pad_tail_batches = pad
    cfg.trace_sample_rate = rate
    cfg.trace_dir = trace_dir
    m = (ff.FFModel(cfg, mesh=MachineMesh({"n": 1})) if pkg is ff
         else ft.FFModel(cfg, device="cpu"))
    x = m.create_tensor((BS, NFEAT), name="x")
    t = m.dense(x, 16, activation="relu")
    t = m.dense(t, NCLS)
    m.compile(pkg.SGDOptimizer(lr=0.1), metrics=["accuracy"])
    m.init_layers(seed=0)
    return m


def _data(n=22):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, NFEAT)).astype(np.float32),
            rng.integers(0, NCLS, (n, 1)).astype(np.int32))


@pytest.fixture
def tracers():
    tracers = (port_trace.get_tracer(), jax_trace.get_tracer())
    for t in tracers:
        t.disable()
        t.reset()
    yield tracers
    for t in tracers:
        t.disable()
        t.reset()


def _windows(tracer):
    spans = tracer.snapshot()["spans"]
    assert all(s["name"] == "train_window" and s["cat"] == "train"
               and s["tid"] == "train" for s in spans), spans
    return [s.get("trace") for s in spans], [s["args"] for s in spans]


@pytest.mark.parametrize("k,pad", [(2, True), (4, True), (2, False),
                                   (1, True), (1, False)])
def test_fit_train_window_spans_equal_the_jax_fit(tracers, k, pad):
    x, y = _data()
    got = []
    for pkg, tracer in zip((ft, ff), tracers):
        m = _mlp(pkg, k=k, pad=pad)
        with contextlib.redirect_stdout(io.StringIO()):
            m.fit(x, y, epochs=2, verbose=False)
        got.append(_windows(tracer))
        tracer.reset()
    (port_ids, port_args), (jax_ids, jax_args) = got
    assert port_args == jax_args
    if k == 1 and not pad:
        assert port_args == []      # the one-step path records none
        return
    assert len(set(port_ids)) == 1 and port_ids[0] is not None
    steps = (22 if pad else 20) // BS + (1 if pad and 22 % BS else 0)
    assert sum(a["steps"] for a in port_args) == 2 * steps


def test_fit_spans_off_without_a_sample_rate(tracers):
    x, y = _data()
    m = _mlp(ft, k=2, rate=0.0)
    with contextlib.redirect_stdout(io.StringIO()):
        m.fit(x, y, epochs=1, verbose=False)
    assert tracers[0].snapshot()["spans"] == []


@pytest.mark.parametrize("k", [1, 2])
def test_trace_dir_writes_a_profiler_chrome_trace(tmp_path, tracers, k):
    x, y = _data(16)
    m = _mlp(ft, k=k, rate=0.0, trace_dir=str(tmp_path / "prof"))
    with contextlib.redirect_stdout(io.StringIO()):
        m.fit(x, y, epochs=1, verbose=False)
    files = os.listdir(tmp_path / "prof")
    assert [os.path.join(str(tmp_path / "prof"), f) for f in files] == \
        [m.last_trace_file]
    assert files[0].startswith(f"fit_rank0_{os.getpid()}_")
    assert files[0].endswith(".pt.trace.json")
    with open(m.last_trace_file) as f:
        events = json.load(f)["traceEvents"]
    label = "train_window" if k > 1 else "train"
    ranges = sorted(e["name"] for e in events
                    if e.get("name", "").startswith(f"{label}#"))
    starts = range(0, 4, k)
    assert ranges == sorted(f"{label}#{s}" for s in starts)
    # a second traced fit writes a file of its own
    with contextlib.redirect_stdout(io.StringIO()):
        m.fit(x, y, epochs=1, verbose=False)
    assert len(os.listdir(tmp_path / "prof")) == 2


def test_compile_accepts_trace_dir(tmp_path):
    m = _mlp(ft, trace_dir=str(tmp_path / "t"), rate=0.0)
    assert m.config.trace_dir and m.last_trace_file is None


def _state(m):
    params = {k: v.detach().clone() for k, v in m._params.items()}
    opt = [t.detach().clone() for t in
           torch.utils._pytree.tree_leaves(m._opt_state)
           if isinstance(t, torch.Tensor)]
    return params, opt, m._step


def test_warmup_compile_leaves_state_bit_equal():
    x, y = _data(16)
    m = _mlp(ft, k=2, rate=0.0)
    m.fit(x, y, epochs=1, verbose=False)
    before = _state(m)
    assert m.warmup_compile(x[:BS], y[:BS]) == []   # nothing on the CPU
    after = _state(m)
    assert before[2] == after[2] == 4
    for k in before[0]:
        assert torch.equal(before[0][k], after[0][k]), k
    assert len(before[1]) == len(after[1])
    for a, b in zip(before[1], after[1]):
        assert torch.equal(a, b)
    # the batch is checked as train_batch checks it
    m.config.gradient_accumulation_steps = 2
    with pytest.raises(ValueError, match="batch of 3"):
        m.warmup_compile(x[:3], y[:3])


def test_warmup_compile_refuses_an_uninitialised_model():
    cfg = ft.FFConfig(batch_size=BS, compute_dtype="float32")
    m = ft.FFModel(cfg, device="cpu")
    m.dense(m.create_tensor((BS, NFEAT), name="x"), NCLS)
    with pytest.raises(RuntimeError, match="init_layers"):
        m.warmup_compile()


@pytest.mark.parametrize("build,want", [
    (lambda cfg: ft.build_alexnet(cfg, num_classes=10, image_size=67,
                                  device="cpu")[0], ["max_pool_nhwc"]),
    (lambda cfg: ft.build_transformer(cfg, num_layers=1, d_model=32,
                                      num_heads=2, d_ff=64, seq_len=8,
                                      vocab_size=50, device="cpu")[0],
     ["flash_attention", "fused_layernorm"])],
    ids=["alexnet", "transformer"])
def test_kernel_libraries_name_what_a_step_launches(build, want):
    cfg = ft.FFConfig(batch_size=2)
    m = build(cfg)
    assert sorted({lib for op in m.layers
                   for lib in op.kernel_libraries(cfg)}) == want
    cfg.flash_attention = False
    assert "flash_attention" not in {lib for op in m.layers
                                     for lib in op.kernel_libraries(cfg)}


# ---------------------------------------------------------------------------
# the runner's verbs against the JAX runner's
# ---------------------------------------------------------------------------

def test_runner_trace_and_flight_verbs_equal_the_jax_runner(
        trace_files, flight_dir, monkeypatch):
    monkeypatch.delenv("FF_FLIGHT_DIR", raising=False)
    for argv in (["trace", "summary", str(trace_files / "raw.json")],
                 ["trace", "export", str(trace_files / "bad_phase.json")],
                 ["flight", "show", "--dir", str(flight_dir / "dumps")],
                 ["flight", "dump", "--dir", str(flight_dir / "empty")]):
        got = _call(cli.main, argv)
        assert got == _call(jax_cli.main, argv), argv
        # the runner's --device is taken by every verb
        assert _call(cli.main, argv + ["--device", "cpu"]) == got


@pytest.mark.parametrize("argv", [
    ["train-bench", "--ks", "0"], ["train-bench", "--bogus"],
    ["serve-bench", "--rows", "5-1"],
    ["serve-bench", "--overload", "--policies", "nope"],
    ["precision-bench", "--bogus"]],
    ids=lambda a: " ".join(a))
def test_runner_bench_usage_errors_equal_the_jax_runner(argv):
    rc, out = _call(cli.main, argv + ["--device", "cpu"])
    assert (rc, out) == _call(jax_cli.main, argv) and rc == 2


def test_runner_train_bench_exits_as_the_jax_runner():
    argv = ["train-bench", "--ks", "1,2", "--steps", "4", "--epochs", "1",
            "--hidden", "8"]
    rc, out = _call(cli.main, argv + ["--device", "cpu"])
    jrc, jout = _call(jax_cli.main, argv)
    assert rc == jrc == 0
    port, jax_ = json.loads(out), json.loads(jout)
    assert port["backend"] == "cpu" and port["device_kind"] == "cpu"
    assert [r["dispatches"] for r in port["results"]] == \
        [r["dispatches"] for r in jax_["results"]] == [4, 2]


def test_runner_benches_need_a_card_or_device_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for verb in ("train-bench", "serve-bench", "precision-bench"):
        with pytest.raises(SystemExit) as e:
            cli.main([verb])
        assert e.value.code == 1
        assert "pass device='cpu'" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["--generate", "--fleet", "--disagg"])
def test_serve_bench_modes_without_a_port_exit_2(mode, capsys):
    """Each bench mode reaches its own parser through the runner and
    through ``serving.bench.main``: a flag that parser does not know
    exits 2 as the JAX runner's does, naming the mode."""
    from flexflow_tpu.cli import main as jax_main
    from flexflow_tpu_torch.serving import bench
    with pytest.raises(SystemExit) as e:
        jax_main(["serve-bench", mode, "--bogus"])
    want = capsys.readouterr().err
    assert e.value.code == 2
    try:
        for main, argv in ((cli.main, ["serve-bench", mode, "--bogus",
                                       "--device", "cpu"]),
                           (bench.main, [mode, "--bogus"])):
            with pytest.raises(SystemExit) as e:
                main(argv)
            assert e.value.code == 2
            err = capsys.readouterr().err
            assert f"serve-bench {mode}: error: unrecognized arguments: " \
                "--bogus" in err
            assert err.splitlines()[-1] == \
                want.splitlines()[-1].replace("flexflow-tpu ",
                                              "flexflow-tpu-torch ")
    finally:
        ft.set_default_device(None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SCRAPE = textwrap.dedent("""
    import sys
    import urllib.request

    port = int(sys.argv[sys.argv.index("--metrics-port") + 1])
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        print("SCRAPE", r.status)
""")


def _runner(module, args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=240)


def test_runner_metrics_port_equals_the_jax_runner(tmp_path):
    script = tmp_path / "scrape.py"
    script.write_text(SCRAPE)
    for module, extra in (("flexflow_tpu_torch.cli", ["--device", "cpu"]),
                          ("flexflow_tpu.cli", [])):
        port = _free_port()
        out = _runner(module, extra + [str(script), "--metrics-port",
                                       str(port)],
                      {"JAX_PLATFORMS": "cpu"})
        assert out.returncode == 0, (module, out.stderr[-2000:])
        assert "SCRAPE 200" in out.stdout
        assert f"[obs] metrics on 127.0.0.1:{port}/metrics" in out.stderr


FIT_AND_SCRAPE = textwrap.dedent("""
    import json
    import urllib.request

    import numpy as np
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.obs.registry import validate_prometheus_text

    cfg = ft.get_default_config()
    m = ft.FFModel()
    x = m.create_tensor((cfg.batch_size, 8), name="x")
    m.dense(m.dense(x, 16, activation="relu"), 3)
    m.compile(ft.SGDOptimizer(lr=0.1), metrics=["accuracy"])
    m.init_layers(seed=0)
    rng = np.random.default_rng(0)
    m.fit(rng.standard_normal((8 * cfg.batch_size, 8)).astype(np.float32),
          rng.integers(0, 3, (8 * cfg.batch_size, 1)).astype(np.int32),
          epochs=1, verbose=False)
    url = f"http://{cfg.metrics_host}:{cfg.metrics_port}/metrics"
    text = urllib.request.urlopen(url, timeout=30).read().decode()
    print("SCRAPED " + json.dumps({
        "problems": validate_prometheus_text(text),
        "train": sorted({ln.split()[0] for ln in text.splitlines()
                         if ln.startswith("ff_train_")})}))
""")


def test_runner_metrics_port_serves_the_fit_counters(tmp_path):
    script = tmp_path / "fit.py"
    script.write_text(FIT_AND_SCRAPE)
    port = _free_port()
    out = _runner("flexflow_tpu_torch.cli",
                  ["--device", "cpu", str(script), "-b", "4",
                   "--metrics-port", str(port)])
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("SCRAPED ")]
    rec = json.loads(line[0][len("SCRAPED "):])
    assert rec["problems"] == []
    assert rec["train"] == ["ff_train_dispatch_ms",
                            "ff_train_dispatches_total",
                            "ff_train_samples_total",
                            "ff_train_steps_total"]
