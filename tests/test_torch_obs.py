"""The port's observability plane and event layer against the JAX
package's, on the CPU: ``flexflow_tpu_torch.fflogger`` (capture, taps,
mute, levels), ``obs.trace`` (systematic sampling, the span ring, the raw
and Chrome-trace schemas), ``obs.registry`` (rendering and the Prometheus
validator), ``obs.flight`` (the ring and the dump schema),
``obs.lockwatch`` and ``obs.events``.  Where both packages run the same
operations, their outputs are held equal.  Then the port's engines on
the plane: the serving metrics are views over the registry, engine spans
reconcile with the counters, and the serving events carry the JAX names
and fields (``quantize_weights`` among them).
"""

import json
import threading

import numpy as np
import pytest

import flexflow_tpu as ff
from flexflow_tpu import fflogger as jax_fflogger
from flexflow_tpu.obs import events as jax_events
from flexflow_tpu.obs.flight import \
    validate_flight_dump as jax_validate_flight_dump
from flexflow_tpu.obs.registry import MetricsRegistry as JaxRegistry
from flexflow_tpu.obs.registry import \
    validate_prometheus_text as jax_validate_prometheus
from flexflow_tpu.obs.trace import Tracer as JaxTracer
from flexflow_tpu.obs.trace import to_chrome as jax_to_chrome
from flexflow_tpu.obs.trace import validate_raw_trace as jax_validate_raw
from flexflow_tpu.parallel.mesh import MachineMesh
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import fflogger
from flexflow_tpu_torch.obs import events, lockwatch
from flexflow_tpu_torch.obs.flight import (FlightRecorder,
                                           validate_flight_dump)
from flexflow_tpu_torch.obs.registry import (MetricsRegistry, get_registry,
                                             validate_prometheus_text)
from flexflow_tpu_torch.obs.trace import (Tracer, get_tracer, phase_of,
                                          to_chrome, validate_chrome_trace,
                                          validate_raw_trace)
from flexflow_tpu_torch.serving import (DeadlineExceeded, OverloadError,
                                        ServingEngine, SheddedError)
from flexflow_tpu_torch.serving.metrics import ServingMetrics

BS, NFEAT, NCLS = 8, 12, 5


@pytest.fixture
def tracer():
    """The process tracer at rate 1.0, cleaned up after."""
    tr = get_tracer()
    tr.reset()
    tr.configure(sample_rate=1.0)
    yield tr
    tr.disable()
    tr.reset()


def _dense(seed=0):
    cfg = ft.FFConfig(batch_size=BS, compute_dtype="float32", seed=seed)
    m = ft.FFModel(cfg, device="cpu")
    x = m.create_tensor((BS, NFEAT), name="x")
    t = m.dense(x, 24, activation="relu")
    m.dense(t, NCLS)
    m.compile()
    m.init_layers(seed=seed)
    return m


def _rows(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, NFEAT)).astype(np.float32)


# ----------------------------------------------------------------------
# fflogger
# ----------------------------------------------------------------------
def test_event_json_line_and_capture_mute(capsys):
    log = fflogger.get_logger("serve")
    with fflogger.capture_events("serve") as ev:
        log.event("serve_stats", model="m", qps=1.5)
    assert capsys.readouterr().out == ""          # muted while captured
    assert [e["event"] for e in ev] == ["serve_stats"]
    assert ev[0]["cat"] == "serve" and ev[0]["model"] == "m"
    assert isinstance(ev[0]["t_ns"], int)
    log.event("serve_stats", model="m")
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["event"] == "serve_stats" and rec["cat"] == "serve"
    # the same record keys as the JAX logger's
    with jax_fflogger.capture_events("serve") as jev:
        jax_fflogger.get_logger("serve").event("serve_stats", model="m")
    assert set(jev[0]) == set(rec)


def test_capture_filters_nests_and_survives_silenced(capsys):
    with fflogger.silenced("serve"), \
            fflogger.capture_events("serve", mute=False) as outer, \
            fflogger.capture_events("obs") as inner:
        fflogger.get_logger("serve").event("serve_health", state="x")
        fflogger.get_logger("obs").event("flight_dump", reason="r")
    assert [e["event"] for e in outer] == ["serve_health"]
    assert [e["event"] for e in inner] == ["flight_dump"]
    # silenced: the un-muted serve event printed nothing either
    assert capsys.readouterr().out == ""


def test_taps_see_every_event_and_a_broken_tap_is_harmless():
    seen = []

    def bad(rec):
        raise RuntimeError("broken tap")

    fflogger.add_tap(seen.append)
    fflogger.add_tap(bad)
    fflogger.add_tap(seen.append)      # idempotent
    try:
        with fflogger.capture_events():
            fflogger.get_logger("serve").event("router_start", hosts={})
    finally:
        fflogger.remove_tap(seen.append)
        fflogger.remove_tap(bad)
    assert [r["event"] for r in seen] == ["router_start"]
    with fflogger.capture_events():
        fflogger.get_logger("serve").event("router_stop")
    assert len(seen) == 1


def test_capture_registration_threadsafe_under_emitters():
    stop = threading.Event()

    def emit():
        log = fflogger.get_logger("serve")
        while not stop.is_set():
            log.event("serve_stats", model="t")

    threads = [threading.Thread(target=emit) for _ in range(2)]
    with fflogger.silenced("serve"):
        for t in threads:
            t.start()
        try:
            for _ in range(200):
                with fflogger.capture_events("serve") as ev:
                    pass
                assert all(e["event"] == "serve_stats" for e in ev)
        finally:
            stop.set()
            for t in threads:
                t.join()


@pytest.mark.parametrize("env,want", [
    ({}, 20), ({"FF_LOG_LEVEL": "debug"}, 10),
    ({"FF_LOG_LEVEL": "none"}, 100),
    ({"FF_LOG_LEVELS": "serve=error"}, 40),
    ({"FF_LOG_LEVEL": "warning", "FF_LOG_LEVELS": "other=debug"}, 30)])
def test_category_levels_equal_jax(monkeypatch, env, want):
    for k in ("FF_LOG_LEVEL", "FF_LOG_LEVELS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert fflogger.Category("serve").level == want
    assert jax_fflogger.Category("serve").level == want


def test_declared_events_equal_jax():
    assert events.EVENTS == jax_events.EVENTS
    assert events.declared_events() == jax_events.declared_events()


# ----------------------------------------------------------------------
# tracer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("rate", [0.25, 0.3, 1.0])
def test_tracer_systematic_sampling_equals_jax(rate):
    tr, jtr = Tracer().configure(sample_rate=rate), \
        JaxTracer().configure(sample_rate=rate)
    ids = [tr.new_trace() for _ in range(40)]
    jids = [jtr.new_trace() for _ in range(40)]
    assert ids == jids
    assert sum(i is not None for i in ids) == int(40 * rate + 1e-9)


def test_tracer_off_allocates_nothing():
    tr = Tracer()
    assert tr.new_trace() is None
    tr.span("request", "t1", 0.0, 1.0, phase="completed")
    assert tr.snapshot()["spans"] == []
    with pytest.raises(ValueError, match="trace_sample_rate"):
        tr.configure(sample_rate=1.5)


def test_tracer_ring_bounded_and_dropped_counted():
    tr = Tracer(capacity=3).configure(sample_rate=1.0)
    for i in range(5):
        tr.span("decode_step", None, float(i), i + 0.5, step=i)
    snap = tr.snapshot()
    assert [s["args"]["step"] for s in snap["spans"]] == [2, 3, 4]
    assert snap["dropped"] == 2


def _spans(tr):
    tr.span("queue", "t1", 1.0, 1.25, tid="m", dispatch=0)
    tr.span("request", "t1", 1.0, 2.0, tid="m", phase="completed",
            rows=3)
    tr.span("request", "t2", 1.5, 2.5, tid="m", phase="shed")
    tr.span("decode_step", None, 2.0, 2.001, step=7)


def test_raw_and_chrome_exports_equal_jax():
    tr = Tracer().configure(sample_rate=1.0)
    jtr = JaxTracer().configure(sample_rate=1.0)
    _spans(tr)
    _spans(jtr)
    raw, jraw = tr.snapshot(), jtr.snapshot()
    assert raw["spans"] == jraw["spans"]
    assert validate_raw_trace(raw) == [] == jax_validate_raw(raw)
    assert tr.terminal_phase_counts() == {"completed": 1, "shed": 1}
    chrome = to_chrome(raw)
    assert validate_chrome_trace(chrome) == []
    jchrome = jax_to_chrome(jraw)
    strip = [dict(e, pid=0) for e in chrome["traceEvents"]]
    assert strip == [dict(e, pid=0) for e in jchrome["traceEvents"]]
    # defects are caught
    bad = dict(raw, spans=[{"name": "request", "t0_ns": 5, "t1_ns": 1,
                            "args": {"phase": "nope"}}])
    probs = validate_raw_trace(bad)
    assert probs == jax_validate_raw(bad)
    assert any("ends before" in p for p in probs)
    assert any("terminal phase" in p for p in probs)
    assert validate_chrome_trace({"traceEvents": [{"ph": "X"}]})


@pytest.mark.parametrize("exc,phase", [
    (DeadlineExceeded("x"), "expired"), (SheddedError("x"), "shed"),
    (OverloadError("x"), "rejected"), (RuntimeError("x"), "error")])
def test_phase_of_classifies_as_jax(exc, phase):
    assert phase_of(exc) == phase


def test_tracer_save_round_trips(tmp_path):
    tr = Tracer().configure(sample_rate=1.0)
    _spans(tr)
    path = tmp_path / "raw.json"
    snap = tr.save(str(path))
    assert json.loads(path.read_text()) == snap


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------
def _fill(reg):
    c = reg.counter("ff_test_total", "help text", ("model",))
    c.labels(model="a").inc(3)
    c.labels(model="b").inc()
    reg.gauge("ff_test_depth", "live depth").labels().set_fn(lambda: 7)
    reg.counter("ff_test_tiny_total", "tiny").labels().inc(4.5e-05)
    h = reg.histogram("ff_test_lat_seconds", "latency", (),
                      buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.labels().observe(v)
    return c


def test_registry_render_equals_jax():
    reg, jreg = MetricsRegistry(), JaxRegistry()
    c = _fill(reg)
    _fill(jreg)
    text = reg.render()
    assert text == jreg.render()
    assert 'ff_test_lat_seconds_bucket{le="+Inf"} 3' in text
    assert validate_prometheus_text(text) == []
    assert c.total() == 4
    assert reg.counter("ff_test_total", "help text", ("model",)) is c
    with pytest.raises(ValueError, match="already declared"):
        reg.gauge("ff_test_total", "x", ("model",))
    with pytest.raises(ValueError, match="wants labels"):
        c.labels(tenant="a")
    c.remove(model="a")
    assert c.total() == 1


@pytest.mark.parametrize("text", [
    "garbage line here\n", "ff_x 1\n",
    "# TYPE ff_h histogram\nff_h_bucket{le=\"+Inf\"} 2\nff_h_sum 1\n"
    "ff_h_count 3\n",
    "# TYPE ff_h histogram\nff_h_sum 1\nff_h_count 3\n",
    "# TYPE ff_c counter\nff_c{a=\"b\"} 1.5e-05\n"])
def test_prometheus_validator_equals_jax(text):
    assert validate_prometheus_text(text) == jax_validate_prometheus(text)


def test_serving_metrics_are_views_over_registry():
    m1 = ServingMetrics(model="twin")
    m2 = ServingMetrics(model="twin")
    m1.record_submitted()
    m1.record_request(0.01)
    m2.record_submitted()
    m2.record_rejected()
    assert (m1.snapshot()["requests"], m1.snapshot()["rejected"]) == (1, 0)
    assert (m2.snapshot()["requests"], m2.snapshot()["rejected"]) == (0, 1)
    text = get_registry().render()
    assert (f'ff_serve_requests_total{{model="twin",eng="{m1.eng_id}"}} 1'
            in text)
    assert (f'ff_serve_rejected_total{{model="twin",eng="{m2.eng_id}"}} 1'
            in text)
    assert validate_prometheus_text(text) == []


def test_metrics_unregister_reclaims_series():
    m = ServingMetrics(model="ephemeral")
    m.record_submitted()
    needle = (f'ff_serve_submitted_total{{model="ephemeral",'
              f'eng="{m.eng_id}"}}')
    assert needle in get_registry().render()
    m.unregister()
    assert needle not in get_registry().render()
    assert m.total_submitted == 1
    m.record_submitted()
    assert m.total_submitted == 2


def test_engine_stop_releases_registry_hooks():
    eng = ServingEngine(_dense(), stats_every=0)
    with fflogger.silenced("serve"), eng:
        eng.submit(_rows(4)).result(timeout=60)
    m = eng.metrics
    assert m.queue_depth_fn is None
    assert m._ctr["queue_depth"]._fn is None
    assert m.total_requests == 1
    m.release()
    assert m.total_requests == 1


def test_registry_keeps_no_engine_alive():
    """An engine whose construction raised after its metrics registered
    (here a violated int8 quality bound) is not kept alive by the
    process registry's live queue-depth gauge."""
    import gc
    import weakref

    model = _dense()
    model.config.serve_quantize = "int8"
    model.quantize_weights("int8")
    saved = model._quant_report
    model._quant_report = dict(saved, bound_ok=False)
    before = {id(o) for o in gc.get_objects()
              if isinstance(o, ServingMetrics)}
    with pytest.raises(RuntimeError, match="quality bound"):
        ServingEngine(model, stats_every=0)
    model._quant_report = saved
    orphans = [weakref.ref(o) for o in gc.get_objects()
               if isinstance(o, ServingMetrics) and id(o) not in before]
    assert orphans
    gc.collect()
    assert all(r() is None for r in orphans)
    assert validate_prometheus_text(get_registry().render()) == []


# ----------------------------------------------------------------------
# flight recorder and lockwatch
# ----------------------------------------------------------------------
def test_flight_ring_bounded_and_dump_schema(tmp_path):
    rec = FlightRecorder(capacity=4)
    for i in range(6):
        rec.record_event({"event": "serve_stats", "i": i})
    rec.record_span({"name": "request", "t0_ns": 0, "t1_ns": 1})
    assert len(rec.snapshot()) == 4
    assert rec.dump("test", directory="") is None   # no directory: none
    with fflogger.capture_events("obs") as ev:
        path = rec.dump("test", directory=str(tmp_path),
                        extra={"model": "m"})
    obj = json.loads(open(path).read())
    assert validate_flight_dump(obj) == [] == jax_validate_flight_dump(obj)
    assert obj["reason"] == "test" and obj["extra"] == {"model": "m"}
    assert [r["kind"] for r in obj["records"]][-1] == "span"
    assert [e["event"] for e in ev] == ["flight_dump"]
    # rate limited per reason, forced through
    assert rec.dump("test", directory=str(tmp_path)) is None
    assert rec.dump("test", directory=str(tmp_path), force=True)
    assert validate_flight_dump({"schema": "x"})


def test_lockwatch_records_edges_and_finds_cycles(monkeypatch):
    monkeypatch.setenv("FF_LOCKWATCH", "1")
    lockwatch.reset()
    a, b = lockwatch.lock("T.a"), lockwatch.lock("T.b")
    cv = lockwatch.condition("T.cv")
    with a:
        with b:
            pass
    with cv:
        with a:
            pass
    rep = lockwatch.report()
    assert {("T.a", "T.b"), ("T.cv", "T.a")} <= lockwatch.edges()
    assert rep["cycle"] is None and rep["holds"]["T.a"]["count"] == 2
    assert lockwatch.find_cycle({("x", "y"), ("y", "x")}) == ["x", "y", "x"]
    reg = MetricsRegistry()
    lockwatch.publish(reg)
    assert validate_prometheus_text(reg.render()) == []
    lockwatch.reset()
    monkeypatch.delenv("FF_LOCKWATCH")
    assert type(lockwatch.lock("T.c")) is type(threading.Lock())


# ----------------------------------------------------------------------
# the engines on the plane
# ----------------------------------------------------------------------
def test_engine_spans_reconcile_with_counters(tracer):
    model = _dense()
    sizes = [1, 3, BS, BS + 5, 2]          # an oversize request splits
    with fflogger.silenced("serve"), \
            ServingEngine(model, stats_every=0) as eng:
        outs = [eng.submit(x).result(timeout=60)
                for x in (_rows(s, seed=i) for i, s in enumerate(sizes))]
        snap = eng.stats()
    for i, (s, out) in enumerate(zip(sizes, outs)):
        np.testing.assert_array_equal(out, model.predict(
            _rows(s, seed=i), batch_size=BS))
    counts = tracer.terminal_phase_counts()
    assert counts == {"completed": len(sizes)} and snap["requests"] == 5
    names = {s["name"] for s in tracer.snapshot()["spans"]}
    assert {"queue", "pack", "dispatch", "fetch", "scatter",
            "request"} <= names


def test_serve_events_carry_jax_names_and_model_tag():
    with fflogger.capture_events("serve") as ev:
        with ServingEngine(_dense(), name="ranker", stats_every=1) as eng:
            eng.submit(_rows(4)).result(timeout=60)
        eng.drain()
    kinds = [e["event"] for e in ev]
    assert "serve_stats" in kinds and "serve_health" in kinds
    assert all(e["model"] == "ranker" for e in ev)
    health = [(e["prev"], e["state"]) for e in ev
              if e["event"] == "serve_health"]
    assert health[0] == ("starting", "serving")
    assert health[-1][1] == "stopped"
    final = [e for e in ev if e["event"] == "serve_stats" and e.get("final")]
    assert len(final) == 1 and final[0]["requests"] == 1
    assert final[0]["eng"] == eng.metrics.eng_id


def test_quantize_weights_event_equals_jax():
    def jax_model():
        cfg = ff.FFConfig(batch_size=BS, compute_dtype="float32")
        m = ff.FFModel(cfg, mesh=MachineMesh({"n": 1}))
        x = m.create_tensor((BS, NFEAT), name="x")
        t = m.dense(x, 24, activation="relu")
        m.dense(t, NCLS)
        m.compile(ff.SGDOptimizer(lr=0.1))
        m.init_layers(seed=0)
        return m

    jm, tm = jax_model(), _dense()
    for p in jm.parameters:
        tm.set_weights(p.name, jm.get_weights(p.name))
    with jax_fflogger.capture_events("serve") as jev:
        jm.quantize_weights("int8")
    with fflogger.capture_events("serve") as tev:
        tm.quantize_weights("int8")
    (j,), (t,) = jev, tev
    assert j["event"] == t["event"] == "quantize_weights"
    drop = ("t", "t_ns", "max_abs_err", "error_bound")
    assert ({k: v for k, v in t.items() if k not in drop}
            == {k: v for k, v in j.items() if k not in drop})
    assert t["max_abs_err"] == pytest.approx(j["max_abs_err"], rel=1e-5)
