"""The port's model fleet against the JAX package's, on the CPU: the
registry's schema errors equal the JAX validator's on the same JSON, the
shipped ``examples/serving/fleet.json`` is valid, two tenants serve with
parity, the weighted-fair scheduler and the QPS budget on an injected
clock, hot swap with zero failures and reconciled counters, the
generation swap, unload, the co-residency gate (its residency bytes
equal the engines' tensor bytes byte for byte and the JAX gate's rows
for the same registry), FF130 flipping with a draft, the ``model`` tag
on the serving events, and the fleet ``FF_FAULT`` kinds.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import flexflow_tpu as ff
from flexflow_tpu.models import build_transformer_lm as jax_build_lm
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu.serving.fleet import ModelRegistry as JaxRegistry
from flexflow_tpu.serving.fleet import \
    fleet_gate_report as jax_fleet_gate_report
from flexflow_tpu.serving.fleet import \
    validate_fleet_json as jax_validate_fleet_json
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import faults
from flexflow_tpu_torch.fflogger import capture_events, silenced
from flexflow_tpu_torch.serving import GenerationEngine, ServingEngine
from flexflow_tpu_torch.serving.errors import ServingError
from flexflow_tpu_torch.serving.fleet import (FleetEngine, ModelRegistry,
                                              builtin_builders,
                                              fleet_gate_report,
                                              model_residency,
                                              validate_fleet_json)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFEAT, NCLS = 12, 6


def _dense_builder(hidden, seed=0):
    def build(cfg, device):
        cfg.seed = seed
        m = ft.FFModel(cfg, device=device)
        x = m.create_tensor((cfg.batch_size, NFEAT), name="x")
        t = m.dense(x, hidden, activation="relu")
        m.dense(t, NCLS)
        return m
    return build


def _jax_dense_builder(hidden, seed=0):
    def build(cfg):
        cfg.seed = seed
        m = ff.FFModel(cfg, mesh=MachineMesh({"n": 1}))
        x = m.create_tensor((cfg.batch_size, NFEAT), name="x")
        t = m.dense(x, hidden, activation="relu")
        m.dense(t, NCLS)
        return m
    return build


def _lm_builder(cfg, device):
    return ft.build_transformer_lm(cfg, num_layers=1, d_model=32,
                                   num_heads=2, d_ff=64, seq_len=32,
                                   vocab_size=50, device=device)[0]


def _jax_lm_builder(cfg):
    return jax_build_lm(cfg, num_layers=1, d_model=32, num_heads=2,
                        d_ff=64, seq_len=32, vocab_size=50)[0]


def _registry():
    reg = ModelRegistry()
    reg.register("a", _dense_builder(24, seed=1), batch_size=8,
                 serve={"max_wait_ms": 0.5, "stats_every": 0})
    reg.register("b", _dense_builder(40, seed=2), batch_size=8,
                 serve={"max_wait_ms": 0.5, "stats_every": 0})
    return reg


def _rows(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, NFEAT)).astype(np.float32)


def _fleet(reg, **kw):
    return FleetEngine(reg, device="cpu", **kw)


@pytest.fixture
def fault_env():
    faults.reset()
    yield
    os.environ.pop("FF_FAULT", None)
    faults.reset()


# ---------------------------------------------------------------------
# registry and schema
# ---------------------------------------------------------------------
GEN = {"name": "chat", "model": "transformer_lm", "engine": "generation"}
BAD_FLEETS = [
    [], {"fleet": []}, {"fleet": "x"}, {"fleet": [1]},
    {"fleet": [{"name": "m", "model": "transformer"},
               {"name": "m", "model": "dlrm", "engine": "nope",
                "weight": -1, "serve": {"bogus_knob": 1}}]},
    {"fleet": [{"name": "g", "model": "transformer_lm",
                "engine": "generation", "serve": {"max_batch": 4}}]},
    {"fleet": [{**GEN, "generation": {"draft": "tiny"}}]},
    {"fleet": [{**GEN, "generation": {"draft": "other"}},
               {"name": "other", "model": "transformer_lm",
                "engine": "generation"}]},
    {"fleet": [{**GEN, "generation": {"draft": 3}}]},
    {"fleet": [{"name": "tiny", "model": "transformer_lm",
                "engine": "draft", "generation": {"slots": 2}}]},
    {"fleet": [{**GEN, "generation": {"spec_gamma": 1,
                                      "spec_policy": "greedy",
                                      "page_size": -1}}]},
    {"fleet": [{"name": "d", "model": "dlrm", "role": "decode",
                "quantize": "int4", "batch_size": 0, "qps_rows": -2}],
     "hbm_gb": "16"},
    {"fleet": [{**GEN, "quantize": "int8", "role": "sideways",
                "checkpoint": 3}]},
    {"fleet": [{"model": "transformer"}]},
]


@pytest.mark.parametrize("obj", BAD_FLEETS)
def test_schema_errors_equal_jax(obj):
    probs = validate_fleet_json(obj)
    assert probs and probs == jax_validate_fleet_json(obj)


def test_well_formed_fleets_pass():
    for obj in ({"fleet": [{"name": "m", "model": "transformer"}]},
                {"fleet": [{**GEN, "generation": {"draft": "tiny",
                                                  "spec_gamma": 2}},
                           {"name": "tiny", "model": "transformer_lm",
                            "engine": "draft"}]}):
        assert validate_fleet_json(obj) == [] == jax_validate_fleet_json(
            obj)


def test_registry_from_json_unknown_model_loud():
    with pytest.raises(ValueError, match="unknown model"):
        ModelRegistry.from_json(
            {"fleet": [{"name": "x", "model": "not_a_model"}]})


def test_shipped_example_fleet_is_schema_valid():
    with open(os.path.join(REPO, "examples", "serving", "fleet.json")) as f:
        obj = json.load(f)
    assert validate_fleet_json(obj) == []
    reg = ModelRegistry.from_json(obj)
    assert set(reg.names()) == {"chat", "ranker", "recs"}
    assert reg.hbm_gb == 16.0 and reg.spec("ranker").weight == 2.0
    assert reg.spec("chat").engine == "generation"


def test_builtin_builders_have_the_jax_names():
    from flexflow_tpu.serving.fleet import builtin_builders as jax_builtins
    assert set(builtin_builders()) == set(jax_builtins())


@pytest.mark.parametrize("name", ["transformer", "transformer_lm",
                                  "lstm_lm", "candle_uno"])
def test_builtin_graphs_have_the_jax_widths(name):
    from flexflow_tpu.serving.fleet import builtin_builders as jax_builtins
    cfg = ft.FFConfig(batch_size=8, compute_dtype="float32")
    m = builtin_builders()[name](cfg, "cpu")
    jm = jax_builtins()[name](ff.FFConfig(batch_size=8,
                                          compute_dtype="float32"))
    assert ([(p.name, tuple(p.shape)) for p in m.parameters]
            == [(p.name, tuple(p.shape)) for p in jm.parameters])


# ---------------------------------------------------------------------
# serving and scheduling
# ---------------------------------------------------------------------
def test_fleet_serves_both_tenants_with_parity():
    with silenced("serve"), _fleet(_registry()) as fleet:
        xs = _rows(4)
        ya = fleet.submit("a", xs).result(timeout=60)
        yb = fleet.submit("b", xs).result(timeout=60)
        ma = fleet._tenant("a").engine.model
        mb = fleet._tenant("b").engine.model
        np.testing.assert_array_equal(ya, ma.predict(xs, batch_size=4))
        np.testing.assert_array_equal(yb, mb.predict(xs, batch_size=4))
        assert not np.array_equal(ya, yb)
        s = fleet.stats()
        assert set(s["tenants"]) == {"a", "b"}
        assert s["tenants"]["a"]["requests"] == 1
        assert s["tenants"]["a"]["model"] == "a"


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _StubEngine:
    """An engine whose every dispatch costs ``cost`` seconds of the
    injected clock and serves ``rows`` rows, with ``backlog`` dispatches
    queued: the scheduler's inputs without a model."""

    def __init__(self, clock, cost, rows, backlog):
        self.clock, self.cost, self.rows = clock, cost, rows
        self.backlog = backlog
        self.served = 0

        class _M:
            total_rows = 0
        self.metrics = _M()

        class _B:
            queue_depth = 0
        self._batcher = _B()

    @property
    def has_pending(self):
        return self.backlog > 0

    def dispatch_pending(self):
        if not self.backlog:
            return None
        self.backlog -= 1
        self.served += 1
        self.metrics.total_rows += self.rows
        self.clock.t += self.cost
        return self.cost

    def begin_external_dispatch(self):
        return self


def _stub_fleet(clock, tenants):
    fleet = FleetEngine(device="cpu", clock=clock, stats_every_s=0)
    stubs = {}
    with silenced("serve"):
        for name, weight, qps, cost in tenants:
            stubs[name] = _StubEngine(clock, cost, 8, 10 ** 6)
            fleet.add_engine(name, stubs[name], weight=weight,
                             qps_rows=qps)
    return fleet, stubs


def test_weighted_fair_device_time_on_an_injected_clock():
    """Both tenants backlogged: device seconds per weight equalise, so
    the 2:1-weighted tenant gets twice the device time, whatever each
    dispatch costs."""
    clock = _Clock()
    fleet, stubs = _stub_fleet(clock, [("heavy", 2.0, 0.0, 0.003),
                                       ("light", 1.0, 0.0, 0.001)])
    for _ in range(3000):
        assert fleet._dispatch_turn() is not None
    dev = {n: s.served * s.cost for n, s in stubs.items()}
    assert dev["heavy"] / dev["light"] == pytest.approx(2.0, rel=0.01)
    assert fleet._tenant("heavy").vtime == pytest.approx(
        fleet._tenant("light").vtime, abs=0.003)


def test_idle_tenant_banks_no_credit():
    clock = _Clock()
    fleet, stubs = _stub_fleet(clock, [("a", 1.0, 0.0, 0.001),
                                       ("b", 1.0, 0.0, 0.001)])
    stubs["b"].backlog = 0
    for _ in range(100):
        fleet._dispatch_turn()
    stubs["b"].backlog = 10 ** 6
    before = dict((n, s.served) for n, s in stubs.items())
    for _ in range(100):
        fleet._dispatch_turn()
    # b returns from idle at the virtual clock: an even split, not a
    # catch-up monopoly
    assert stubs["b"].served - before["b"] == pytest.approx(50, abs=1)


def test_qps_budget_paces_a_tenant_on_an_injected_clock():
    clock = _Clock()
    fleet, stubs = _stub_fleet(clock, [("capped", 1.0, 400.0, 0.0)])
    served_at = []
    for _ in range(2000):
        if fleet._dispatch_turn() is not None:
            served_at.append(clock.t)
        clock.t += 0.001
    # a 400 rows/s budget of 8-row dispatches over ~2 s: the 1-second
    # burst allowance plus 400 rows a second, never more
    rows = 8 * len(served_at)
    assert rows <= 400 + 400 * clock.t + 8
    assert rows >= 400 * clock.t
    uncapped, stubs2 = _stub_fleet(_Clock(), [("free", 1.0, 0.0, 0.0)])
    for _ in range(200):
        uncapped._dispatch_turn()
    assert stubs2["free"].served == 200


def test_fleet_hot_swap_zero_failed_and_reconciled():
    reg = _registry()
    xs = _rows(4)
    results = {"ok": 0, "admission": 0, "failed": 0}
    stop = threading.Event()
    with silenced("serve"), _fleet(reg) as fleet:
        old_out = fleet.submit("a", xs).result(timeout=60)

        def pump():
            while not stop.is_set():
                try:
                    fleet.submit("a", xs).result(timeout=60)
                    results["ok"] += 1
                except ServingError:
                    results["admission"] += 1
                except Exception:  # noqa: BLE001
                    results["failed"] += 1
        th = threading.Thread(target=pump)
        th.start()
        time.sleep(0.1)
        reg.register("a", _dense_builder(24, seed=77), batch_size=8,
                     serve={"max_wait_ms": 0.5, "stats_every": 0})
        fleet.load("a", wait=True, timeout=120)
        time.sleep(0.1)
        stop.set()
        th.join()
        new_out = fleet.submit("a", xs).result(timeout=60)
        st = fleet.stats("a")
    assert results["failed"] == 0, results
    assert results["ok"] > 0
    assert st["engine_generation"] == 1
    assert not np.array_equal(old_out, new_out)
    submitted = results["ok"] + results["admission"] + 2
    assert (st["requests"] + st["rejected"] + st["shed"]
            + st["expired"] + st["errors"]) == submitted == st["submitted"]


def test_fleet_generation_swap_retires_active_streams(fault_env):
    os.environ["FF_FAULT"] = "serve_slow_decode:200,ms=40"
    faults.reset()
    cfg2 = ft.FFConfig(batch_size=2, compute_dtype="float32")
    new_model = _lm_builder(cfg2, "cpu")
    new_model.compile()
    new_model.init_layers(seed=5)
    new_eng = GenerationEngine(new_model, slots=2, max_new_tokens=24,
                               name="chat", stats_every=0)
    with silenced("serve"):
        new_eng.begin_external_dispatch()
    reg = ModelRegistry()
    reg.register("chat", _lm_builder, engine="generation", batch_size=2,
                 generation={"slots": 2, "max_new_tokens": 24,
                             "stats_every": 0})
    prompt = [3, 1, 4]
    with silenced("serve"), capture_events("serve") as events, \
            _fleet(reg) as fleet:
        stream = fleet.submit("chat", prompt, max_new_tokens=24)
        next(iter(stream))
        fleet.add_engine("chat", new_eng)
        deadline = time.monotonic() + 60
        while fleet.stats("chat")["engine_generation"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        out = stream.result(timeout=120)
        assert out.shape == (24,)
        out2 = fleet.submit("chat", prompt,
                            max_new_tokens=3).result(timeout=120)
        assert out2.size > 0
    kinds = [e["event"] for e in events]
    assert "fleet_publish" in kinds and "fleet_retired" in kinds


def test_fleet_unload_drains_and_detaches():
    with silenced("serve"), _fleet(_registry()) as fleet:
        xs = _rows(4)
        futs = [fleet.submit("a", xs) for _ in range(8)]
        snap = fleet.unload("a", timeout=30)
        assert snap["requests"] == 8
        for f in futs:
            assert f.result(timeout=5).shape == (4, NCLS)
        assert fleet.names() == ["b"]
        with pytest.raises(KeyError, match="no resident model"):
            fleet.submit("a", xs)
        assert fleet.submit("b", xs).result(timeout=60).shape == (4, NCLS)


def test_fleet_generation_tenant_token_parity():
    cfg = ft.FFConfig(batch_size=2, compute_dtype="float32", seed=0)
    solo_lm = _lm_builder(cfg, "cpu")
    solo_lm.compile()
    solo_lm.init_layers(seed=0)
    prompt = [3, 1, 4, 1, 5]
    with silenced("serve"):
        with GenerationEngine(solo_lm, slots=2, max_new_tokens=6) as eng:
            want = list(eng.submit(prompt))
        reg = ModelRegistry()
        reg.register("chat", _lm_builder, engine="generation",
                     batch_size=2,
                     generation={"slots": 2, "max_new_tokens": 6,
                                 "stats_every": 0})
        reg.register("a", _dense_builder(24, seed=1), batch_size=8,
                     serve={"max_wait_ms": 0.5, "stats_every": 0})
        with _fleet(reg) as fleet:
            futs = [fleet.submit("a", _rows(4)) for _ in range(6)]
            got = list(fleet.submit("chat", prompt))
            for f in futs:
                f.result(timeout=60)
    assert got == want


def test_dense_and_generation_engines_coreside_with_parity():
    cfg_d = ft.FFConfig(batch_size=8, compute_dtype="float32", seed=1)
    dense = _dense_builder(24, seed=1)(cfg_d, "cpu")
    dense.compile()
    dense.init_layers(seed=1)
    cfg_g = ft.FFConfig(batch_size=2, compute_dtype="float32", seed=0)
    lm = _lm_builder(cfg_g, "cpu")
    lm.compile()
    lm.init_layers(seed=0)
    xs, prompt = _rows(4), [7, 2, 9]
    want_dense = dense.predict(xs, batch_size=4)
    with silenced("serve"):
        with GenerationEngine(lm, slots=2, max_new_tokens=5) as solo:
            want_tokens = list(solo.submit(prompt))
        with ServingEngine(dense, name="dense", stats_every=0) as se:
            with GenerationEngine(lm, slots=2, max_new_tokens=5,
                                  name="lm") as gen:
                streams = [gen.submit(prompt) for _ in range(3)]
                futs = [se.submit(xs) for _ in range(12)]
                tok_lists = [list(s) for s in streams]
                outs = [f.result(timeout=60) for f in futs]
    for out in outs:
        np.testing.assert_array_equal(out, want_dense)
    assert all(t == want_tokens for t in tok_lists)


# ---------------------------------------------------------------------
# the co-residency gate
# ---------------------------------------------------------------------
def _gate_registries(draft=False):
    regs = []
    for cls, dense, lm in ((ModelRegistry, _dense_builder, _lm_builder),
                           (JaxRegistry, _jax_dense_builder,
                            _jax_lm_builder)):
        reg = cls()
        reg.register("d", dense(24, seed=1), batch_size=8,
                     serve={"max_wait_ms": 0.5, "stats_every": 0})
        gen = {"slots": 2, "max_seq": 32, "max_new_tokens": 4,
               "stats_every": 0}
        if draft:
            gen.update(draft="tiny", spec_gamma=2)
            reg.register("tiny", lm, engine="draft", batch_size=2)
        reg.register("g", lm, engine="generation", batch_size=2,
                     generation=gen)
        regs.append(reg)
    return regs


@pytest.mark.parametrize("draft", [False, True])
def test_gate_rows_equal_jax_and_the_engines_bytes(draft):
    reg, jreg = _gate_registries(draft)
    report, rows = fleet_gate_report(reg, hbm_gb=16.0, xla_temp_factor=2.1)
    jreport, jrows = jax_fleet_gate_report(jreg, hbm_gb=16.0,
                                           xla_temp_factor=2.1)
    assert rows == jrows
    assert report.codes() == jreport.codes()
    assert ([d.message for d in report.diagnostics]
            == [d.message for d in jreport.diagnostics])
    with silenced("serve"), _fleet(reg) as fleet:
        assert fleet.names() == ["d", "g"]          # no draft tenant
        for row in rows:
            assert fleet.stats(row["name"])["resident_bytes"] == \
                row["resident_bytes"], row["name"]
            t = fleet._tenant(row["name"])
            tensors = list(t.engine.model._params.values())
            if t.kind == "generation":
                for sub in t.engine._caches.values():
                    tensors += list(sub.values())
                if draft:
                    tensors += list(t.engine.draft_model._params.values())
                    for sub in t.engine._draft_caches.values():
                        tensors += list(sub.values())
            assert sum(x.numel() * x.element_size() for x in tensors) \
                == row["resident_bytes"]


def test_draft_is_charged_onto_its_target_and_speculates():
    reg, _ = _gate_registries(draft=True)
    model, strategies = reg.graph("g")
    dmodel, dstrat = reg.graph("tiny")
    row = model_residency(reg.spec("g"), model.layers, model.input_tensors,
                          strategies, model_config=model.config,
                          draft=("tiny", dmodel.layers, dstrat))
    assert row["draft"] == "tiny" and row["draft_bytes"] > 0
    cfg = ft.FFConfig(batch_size=2, compute_dtype="float32", seed=0)
    solo = _lm_builder(cfg, "cpu")
    solo.compile()
    solo.init_layers(seed=0)
    prompt = [3, 1, 4]
    with silenced("serve"):
        with GenerationEngine(solo, slots=2, max_new_tokens=4) as eng:
            want = list(eng.submit(prompt))
        with _fleet(reg) as fleet:
            got = list(fleet.submit("g", prompt, max_new_tokens=4))
            st = fleet.stats("g")
    assert got == want
    assert st["draft_dispatches"] > 0 and st["spec_fallbacks"] == 0


def test_fleet_gate_ff130_flips_with_draft():
    reg, _ = _gate_registries(draft=True)
    no_draft, _ = _gate_registries(draft=False)
    _, rows = fleet_gate_report(reg, hbm_gb=16.0)
    _, rows0 = fleet_gate_report(no_draft, hbm_gb=16.0)
    g, g0 = rows[-1], rows0[-1]
    assert g["draft_bytes"] > 0
    budget_gb = (sum(r["ff108_bytes"] for r in rows0)
                 + g["draft_bytes"] / 2) / 1e9
    assert "FF130" in fleet_gate_report(reg, hbm_gb=budget_gb)[0].codes()
    assert "FF130" not in fleet_gate_report(
        no_draft, hbm_gb=budget_gb)[0].codes()
    assert g0["draft_bytes"] == 0


def test_fleet_gate_report_sums_tenants():
    report, rows = fleet_gate_report(_registry(), hbm_gb=16.0)
    assert [r["name"] for r in rows] == ["a", "b"]
    assert all(r["resident_bytes"] > 0 for r in rows)
    assert report.codes().count("FF131") == 2 and not report.errors
    total_gb = sum(r["ff108_bytes"] for r in rows) / 1e9
    assert "FF130" in fleet_gate_report(_registry(),
                                        hbm_gb=total_gb / 2)[0].codes()


# ---------------------------------------------------------------------
# events and faults
# ---------------------------------------------------------------------
def test_serve_events_carry_model_tag():
    cfg = ft.FFConfig(batch_size=8, compute_dtype="float32")
    model = _dense_builder(24)(cfg, "cpu")
    model.compile()
    model.init_layers(seed=0)
    with capture_events("serve") as events:
        with ServingEngine(model, name="ranker", stats_every=1) as eng:
            eng.submit(_rows(4)).result(timeout=60)
            snap = eng.stats()
    assert snap["model"] == "ranker"
    tagged = [e for e in events
              if e["event"] in ("serve_stats", "serve_health")]
    assert tagged and all(e["model"] == "ranker" for e in tagged)


def test_serve_model_name_config_default():
    cfg = ft.FFConfig(batch_size=8, compute_dtype="float32")
    cfg.serve_model_name = "cfg-tag"
    model = _dense_builder(24)(cfg, "cpu")
    model.compile()
    model.init_layers(seed=0)
    eng = ServingEngine(model, stats_every=0)
    assert eng.name == "cfg-tag"
    assert eng.metrics.snapshot()["model"] == "cfg-tag"


def test_fleet_load_fail_leaves_serving_tenants_untouched(fault_env):
    os.environ["FF_FAULT"] = "fleet_load_fail:newbie"
    faults.reset()
    reg = _registry()
    with silenced("serve"), capture_events("serve") as events, \
            _fleet(reg) as fleet:
        xs = _rows(4)
        assert fleet.submit("a", xs).result(timeout=60) is not None
        reg.register("newbie", _dense_builder(24, seed=9), batch_size=8,
                     serve={"max_wait_ms": 0.5, "stats_every": 0})
        with pytest.raises(RuntimeError, match="fleet load"):
            fleet.load("newbie", wait=True, timeout=60)
        assert fleet.names() == ["a", "b"]
        assert fleet.submit("a", xs).result(timeout=60) is not None
    errs = [e for e in events if e["event"] == "fleet_load_error"]
    assert errs and errs[0]["model"] == "newbie"


def test_fleet_swap_at_dispatch_holds_publish(fault_env):
    os.environ["FF_FAULT"] = "fleet_swap_at_dispatch:3"
    faults.reset()
    reg = _registry()
    xs = _rows(4)
    with silenced("serve"), capture_events("serve") as events, \
            _fleet(reg) as fleet:
        reg.register("a", _dense_builder(24, seed=77), batch_size=8,
                     serve={"max_wait_ms": 0.5, "stats_every": 0})
        done = fleet.load("a", wait=False)
        deadline = time.monotonic() + 60
        while not done.is_set():
            fleet.submit("b", xs).result(timeout=60)
            assert time.monotonic() < deadline
        assert fleet.stats("a")["engine_generation"] == 1
    pubs = [e for e in events if e["event"] == "fleet_publish"]
    assert pubs and pubs[0]["swap"] is True
    assert fleet._n_dispatch >= 3
