"""The calibrated cost model in the port (``search/calibration.py``, the
simulator's estimator hook, ``compile``'s calibration settings and
``fit``'s epoch event) against the JAX package's, on the CPU.

Under the reference spec (the JAX package's DeviceSpec values,
``_torch_search_cases.reference_spec``) with the dense attention rule
(``flash_attention=False``, ``device="cpu"``), the port's keys,
features, tables, validation errors, corrections and estimators are the
JAX package's: ``op_time`` within rtol 1e-12, a calibrated MCMC walk
equal (strategies, mesh, time and statistics).  The analytic estimator
is the port's own simulator roofline bit for bit, and an uncalibrated
simulation is unchanged.  Harvests run on the CPU at a tiny size and are
checked for structure and their analytic halves, never for a measured
time.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import _torch_search_cases as cases
import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.search import calibration as jc
from flexflow_tpu.search import cost_model as jax_cost
from flexflow_tpu.search import mcmc as jax_mcmc
from flexflow_tpu.strategy import proto as jax_proto
from flexflow_tpu_torch.search import calibration as pc
from flexflow_tpu_torch.search import cost_model as port_cost
from flexflow_tpu_torch.search import mcmc as port_mcmc
from flexflow_tpu_torch.search.simulator import Simulator as PortSim
from flexflow_tpu_torch.strategy import proto as port_proto

JSPEC = jax_cost.DEFAULT_SPEC
RTOL = 1e-12
GRAPHS = ("transformer", "dlrm", "alexnet", "inception", "moe")


def _dims_of(op):
    nd = op.outputs[0].num_dims
    return [(1,) * nd, (2,) + (1,) * (nd - 1), (4,) + (1,) * (nd - 1)]


def _toy_pair(scale=3.0, n_entries=4):
    """The JAX test's toy table, harvested by hand in each package from
    the same Linear ops: every entry measures ``scale`` x analytic."""
    from flexflow_tpu.ops.linear import Linear as JLinear
    from flexflow_tpu.tensor import Tensor as JTensor
    tables = []
    for mod, spec, T, L in ((jc, JSPEC, JTensor, JLinear),
                            (pc, cases.REF, None, None)):
        t = mod.CalibrationTable(device_kind="cpu", source="toy")
        for i in range(n_entries):
            shape, out = (8 * (2 ** i), 64), 32 * (2 ** i)
            if mod is jc:
                op = L(f"l{i}", T(shape, name=f"l{i}_in"), out)
                ana = [jax_cost.op_compute_time(op, (1, 1), spec,
                                                backward=b) * 1e3
                       for b in (False, True)]
            else:
                m = ft.FFModel(ft.FFConfig(batch_size=shape[0]),
                               device="cpu")
                m.dense(m.create_tensor(shape), out, name=f"l{i}")
                op = m.layers[-1]
                ana = [port_cost.op_compute_time(op, (1, 1), spec,
                                                 backward=b, device="cpu")
                       * 1e3 for b in (False, True)]
            t.add_op_sample(mod.op_key(op, (1, 1), "bfloat16"),
                            mod.op_features(op, (1, 1)), ana[0],
                            ana[0] * scale, ana[1], ana[1] * scale)
        tables.append(t)
    return tables


@pytest.fixture(scope="module")
def seed_pair():
    return jc.default_table(), pc.default_table()


# ----------------------------------------------------------------------
# keys, features, the table and its validation
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", GRAPHS)
def test_keys_buckets_and_features_equal(name):
    jm, pm = cases.pair(name)
    for jo, po in zip(jm.layers, pm.layers):
        assert pc.shape_bucket(po.outputs[0].shape) == \
            jc.shape_bucket(jo.outputs[0].shape)
        for dims in _dims_of(po):
            for dtype in ("bfloat16", "float32"):
                assert pc.op_key(po, dims, dtype) == \
                    jc.op_key(jo, dims, dtype)
            assert pc.op_features(po, dims) == jc.op_features(jo, dims)
    assert pc.table_key("conv2d", (128, 64, 112, 112), "bfloat16", 4) == \
        jc.table_key("conv2d", (128, 64, 112, 112), "bfloat16", 4) == \
        "conv2d|128x64x128x128|bfloat16|p4"


def test_tables_cross_load_with_one_digest(tmp_path):
    jt, pt = _toy_pair()
    for t in (jt, pt):
        t.add_dispatch_sample("train|toy|k1|b16", 12.5, n=2,
                              steps_per_dispatch=1)
        t.add_dispatch_sample("train|toy|k1|b16", 10.5)
        t.step_correction = {"alpha": 1.1, "beta": 0.7, "n": 3}
        t.spec = {"ici_bw": 5e10}
    assert pt.to_json() == jt.to_json()
    jpath, ppath = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    assert jt.save(jpath) == pt.save(ppath)
    with open(jpath, "rb") as f, open(ppath, "rb") as g:
        assert f.read() == g.read()
    assert pc.CalibrationTable.load(jpath).digest == jt.digest
    assert jc.CalibrationTable.load(ppath).digest == pt.digest
    assert pc.validate_file(jpath) == jc.validate_file(ppath) == []


def test_seed_copy_is_the_jax_seed(seed_pair):
    jt, pt = seed_pair
    with open(jc._SEED_PATH, "rb") as f, open(pc._SEED_PATH, "rb") as g:
        assert f.read() == g.read()
    with open(pc._SEED_PATH) as f:
        assert json.load(f)["digest"] == "sha256:7b553cabeb053ad4"
    assert pt.digest == jt.digest and pt.ops == jt.ops
    assert pc.validate_file(pc._SEED_PATH) == []


def _malformed():
    good = jc.default_table().to_json()
    rows = [
        [],
        {"kind": "calibration_table", "version": 1, "device_kind": "cpu",
         "ops": {"badkey": {"fwd": {"analytic_ms": -1, "measured_ms": 1,
                                    "n": 1}, "features": {}}},
         "digest": "sha256:0"},
        {"kind": "other", "version": 9, "device_kind": 3, "ops": [],
         "dispatch": {"d": {"measured_ms": "x"}}},
        dict(good, version="1", spec={"ici_bw": "fast", "warp": 1.0,
                                      "hbm_bw": float("nan")},
             xla_temp_factor=-1.0),
        dict(good, step_correction={"alpha": 1.0, "beta": float("nan"),
                                    "n": 3}),
        dict(good, step_correction={"alpha": 1.0, "beta": 0.7, "n": 1}),
        dict(good, step_correction=[1, 2]),
        dict(good, ops={"a|b|c|p1": {"fwd": None, "bwd": "x",
                                     "features": 1}, "k": 3}),
        dict(good, ops={**good["ops"], "conv2d|1x1|bfloat16|p1": {
            "fwd": {"analytic_ms": 1.0, "measured_ms": float("nan"),
                    "n": 1}, "features": {}}}),
    ]
    return rows


def _malformed_bench():
    return [
        [],
        {"kind": "calib_bench", "models": []},
        {"kind": "x", "models": [
            1, {"no": "model"},
            {"model": "m", "per_op": {"n_measured": 0,
                                      "mape_analytic": None,
                                      "mape_calibrated": None},
             "end_to_end": {"measured_ms_per_step": 1.0,
                            "ape_analytic": 0.1, "ape_calibrated": 0.2}},
            {"model": "m", "per_op": {"n_measured": 3,
                                      "mape_analytic": None},
             "end_to_end": {"measured_ms_per_step": "1"}}],
         "calibration_digest": "sha256:0"},
    ]


def test_validation_errors_equal_the_jax_package(tmp_path):
    for data in _malformed():
        assert pc.validate_table(data) == jc.validate_table(data), data
    for data in _malformed_bench():
        assert pc.validate_bench(data) == jc.validate_bench(data), data
    paths = [os.devnull, str(tmp_path / "missing.json")]
    for i, data in enumerate(_malformed()[1:] + _malformed_bench()[1:]):
        p = str(tmp_path / f"m{i}.json")
        with open(p, "w") as f:
            json.dump(data, f)
        paths.append(p)
    for p in paths:
        assert pc.validate_file(p) == jc.validate_file(p), p
    # a field only the port's DeviceSpec has (a TPU correction the JAX
    # package holds as a literal) is a known field here
    good = pc.default_table().to_json()
    good["spec"] = {"temp_factor": 2.0}
    good["digest"] = pc.content_digest(good)
    assert pc.validate_table(good) == []


def test_corrections_equal_the_jax_package():
    pair_sets = [
        [(x, math.exp(0.5) * x ** 0.8) for x in (0.5, 4.0, 900.0)],
        [(1.0, 2.0)], [(1.0, 2.0), (1.0, 3.0)],
        [(1.0, 4.0), (2.0, 1.0), (0, 0)],
        [(3.1, 9.7), (12.0, 20.5), (55.0, 61.0), (float("inf"), 1.0)],
    ]
    for pairs in pair_sets:
        assert pc.fit_step_correction(pairs) == jc.fit_step_correction(pairs)
    jt, pt = jc.CalibrationTable(), pc.CalibrationTable()
    jt.step_correction = pt.step_correction = pc.fit_step_correction(
        pair_sets[0])
    for ms in (0.0, 3.0, 4.0, 1e4, float("inf"), -1.0):
        got, want = pc.apply_step_correction(pt, ms), \
            jc.apply_step_correction(jt, ms)
        assert got == want or (math.isinf(got) and math.isinf(want))
    assert pc.apply_step_correction(None, 3.0) == 3.0
    # spec overrides: the overridden fields take the table's values,
    # the others keep the base spec's
    pt.spec = jt.spec = {"ici_bw": 5e10, "hbm_bw": 1e12,
                         "hbm_capacity": 1e6}
    got = pc.calibrated_spec(pt, cases.REF)
    want = jc.calibrated_spec(jt, JSPEC)
    for f in ("mxu_flops", "vpu_flops", "hbm_bw", "hbm_capacity", "ici_bw",
              "dcn_bw", "ici_latency", "kernel_launch"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.temp_factor == cases.REF.temp_factor
    assert pc.calibrated_spec(None) == port_cost.spec_for_device()
    assert pc.calibrated_spec(pc.CalibrationTable()) == \
        port_cost.spec_for_device()


# ----------------------------------------------------------------------
# estimators
# ----------------------------------------------------------------------
def _estimators(kind, jt, pt):
    return ((jc.TableEstimator(jt), pc.TableEstimator(pt)) if kind == "table"
            else (jc.RidgeEstimator(jt), pc.RidgeEstimator(pt)))


@pytest.mark.parametrize("kind", ["table", "ridge"])
@pytest.mark.parametrize("table", ["seed", "toy"])
@pytest.mark.parametrize("name", GRAPHS)
def test_estimator_op_time_equals_the_jax_package(name, table, kind,
                                                  seed_pair):
    jt, pt = seed_pair if table == "seed" else _toy_pair(2.5, 6)
    jest, pest = _estimators(kind, jt, pt)
    assert pest.describe() == jest.describe()
    jm, pm = cases.pair(name)
    for jo, po in zip(jm.layers, pm.layers):
        for dims in _dims_of(po):
            for prec, dtype in (("", "bfloat16"), ("", "float32"),
                                ("f32", "float32"), ("bf16", "bfloat16")):
                for b in (False, True):
                    want = jest.op_time(jo, dims, JSPEC, 2, b,
                                        flash_attention=False,
                                        compute_dtype=dtype,
                                        precision=prec)
                    got = pest.op_time(po, dims, cases.REF, 2, b,
                                       flash_attention=False,
                                       compute_dtype=dtype,
                                       precision=prec, device="cpu")
                    assert got == pytest.approx(want, rel=RTOL), \
                        (po.name, dims, prec, b)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", ["transformer", "alexnet", "moe"])
def test_analytic_estimator_is_the_simulator_roofline(name, device):
    """The identity estimator charges the simulator's own roofline bit
    for bit, on either device's flash rule, with or without a precision
    pin; an uncalibrated simulation does not move."""
    _, pm = cases.pair(name)
    est = pc.AnalyticEstimator()
    for dtype in ("bfloat16", "float32"):
        sim = PortSim(num_devices=4, compute_dtype=dtype, device=device,
                      use_native=False)
        cal = PortSim(num_devices=4, compute_dtype=dtype, device=device,
                      use_native=False, estimator=est)
        for op in pm.layers:
            for dims in _dims_of(op):
                for prec in ("", "bf16", "f32"):
                    for b in (False, True):
                        assert cal._op_time(op, dims, b, prec) == \
                            sim._analytic_time(op, dims, b, prec)
        assert cal.simulate(pm.layers, {}) == sim.simulate(pm.layers, {})
    assert PortSim(device="cpu").estimator is None


def test_table_base_follows_the_run_flash_rule():
    """A table's exact hit rescales the roofline the harvest divided
    by: on a CUDA device the attention's dense score traffic is not
    charged, so the calibrated time follows the same rule."""
    _, pm = cases.pair("transformer")
    att = next(op for op in pm.layers if op.op_type.value == "attention")
    t = pc.CalibrationTable()
    for device in ("cpu", "cuda"):
        ana = [port_cost.op_compute_time(att, (1, 1, 1), cases.REF, 2, b,
                                         device=device) * 1e3
               for b in (False, True)]
        t.ops.clear()
        t.add_op_sample(pc.op_key(att, (1, 1, 1), "bfloat16"),
                        pc.op_features(att, (1, 1, 1)), ana[0],
                        ana[0] * 3, ana[1], ana[1] * 3)
        est = pc.TableEstimator(t)
        for b in (False, True):
            assert est.op_time(att, (1, 1, 1), cases.REF, 2, b,
                               device=device) == pytest.approx(
                3 * ana[b] * 1e-3, rel=RTOL)


def test_estimator_resolution_and_errors_equal(tmp_path):
    jt, pt = _toy_pair()
    path = str(tmp_path / "t.json")
    pt.save(path)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("{")
    for kw in ({}, {"cost_estimator": "analytic"},
               {"calibration_file": path},
               {"calibration_file": path, "cost_estimator": "ridge"},
               {"calibration_file": path, "cost_estimator": "analytic"}):
        pe, ptab = pc.estimator_from_config(ft.FFConfig(**kw))
        je, jtab = jc.estimator_from_config(ff.FFConfig(**kw))
        assert (pe is None) == (je is None), kw
        if pe is not None:
            assert pe.describe() == je.describe()
        assert (ptab and ptab.digest) == (jtab and jtab.digest)
    for kw in ({"cost_estimator": "table"}, {"cost_estimator": "ridge"},
               {"calibration_file": path, "cost_estimator": "nope"},
               {"calibration_file": str(tmp_path / "missing.json")},
               {"calibration_file": bad}):
        with pytest.raises(ValueError) as pe:
            pc.estimator_from_config(ft.FFConfig(**kw))
        with pytest.raises(ValueError) as je:
            jc.estimator_from_config(ff.FFConfig(**kw))
        assert str(pe.value) == str(je.value), kw
    with pytest.raises(ValueError, match="needs a calibration table"):
        pc.make_estimator("table")
    assert pc.make_estimator("analytic").name == "analytic"


# ----------------------------------------------------------------------
# the calibrated objective: session, walks, compile
# ----------------------------------------------------------------------
def test_calibrated_session_equals_one_shot(seed_pair):
    from flexflow_tpu_torch.search.mcmc import (candidate_meshes,
                                                legal_configs)
    _, pm = cases.pair("transformer")
    layers = pm.layers
    for est in (pc.TableEstimator(seed_pair[1]),
                pc.RidgeEstimator(seed_pair[1])):
        sim = PortSim(num_devices=8, estimator=est, device="cpu")
        meshes = candidate_meshes(8)[:3]
        rng = np.random.default_rng(7)
        with sim.session(layers) as sess:
            mesh = meshes[0]
            strat = {op.name: legal_configs(op, mesh)[0] for op in layers}
            for step in range(25):
                if step % 9 == 8:
                    mesh = meshes[int(rng.integers(len(meshes)))]
                    strat = {op.name: legal_configs(op, mesh)[-1]
                             for op in layers}
                else:
                    op = layers[int(rng.integers(len(layers)))]
                    cands = legal_configs(op, mesh)
                    strat[op.name] = cands[int(rng.integers(len(cands)))]
                t_sess = sess.evaluate(strat, mesh_shape=mesh)
                t_one = sim.simulate(layers, strat, mesh_shape=mesh)
                assert t_sess == t_one or (np.isinf(t_sess)
                                           and np.isinf(t_one)), step
        assert sim.simulate(layers, strat, mesh_shape=mesh) != PortSim(
            num_devices=8, device="cpu").simulate(layers, strat,
                                                  mesh_shape=mesh)


def _walk(pkg, layers, ndev, est, **kw):
    st = {}
    if pkg is ff:
        best, mesh, t = jax_mcmc.search(layers, ndev, stats=st,
                                        flash_attention=False,
                                        estimator=est, **kw)
        digest = jax_proto.strategy_digest(best)
    else:
        best, mesh, t = port_mcmc.search(layers, ndev, stats=st,
                                         spec=cases.REF, device="cpu",
                                         flash_attention=False,
                                         estimator=est, **kw)
        digest = port_proto.strategy_digest(best)
    st.pop("time_to_best_ms", None)
    return digest, {a: s for a, s in mesh.items() if s > 1}, t, st


@pytest.mark.parametrize("kind", ["table", "ridge"])
@pytest.mark.parametrize("name,ndev,kw", [
    ("transformer", 8, dict(budget=60, seed=0)),
    ("dlrm", 4, dict(budget=60, seed=1, chains=2)),
    ("branchy", 4, dict(budget=50, seed=2, precision_axis=True)),
    ("transformer", 4, dict(budget=40, seed=1, mode="hybrid")),
], ids=["transformer", "dlrm_chains", "branchy_precision",
        "transformer_hybrid"])
def test_calibrated_walk_equals_the_jax_package(name, ndev, kw, kind,
                                                seed_pair):
    jm, pm = cases.pair(name)
    jest, pest = _estimators(kind, *seed_pair)
    got = _walk(ft, pm.layers, ndev, pest, **kw)
    want = _walk(ff, jm.layers, ndev, jest, **kw)
    assert got[:2] == want[:2] and got[3] == want[3]
    assert got[2] == pytest.approx(want[2], rel=RTOL)
    # the calibrated objective is not the analytic one
    assert got[2] != _walk(ft, pm.layers, ndev, None, **kw)[2]


def test_compile_searches_on_the_calibrated_objective(tmp_path, capsys):
    """compile(search_budget) with calibration_file on the CPU: the
    search line cites the estimator and the table's digest, the
    strategies are the JAX package's for the same table, and the
    uncalibrated and calibrated searches never share a warm-start
    entry."""
    from flexflow_tpu_torch.search.hybrid import BestStrategyStore
    jt, pt = _toy_pair()
    path = str(tmp_path / "t.json")
    pt.save(path)
    out = str(tmp_path / "searched.pb")

    def build(pkg, **kw):
        cfg = pkg.FFConfig(batch_size=8, compute_dtype="float32",
                           search_budget=20, calibration_file=path, **kw)
        m = pkg.FFModel(cfg, **cases.DEV[pkg])
        t = m.create_tensor((8, 16))
        t = m.dense(t, 32, activation="relu")
        return m, m.dense(t, 4)

    m, logits = build(ft, export_strategy_file=out)
    m.compile(ft.AdamOptimizer(alpha=1e-3), final_tensor=logits)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[search]")]
    assert line and line[0].endswith(
        f", estimator table (calibration {pt.digest})"), line
    jm, _ = build(ff)
    jm.optimizer = ff.AdamOptimizer(alpha=1e-3)
    want = jax_mcmc.optimize_strategies(jm, jm.config, num_devices=1)
    assert port_proto.strategy_digest(port_proto.load_strategy_file(out)) \
        == jax_proto.strategy_digest(want)
    keys = {BestStrategyStore.key("g", 4, e) for e in (
        None, pc.AnalyticEstimator(), pc.TableEstimator(pt),
        pc.RidgeEstimator(pt))}
    assert len(keys) == 3   # analytic twice, table, ridge: one each
    assert BestStrategyStore.key("g", 4, None) == \
        BestStrategyStore.key("g", 4, pc.AnalyticEstimator())


def test_search_simulator_takes_the_table_and_its_spec(tmp_path):
    """search_simulator threads the estimator and, with a calibrated
    estimator only, the table's spec overrides."""
    _, pt = _toy_pair()
    pt.spec = {"ici_bw": 5e10}
    path = str(tmp_path / "t.json")
    pt.save(path)
    m = ft.FFModel(ft.FFConfig(batch_size=8), device="cpu")
    m.dense(m.create_tensor((8, 16)), 4)
    for name, est_name, bw in (("auto", "table", 5e10),
                               ("ridge", "ridge", 5e10),
                               ("analytic", None, 900e9)):
        cfg = ft.FFConfig(batch_size=8, calibration_file=path,
                          cost_estimator=name)
        sim = port_mcmc.search_simulator(m, cfg, 4)
        assert (sim.estimator and sim.estimator.name) == est_name
        assert sim.spec.ici_bw == bw
    sim = port_mcmc.search_simulator(m, ft.FFConfig(batch_size=8), 4)
    assert sim.estimator is None
    assert sim.spec == port_cost.spec_for_device()


# ----------------------------------------------------------------------
# harvesting
# ----------------------------------------------------------------------
def _tiny(pkg=ft):
    cfg = pkg.FFConfig(batch_size=8, compute_dtype="float32")
    m = pkg.FFModel(cfg, **cases.DEV[pkg])
    x = m.create_tensor((8, 16))
    t = m.dense(x, 32, activation="relu")
    t = m.dense(t, 8)
    m.softmax(t)
    return m


def test_harvest_ops_records_structure_and_analytic_halves():
    m = _tiny()
    t = pc.CalibrationTable(device_kind="cpu", compute_dtype="float32")
    skipped = []
    n = pc.harvest_ops(t, m.layers, compute_dtype="float32", iters=1,
                       warmup=1, degrees=(1, 2), samples=1,
                       device="cpu", spec=cases.REF, skipped=skipped)
    assert n == 6 and len(t.ops) == 6 and skipped == []
    # the denses' 8 rows do not split 3 ways: skipped as indivisible,
    # not as failures (the softmax's sub-problem keeps its shape, in
    # both packages)
    assert pc.harvest_ops(t, m.layers, compute_dtype="float32", iters=1,
                          degrees=(3,), samples=1, device="cpu",
                          spec=cases.REF, skipped=skipped) == 1
    assert skipped == [] and "softmax|8x8|float32|p3" in t.ops
    jm = _tiny(ff)
    for jo, po in zip(jm.layers, m.layers):
        for deg in (1, 2):
            dims = (deg, 1)
            key = pc.op_key(po, dims, "float32")
            assert key == jc.op_key(jo, dims, "float32")
            entry = t.ops[key]
            assert entry["features"] == jc.op_features(jo, dims)
            for d, b in (("fwd", False), ("bwd", True)):
                rec = entry[d]
                assert rec["n"] == 1
                # the backward half is the forward-and-backward time less
                # the forward's, clamped at zero in both packages
                # (profiling.profile_op): at iters=1 it can be 0.0
                if d == "fwd":
                    assert rec["measured_ms"] > 0
                else:
                    assert math.isfinite(rec["measured_ms"]) \
                        and rec["measured_ms"] >= 0
                assert rec["analytic_ms"] == port_cost.op_compute_time(
                    po, dims, cases.REF, 4, b, device="cpu",
                    compute_dtype="float32") * 1e3
    assert pc.validate_table(t.to_json()) == []


def test_harvest_ops_reports_an_op_that_fails(monkeypatch):
    from flexflow_tpu_torch import profiling

    def broken(op, **kw):
        if op.name.startswith("softmax"):
            raise RuntimeError("kernel failed to launch")
        return {"fwd_ms": 1.0, "bwd_ms": 2.0}

    monkeypatch.setattr(profiling, "profile_op", broken)
    m = _tiny()
    t = pc.CalibrationTable()
    skipped = []
    assert pc.harvest_ops(t, m.layers, compute_dtype="float32",
                          device="cpu", skipped=skipped) == 2
    assert skipped == [(m.layers[-1].name, 1,
                        "RuntimeError: kernel failed to launch")]


def test_harvest_serve_dispatch_matches_the_jax_snapshot():
    """The port's ServingMetrics snapshot has the JAX package's
    ``per_bucket`` keys, and harvests to the same table entries; a real
    port engine's snapshot harvests one entry per bucket it used."""
    from flexflow_tpu.serving.metrics import ServingMetrics as JM
    from flexflow_tpu_torch.serving.metrics import ServingMetrics as PM
    snaps = []
    for cls in (JM, PM):
        met = cls(model="m", clock=lambda: 100.0)
        for rows, bucket, ms in ((3, 4, 1.5), (4, 4, 2.5), (7, 8, 3.0),
                                 (2, 4, 1.0)):
            met.record_dispatch(rows, bucket, 1, 0, ms * 1e-3)
        snaps.append(met.snapshot())
        met.unregister()
    js, ps = snaps
    assert ps["per_bucket"] == js["per_bucket"]
    assert set(ps["per_bucket"]["4"]) == set(js["per_bucket"]["4"])
    jt, pt = jc.CalibrationTable(), pc.CalibrationTable()
    assert pc.harvest_serve_dispatch(pt, None, ps) == \
        jc.harvest_serve_dispatch(jt, None, js) == 2
    assert pt.dispatch == jt.dispatch
    assert set(pt.dispatch) == {"serve|m|bucket4", "serve|m|bucket8"}

    from flexflow_tpu_torch.serving.engine import ServingEngine
    m = _tiny()
    m.compile(ft.SGDOptimizer(lr=0.1))
    m.init_layers(seed=0)
    xs = np.random.default_rng(0).standard_normal((16, 16)).astype(
        np.float32)
    with ServingEngine(m, max_batch=8) as eng:
        for f in [eng.submit(xs[i:i + 1 + i % 3]) for i in range(10)]:
            f.result(timeout=60)
        snap = eng.stats()
    t = pc.CalibrationTable()
    n = pc.harvest_serve_dispatch(t, "tiny", snap)
    assert n == len(snap["per_bucket"]) > 0
    for b, rec in snap["per_bucket"].items():
        e = t.dispatch[f"serve|tiny|bucket{b}"]
        assert e["measured_ms"] == rec["dispatch_p50_ms"]
        assert e["n"] == rec["dispatches"] and e["bucket"] == int(b)


def test_fit_epoch_event_has_the_jax_fields():
    """The same fit in both packages: the ``epoch`` events carry the
    same keys (and the same counts), and the registry's train counters
    move by the run's steps, dispatches and samples."""
    from flexflow_tpu.fflogger import capture_events as jcap
    from flexflow_tpu_torch.fflogger import capture_events as pcap
    from flexflow_tpu_torch.obs.registry import get_registry
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 16)).astype(np.float32)
    y = rng.integers(0, 8, (40, 1)).astype(np.int32)
    events = {}
    for pkg, cap in ((ff, jcap), (ft, pcap)):
        m = _tiny(pkg)
        m.config.steps_per_dispatch = 2
        m.compile(pkg.SGDOptimizer(lr=0.1), metrics=["accuracy"])
        m.init_layers(seed=0)
        if pkg is ft:
            reg = get_registry()
            before = {n: reg.counter(n, "").labels().value for n in (
                "ff_train_steps_total", "ff_train_dispatches_total",
                "ff_train_samples_total")}
        with cap("ff") as ev:
            m.fit(x, y, epochs=2, verbose=False,
                  validation_data=(x[:16], y[:16]))
        events[pkg] = [e for e in ev if e["event"] == "epoch"]
    got, want = events[ft], events[ff]
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    for g, w in zip(got, want):
        for k in ("epoch", "step", "samples", "steps_per_dispatch",
                  "dispatches"):
            assert g[k] == w[k], k
        assert g["dispatch_ms"] >= 0 and g["elapsed_s"] >= 0
    after = {n: reg.counter(n, "").labels().value for n in before}
    assert after["ff_train_steps_total"] - before[
        "ff_train_steps_total"] == got[-1]["step"] == 10
    assert after["ff_train_dispatches_total"] - before[
        "ff_train_dispatches_total"] == 2 * got[-1]["dispatches"] == 6
    assert after["ff_train_samples_total"] - before[
        "ff_train_samples_total"] == got[-1]["samples"] == 80
    assert reg.gauge("ff_train_dispatch_ms", "").labels().value == \
        pytest.approx(got[-1]["dispatch_ms"], abs=1e-3)


def test_harvest_train_dispatch_reads_the_epoch_events():
    m = _tiny()
    m.compile(ft.SGDOptimizer(lr=0.1))
    m.init_layers(seed=0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 16)).astype(np.float32)
    y = rng.integers(0, 8, (32, 1)).astype(np.int32)
    t = pc.CalibrationTable()
    ms = pc.harvest_train_dispatch(t, "tiny", m, x, y)
    rec = t.dispatch["train|tiny|k1|b8"]
    assert ms is not None and ms >= 0 and rec["measured_ms"] == ms
    assert rec["n"] == 2 and rec["steps_per_dispatch"] == 1
    assert rec["batch_size"] == 8


# ----------------------------------------------------------------------
# the entry points
# ----------------------------------------------------------------------
def test_calibrate_check_accepts_and_rejects(tmp_path, capsys):
    _, pt = _toy_pair()
    good = str(tmp_path / "good.json")
    pt.save(good)
    tampered = str(tmp_path / "tampered.json")
    data = json.load(open(good))
    data["device_kind"] = "edited"
    with open(tampered, "w") as f:
        json.dump(data, f)
    assert pc.calibrate_main(["--check", good]) == 0
    assert f"{good}: OK (calibration_table, digest {pt.digest})" in \
        capsys.readouterr().out
    assert pc.calibrate_main(["--check", good, tampered]) == 1
    out = capsys.readouterr().out
    assert "digest mismatch" in out and tampered in out
    assert jc.calibrate_main(["--check", good, tampered]) == 1
    assert capsys.readouterr().out == out


def test_calibrate_refuses_a_missing_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "t.json")
    assert pc.calibrate_main(["--models", "transformer", "--out", out]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(out)
    _, pt = _toy_pair()
    table = str(tmp_path / "toy.json")
    pt.save(table)
    assert pc.calibrate_bench_main(["--table", table]) == 1
    assert pc.device_kind("cuda") == "unknown"
    assert pc.device_kind("cpu") == "cpu"


def test_calibrate_on_the_cpu_then_bench_and_search_bench(tmp_path,
                                                          capsys):
    """A tiny harvest on the CPU (asked for), its --check, the
    calibrate-bench sweep over it, and search-bench consuming it: the
    rows carry the estimator name and the table's digest."""
    from flexflow_tpu_torch.search import bench as port_bench
    path = str(tmp_path / "table.json")
    assert pc.calibrate_main(
        ["--models", "transformer,dlrm", "--iters", "1", "--samples", "1",
         "--degrees", "1", "--device", "cpu", "--out", path]) == 0
    wrote = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    table = pc.CalibrationTable.load(path)
    assert wrote["digest"] == table.digest and wrote["op_entries"] > 0
    assert wrote["device_kind"] == table.device_kind == "cpu"
    assert set(table.dispatch) == {"train|transformer|k1|b8",
                                   "train|dlrm|k1|b8"}
    assert wrote["step_correction"] == table.step_correction
    assert pc.validate_file(path) == []
    bench_out = str(tmp_path / "bench.json")
    assert pc.calibrate_bench_main(
        ["--table", path, "--models", "transformer", "--iters", "1",
         "--samples", "1", "--estimator", "ridge", "--device", "cpu",
         "--out", bench_out]) == 0
    capsys.readouterr()
    assert pc.validate_file(bench_out) == []
    rep = json.load(open(bench_out))
    assert rep["calibration_digest"] == table.digest
    assert rep["estimator"] == "ridge" and rep["device_kind"] == "cpu"
    (row,) = rep["models"]
    assert row["per_op"]["n_measured"] > 0
    for est in ("table", "ridge"):
        port_bench.main(["--graphs", "transformer", "--devices", "4",
                         "--steps", "8", "--budget", "5", "--min-time",
                         "0.05", "--calibration", path, "--estimator", est,
                         "--device", "cpu"])
        (r,) = json.loads(capsys.readouterr().out)["results"]
        assert r["estimator"] == est
        assert r["calibration_digest"] == table.digest
        assert r["device_kind"] == "cpu"


def test_bench_model_rows_share_one_measurement():
    """calibrate-bench's rows for two estimators come from one set of
    measurements: the measured step and the analytic columns are the
    same, the calibrated ones are each estimator's."""
    model, x, y = pc.ZOO["transformer"](4, "float32", "cpu")
    t = pc.CalibrationTable(device_kind="cpu", compute_dtype="float32")
    pc.harvest_ops(t, model.layers, compute_dtype="float32", iters=1,
                   samples=1, device="cpu")
    ests = {"table": pc.TableEstimator(t), "ridge": pc.RidgeEstimator(t)}
    rows = pc.bench_model_rows("transformer", model, x, y, ests, t,
                               port_cost.spec_for_device(),
                               compute_dtype="float32", iters=1,
                               samples=1, epochs=1)
    a, b = rows["table"], rows["ridge"]
    assert a["end_to_end"]["measured_ms_per_step"] == \
        b["end_to_end"]["measured_ms_per_step"] > 0
    assert a["per_op"]["mape_analytic"] == b["per_op"]["mape_analytic"]
    assert a["end_to_end"]["sim_analytic_ms"] == \
        b["end_to_end"]["sim_analytic_ms"]
    payload = {"kind": "calib_bench", "calibration_digest": t.digest,
               "models": [a, b]}
    assert pc.validate_bench(payload) == jc.validate_bench(payload) == []
