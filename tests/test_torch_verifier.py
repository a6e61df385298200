"""The static verifier in the port (``flexflow_tpu_torch.analysis``)
against the JAX package's ``flexflow_tpu.analysis``, on the CPU.

The same graph and the same strategy go through both packages'
``verify()``, with one explicit device spec (80 GB) and one
compiler-temp factor passed to both, and the reports must hold the same
``(code, severity, op, message, hint, count)`` rows in the same order.
The cases: the five committed ``artifacts/searched_*.pb`` on their
models at the file's batch and device count; the seeded defect classes
of ``tests/test_verifier.py`` (FF001-FF005, FF101-FF105, FF107-FF110,
FF112), the memory and fallback cases of ``tests/test_sharding_passes.py``
(FF108, FF121, FF120), the precision cases of ``tests/test_precision.py``
(FF140, FF141) and ``compile(verify=...)`` itself.  The placement
machinery under them is held too: the specs of every output and weight,
the predicted fallback sites, the memory high-water and its timeline and
the communication plan, over 200 seeded random strategies, exactly.
"""

import os
import warnings

import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu.analysis as jax_an
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.analysis as port_an
from flexflow_tpu.models import (build_dlrm as jax_dlrm,
                                 build_inception_v3 as jax_inception,
                                 build_nmt as jax_nmt,
                                 build_transformer as jax_transformer)
from flexflow_tpu.parallel import mesh as jax_mesh
from flexflow_tpu.parallel import sharding as jax_sharding
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu.search import cost_model as jax_cost
from flexflow_tpu.search.simulator import Simulator as JaxSimulator
from flexflow_tpu.strategy import dlrm_gen as jax_gen
from flexflow_tpu.strategy.proto import load_strategy_file
from flexflow_tpu_torch.parallel import mesh as port_mesh
from flexflow_tpu_torch.parallel import sharding as port_sharding
from flexflow_tpu_torch.search import cost_model as port_cost
from flexflow_tpu_torch.search.simulator import Simulator as PortSimulator
from flexflow_tpu_torch.strategy import dlrm_gen as port_gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one device for both packages: the JAX package's data-sheet fields keep
# their defaults (the memory passes read only the capacity)
HBM = 80e9
TEMP_FACTOR = 1.5
SPECS = {ff: jax_cost.DeviceSpec(hbm_capacity=HBM),
         ft: port_cost.H100_SXM_SPEC}
TINY = {ff: jax_cost.DeviceSpec(hbm_capacity=1e4),
        ft: port_cost.DeviceSpec(989e12, 67e12, 3.35e12, 1e4, 900e9)}
AN = {ff: jax_an, ft: port_an}
DEV = {ff: {}, ft: {"device": "cpu"}}


def rows(report):
    return [(d.code, str(d.severity), d.op, d.message, d.hint, d.count)
            for d in report]


def pc(pkg, dims, ids=None, **kw):
    if ids is None:
        ids = tuple(range(int(np.prod(dims))))
    return pkg.ParallelConfig(dims=tuple(dims), device_ids=tuple(ids), **kw)


def small_transformer(pkg, batch=8):
    cfg = pkg.FFConfig(batch_size=batch, compute_dtype="float32")
    fn = jax_transformer if pkg is ff else ft.build_transformer
    model, _, logits = fn(cfg, num_layers=1, d_model=32, num_heads=2,
                          d_ff=64, seq_len=8, vocab_size=128,
                          num_classes=4, **DEV[pkg])
    return model, logits


def small_dlrm(pkg, batch=8):
    cfg = pkg.FFConfig(batch_size=batch, compute_dtype="float32")
    fn = jax_dlrm if pkg is ff else ft.build_dlrm
    model, _, preds = fn(cfg, embedding_size=(64, 64), sparse_feature_size=8,
                         mlp_bot=(4, 16, 8), mlp_top=(24, 16, 1), **DEV[pkg])
    return model, preds


def both(case):
    """Run ``case(pkg)`` -> report for each package; assert equal rows
    and return them."""
    got = {pkg: rows(case(pkg)) for pkg in (ff, ft)}
    assert got[ft] == got[ff]
    return got[ft]


def _verify(pkg, model, strategies, **kw):
    kw.setdefault("check_resharding", False)
    kw.setdefault("spec", SPECS[pkg])
    kw.setdefault("xla_temp_factor", TEMP_FACTOR)
    return AN[pkg].verify(model.layers, strategies, **kw)


def _port_strategy(s):
    return {n: ft.ParallelConfig(
        device_type=ft.DeviceType(int(p.device_type)), dims=tuple(p.dims),
        device_ids=tuple(p.device_ids),
        memory_types=tuple(ft.MemoryType(int(m)) for m in p.memory_types),
        precision=p.precision) for n, p in s.items()}


# ---------------------------------------------------------------------
# the committed strategies on their models
# ---------------------------------------------------------------------
COMMITTED = [
    ("searched_inception_v3_b128_8dev.pb", "inception", 128, 8),
    ("searched_inception_v3_b128_32dev.pb", "inception", 128, 32),
    ("searched_nmt_b256_8dev.pb", "nmt", 256, 8),
    ("searched_transformer_b8_8dev.pb", "transformer", 8, 8),
    ("searched_transformer_b32_8dev.pb", "transformer", 32, 8),
]
FULL = {"inception": (jax_inception, ft.build_inception_v3),
        "nmt": (jax_nmt, ft.build_nmt),
        "transformer": (jax_transformer, ft.build_transformer)}


@pytest.mark.parametrize("fname,kind,batch,ndev", COMMITTED,
                         ids=[c[0] for c in COMMITTED])
def test_committed_strategy_same_report(fname, kind, batch, ndev):
    """Each committed strategy on its full-width model (the builders'
    defaults) at the file's batch and device count: the same rows,
    resharding pass included, and no ERROR."""
    strategies = load_strategy_file(os.path.join(REPO, "artifacts", fname))

    def case(pkg):
        fn = FULL[kind][0 if pkg is ff else 1]
        model = fn(pkg.FFConfig(batch_size=batch), **DEV[pkg])[0]
        s = strategies if pkg is ff else _port_strategy(strategies)
        return _verify(pkg, model, s, num_devices=ndev,
                       input_tensors=model.input_tensors,
                       final_tensors=model.layers[-1].outputs,
                       parameters=model.parameters, check_resharding=True)

    got = both(case)
    assert not [r for r in got if r[1] == "ERROR"], got[:5]


# ---------------------------------------------------------------------
# the seeded defect classes of tests/test_verifier.py
# ---------------------------------------------------------------------
def _defect_cases():
    def ff101(pkg):
        m, _ = small_transformer(pkg)
        return _verify(pkg, m, {"ffn_up_0": pc(pkg, (3, 1, 1))},
                       mesh_shape={"n": 3}, num_devices=3)

    def ff102_error(pkg):
        m, _ = small_transformer(pkg)
        return _verify(pkg, m, {"ffn_up_0": pc(pkg, (1, 1, 1, 2), (0, 1))},
                       mesh_shape={"n": 2}, num_devices=2)

    def ff102_info(pkg):
        m, _ = small_transformer(pkg)
        return _verify(pkg, m, {"ffn_up_0": pc(pkg, (2,), (0, 1))},
                       mesh_shape={"n": 2}, num_devices=2)

    def ff103(pkg):
        m, _ = small_transformer(pkg)
        return _verify(pkg, m, {"ln_attn_0": pc(pkg, (2, 1, 1), (0,))},
                       mesh_shape={"n": 2}, num_devices=2)

    def ff104(pkg):
        m, _ = small_transformer(pkg)
        return _verify(pkg, m, {"ln_attn_0": pc(pkg, (2, 1, 1), (0, 99))},
                       mesh_shape={"n": 2}, num_devices=2)

    def ff105(pkg):
        m, _ = small_transformer(pkg)
        return _verify(pkg, m, {"ln_attn_0": pc(pkg, (4, 1, 1))},
                       mesh_shape={"n": 6}, num_devices=6)

    def ff108_ff121(pkg):
        m, _ = small_transformer(pkg)
        return _verify(pkg, m, {"ffn_up_0": pc(pkg, (1, 1, 1))},
                       mesh_shape={"n": 1}, num_devices=1, spec=TINY[pkg])

    def ff110(pkg):
        m, _ = small_transformer(pkg)
        return _verify(pkg, m, {"not_an_op": pc(pkg, (1, 1))},
                       mesh_shape={"n": 1}, num_devices=1)

    def ff112(pkg):
        m, _ = small_transformer(pkg)
        return _verify(pkg, m, {"ln_attn_0": pc(pkg, (8, 1, 1))},
                       num_devices=2)

    def ff111_ff120(pkg):
        # non-canonical ids; degree 3 neither divides batch 8 nor maps
        # onto the n axis of 4
        m, _ = small_transformer(pkg)
        return _verify(pkg, m, {"ln_attn_0": pc(pkg, (3, 1, 1), (2, 1, 0)),
                                "ffn_up_0": pc(pkg, (2, 1, 2))},
                       mesh_shape={"n": 4, "c": 2}, num_devices=8)

    def graph_dup_dead(pkg):
        model = pkg.FFModel(pkg.FFConfig(batch_size=4,
                                         compute_dtype="float32"),
                            **DEV[pkg])
        x = model.create_tensor((4, 8), name="x")
        t = model.dense(x, 8, name="dup")
        t = model.dense(t, 8, name="dup")
        t2 = model.dense(t, 4, name="head")
        model.dense(t, 4, name="side")
        return AN[pkg].verify(model.layers, final_tensors=[t2])

    def graph_dangling_shape(pkg):
        model = pkg.FFModel(pkg.FFConfig(batch_size=4,
                                         compute_dtype="float32"),
                            **DEV[pkg])
        x = model.create_tensor((4, 8), name="x")
        model.create_tensor((4, 3), name="unused")
        t = model.dense(x, 8)
        t.owner_op.outputs[0].shape = (5, 8)
        return AN[pkg].verify(model.layers,
                              input_tensors=model.input_tensors,
                              final_tensors=[t])

    def softmax_head(pkg):
        m, logits = small_transformer(pkg)
        return AN[pkg].verify(m.layers, final_tensors=[logits])

    def ff107(pkg):
        m, _ = small_dlrm(pkg)
        s = {"embedding0": pkg.ParallelConfig(
                device_type=pkg.DeviceType.HOST, dims=(1, 1),
                memory_types=(pkg.MemoryType.FBM,)),
             "interact": pkg.ParallelConfig(
                device_type=pkg.DeviceType.HOST, dims=(1, 1),
                memory_types=(pkg.MemoryType.ZCM,)),
             "bot_dense_0": pkg.ParallelConfig(
                dims=(1, 1), memory_types=(pkg.MemoryType.FBM,
                                           pkg.MemoryType.ZCM))}
        return _verify(pkg, m, s, mesh_shape={"n": 1}, num_devices=1)

    def hetero_clean(pkg):
        m, _ = small_dlrm(pkg)
        gen = jax_gen if pkg is ff else port_gen
        return _verify(pkg, m, gen.generate_dlrm_hetero_strategy(
            1, 1, num_embeddings=2), num_devices=1,
            input_tensors=m.input_tensors, parameters=m.parameters)

    def ff109(pkg):
        m, _ = small_transformer(pkg)
        s = {"ffn_up_0": pc(pkg, (4, 1, 1)),
             "ffn_down_0": pc(pkg, (1, 1, 4))}
        return _verify(pkg, m, s, mesh_shape={"n": 4, "c": 4},
                       num_devices=16, check_resharding=True)

    def ff140_ff141(pkg):
        m, _ = small_transformer(pkg)
        s = {"attention_0": pc(pkg, (1, 1, 1), precision="bf16"),
             "ffn_up_0": pc(pkg, (1, 1, 1), precision="f32"),
             "ln_attn_0": pc(pkg, (1, 1, 1), precision="bf16")}
        return _verify(pkg, m, s, mesh_shape={"n": 1}, num_devices=1)

    return {f.__name__: f for f in (
        ff101, ff102_error, ff102_info, ff103, ff104, ff105, ff108_ff121,
        ff110, ff112, ff111_ff120, graph_dup_dead, graph_dangling_shape,
        softmax_head, ff107, hetero_clean, ff109, ff140_ff141)}


DEFECTS = _defect_cases()
EXPECT = {"ff101": "FF101", "ff102_error": "FF102", "ff102_info": "FF102",
          "ff103": "FF103", "ff104": "FF104", "ff105": "FF105",
          "ff108_ff121": "FF121", "ff110": "FF110", "ff112": "FF112",
          "ff111_ff120": "FF120", "graph_dup_dead": "FF005",
          "graph_dangling_shape": "FF001", "softmax_head": "FF005",
          "ff107": "FF107", "hetero_clean": "FF110", "ff109": "FF109",
          "ff140_ff141": "FF140"}


@pytest.mark.parametrize("name", sorted(DEFECTS))
def test_defect_case_same_report(name):
    got = both(DEFECTS[name])
    assert EXPECT[name] in [r[0] for r in got], got


# ---------------------------------------------------------------------
# placement, fallbacks, memory and communication over random strategies
# ---------------------------------------------------------------------
def _random_strategy(layers, rng, pkg) -> dict:
    degrees = (1, 2, 3, 4, 5, 8)
    out = {}
    for op in layers:
        if not op.outputs or rng.random() < 0.3:
            continue
        dims = tuple(int(rng.choice(degrees))
                     for _ in range(op.outputs[0].num_dims))
        prec = ("", "", "bf16", "f32")[int(rng.integers(4))]
        out[op.name] = pc(pkg, dims, precision=prec)
    return out


def spec(entries):
    """A spec as a tuple, a one-name sub-axis tuple spelled as the name
    (jax's PartitionSpec normalizes it so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def ignore(*site):
    pass


@pytest.mark.parametrize("builder", [small_transformer, small_dlrm])
def test_random_strategies_same_placement_memory_and_plan(builder):
    """100 seeded random strategies per model (legal and illegal degrees
    mixed) on a {n: 4, c: 2} mesh: every output's and weight's spec, the
    predicted fallback sites, the high-water with and without remat, the
    liveness timeline and the communication plan and its digest are the
    JAX package's, exactly."""
    mj, _ = builder(ff)
    mp, _ = builder(ft)
    shape = {"n": 4, "c": 2}
    amj, amp = jax_mesh.AbstractMesh(shape), port_mesh.AbstractMesh(shape)
    sim_j = JaxSimulator(num_devices=8, use_native=False,
                         opt_slot_bytes=8)
    sim_p = PortSimulator(num_devices=8, opt_slot_bytes=8)
    rng_j, rng_p = np.random.default_rng(90), np.random.default_rng(90)
    for i in range(100):
        sj = _random_strategy(mj.layers, rng_j, ff)
        sp = _random_strategy(mp.layers, rng_p, ft)
        for oj, op_ in zip(mj.layers, mp.layers):
            for tj, tp in zip(oj.outputs, op_.outputs):
                assert spec(port_sharding.output_spec(
                    tp, sp.get(op_.name), amp, on_fallback=ignore)) == \
                    spec(jax_sharding.output_spec(
                        tj, sj.get(oj.name), amj, on_fallback=ignore)), \
                    (i, tp.name)
            for wj, wp in zip(oj.weights, op_.weights):
                assert spec(port_sharding.param_spec(
                    wp, sp.get(op_.name), amp, on_fallback=ignore)) == \
                    spec(jax_sharding.param_spec(
                        wj, sj.get(oj.name), amj, on_fallback=ignore)), \
                    (i, wp.name)
        assert port_an.predict_fallbacks(mp.layers, sp, amp) == \
            jax_an.predict_fallbacks(mj.layers, sj, amj), i
        for remat in (False, True):
            assert sim_p.peak_memory_bytes(
                mp.layers, sp, shape, assume_remat=remat) == \
                sim_j.peak_memory_bytes(mj.layers, sj, shape,
                                        assume_remat=remat), (i, remat)
            assert sim_p.memory_timeline(
                mp.layers, sp, shape, assume_remat=remat) == \
                sim_j.memory_timeline(mj.layers, sj, shape,
                                      assume_remat=remat), (i, remat)
        plan = port_an.communication_plan(mp.layers, sp, amp)
        assert plan == jax_an.communication_plan(mj.layers, sj, amj), i
        assert port_an.comm_plan_digest(plan) == \
            jax_an.comm_plan_digest(plan)


def test_mesh_axis_math_matches():
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 30, 64):
        assert port_mesh.prime_factors(n) == jax_mesh.prime_factors(n)
        assert port_mesh.expressible_degrees(n) == \
            jax_mesh.expressible_degrees(n)
        amj = jax_mesh.AbstractMesh({"n": n, "c": 2})
        amp = port_mesh.AbstractMesh({"n": n, "c": 2})
        for d in range(1, n + 2):
            assert port_mesh.degree_expressible(n, d) == \
                jax_mesh.degree_expressible(n, d)
            assert amp.axis_spec("n", d) == amj.axis_spec("n", d)
    assert port_mesh.scaled_shape({"n": 4, "c": 2}, 16) == \
        jax_mesh.scaled_shape({"n": 4, "c": 2}, 16)
    for rank in range(6):
        assert port_mesh.dim_axis_names(rank) == \
            jax_mesh.dim_axis_names(rank)
    for shape, rank, seq in (({"n": 4}, 2, False), ({"n": 2, "s": 2}, 3,
                                                    True)):
        assert port_sharding.batch_spec(
            rank, port_mesh.AbstractMesh(shape), seq) == tuple(
            jax_sharding.batch_spec(rank, jax_mesh.AbstractMesh(shape),
                                    seq))
    with pytest.raises(ValueError, match="unknown mesh axis"):
        port_mesh.AbstractMesh({"q": 2})


def test_fallback_recorder_drains_per_model():
    """The replicate-fallback record: sites aggregate with counts, a
    scoped drain takes only the names it owns, and the FF106 rows read
    as the JAX package's."""
    port_an.drain_fallback_sites()
    port_an.record_replicate_fallback("a:out0", 0, 3, "n", 4,
                                      "indivisible")
    port_an.record_replicate_fallback("a:out0", 0, 3, "n", 4,
                                      "indivisible")
    port_an.record_replicate_fallback("b:out0", 1, 2, None, 1, "no-axis")
    sites, dropped = port_an.drain_fallback_sites({"b:out0"})
    assert sites == {("b:out0", 1, 2, None, 1, "no-axis"): 1}
    assert dropped == 0
    port_rows = rows(port_an.drain_replicate_fallbacks())
    jax_an.drain_fallback_sites()
    jax_an.record_replicate_fallback("a:out0", 0, 3, "n", 4, "indivisible")
    jax_an.record_replicate_fallback("a:out0", 0, 3, "n", 4, "indivisible")
    assert port_rows == rows(jax_an.drain_replicate_fallbacks())
    assert port_an.drain_replicate_fallbacks() == []


def test_report_json_validates():
    m, _ = small_transformer(ft)
    report = _verify(ft, m, {"ffn_up_0": pc(ft, (3, 1, 1))},
                     mesh_shape={"n": 3}, num_devices=3)
    import json
    obj = json.loads(report.render_json())
    assert port_an.validate_report_json(obj) == []
    obj["diagnostics"][0]["code"] = "FF999"
    assert port_an.validate_report_json(obj)
    assert report.render_text() == _verify(
        ff, small_transformer(ff)[0], {"ffn_up_0": pc(ff, (3, 1, 1))},
        mesh_shape={"n": 3}, num_devices=3).render_text()


# ---------------------------------------------------------------------
# compile(verify=...)
# ---------------------------------------------------------------------
def _compile(pkg, model, logits, **kw):
    extra = {"mesh": MachineMesh({"n": 1})} if pkg is ff else {}
    model.compile(pkg.SGDOptimizer(lr=0.1),
                  "sparse_categorical_crossentropy", [],
                  final_tensor=logits, **extra, **kw)


def test_compile_verify_modes():
    """warn: one aggregated warning and the report kept; error: raises
    VerificationError with the rows; off: no report and no warning; a
    bad mode raises.  Here the strategy is one the port refuses to run
    (degree 3 needs three devices), so the mesh is given as one
    device's for both packages."""
    s = {"ffn_up_0": (3, 1, 1)}

    def make(pkg):
        m, logits = small_transformer(pkg)
        m.config.strategies = {k: pc(pkg, v) for k, v in s.items()}
        m.config.mesh_shape = {"n": 1}
        return m, logits

    reports = {}
    for pkg in (ff, ft):
        m, logits = make(pkg)
        with pytest.warns(UserWarning, match="FF101"):
            _compile(pkg, m, logits)
        reports[pkg] = rows(m.verify_report)
        m2, l2 = make(pkg)
        with pytest.raises(AN[pkg].VerificationError, match="FF101"):
            _compile(pkg, m2, l2, verify="error")
        m3, l3 = make(pkg)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _compile(pkg, m3, l3, verify="off")
        with pytest.raises(ValueError, match="verify"):
            m3.compile(verify="nope")
    assert reports[ft] == reports[ff]


@pytest.mark.parametrize("kind", ["transformer", "dlrm"])
def test_clean_compile_same_report_and_no_warning(kind):
    """A plain compile runs the graph passes (no strategy): no warning,
    and the report the JAX package's."""
    builder = small_transformer if kind == "transformer" else small_dlrm
    got = {}
    for pkg in (ff, ft):
        m, out = builder(pkg)
        extra = {"mesh": MachineMesh({"n": 1})} if pkg is ff else {}
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            if kind == "transformer":
                _compile(pkg, m, out)
            else:
                m.compile(pkg.SGDOptimizer(lr=0.1), metrics=[],
                          final_tensor=out, **extra)
        got[pkg] = rows(m.verify_report)
        assert m.verify_report.ok(port_an.Severity.INFO)
    assert got[ft] == got[ff]


def test_compile_verify_error_rejects_pinned_bf16():
    """tests/test_precision.py's case: a bf16 pin on a softmax head is
    FF140, an ERROR under verify='error', in both packages."""
    got = {}
    for pkg in (ff, ft):
        cfg = pkg.FFConfig(batch_size=4, compute_dtype="float32", seed=0)
        cfg.strategies["head"] = pkg.ParallelConfig(
            dims=(1, 1), device_ids=(0,), precision="bf16")
        extra = {"mesh": MachineMesh({"n": 1})} if pkg is ff else {}
        m = (ff.FFModel(cfg, **extra) if pkg is ff
             else ft.FFModel(cfg, device="cpu"))
        t = m.create_tensor((4, 32), name="x")
        t = m.dense(t, 3, name="d2")
        m.softmax(t, name="head")
        with pytest.raises(AN[pkg].VerificationError) as ei:
            m.compile(pkg.SGDOptimizer(lr=0.1),
                      loss_type="sparse_categorical_crossentropy",
                      verify="error")
        got[pkg] = rows(ei.value.report)
        assert any(r[0] == "FF140" for r in got[pkg])
    assert got[ft] == got[ff]


def test_memory_model_pieces_match():
    for tok in ("", "bf16", "f32"):
        for default in (2, 4):
            assert port_cost.precision_dtype_bytes(tok, default) == \
                jax_cost.precision_dtype_bytes(tok, default)
    mj, _ = small_transformer(ff)
    mp, _ = small_transformer(ft)
    for oj, op_ in zip(mj.layers, mp.layers):
        nd = op_.outputs[0].num_dims
        for degrees in ((1,) * nd, (2,) + (1,) * (nd - 1), (2,) * nd):
            axes = port_mesh.dim_axis_names(nd)
            for remat in (False, True):
                assert port_cost.op_memory_components(
                    op_, degrees, axes=axes, remat=remat) == \
                    jax_cost.op_memory_components(
                        oj, degrees, axes=axes, remat=remat), op_.name
        assert op_.parallel_dims() == oj.parallel_dims(), op_.name
    assert port_cost.spec_for_device("NVIDIA H100 80GB HBM3") is \
        port_cost.H100_SXM_SPEC


def test_memory_gate_defaults_to_the_measured_factor():
    """With no factor given, FF108 charges the port's measured
    compiler-temp factor and the H100's 80 GB."""
    m, _ = small_transformer(ft)
    report = port_an.verify(m.layers, {"ffn_up_0": pc(ft, (1, 1, 1))},
                            mesh_shape={"n": 1}, num_devices=1,
                            spec=TINY[ft], check_resharding=False)
    (ff108,) = [d for d in report if d.code == "FF108"]
    assert f"incl. {port_cost.TEMP_FACTOR}x compiler-temp" in ff108.message
    assert port_cost.spec_for_device("unknown card").hbm_capacity == 80e9
