"""Per-op profiling in the port (``flexflow_tpu_torch/profiling.py``) and
the simulator's measure mode on the CPU, where the host clock times the
plain versions (the card's CUDA-event path runs in ``chip_smoke.py``'s
``search`` phase and ``tests/test_torch_cuda.py``).

``profile_op`` is finite for float ops and NaN for an op with no float
input or weight; measure mode scores an indivisible sub-problem and an
out-of-memory inf, and lets any other exception out (a kernel that fails
to build or launch is an error, not a slow config); its cache is keyed
as the JAX package's; a measured search runs and ``fit`` prints the
profile table under ``profiling``.  ``quantiles`` equals the JAX
package's.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import _torch_search_cases as cases
import flexflow_tpu_torch as ft
from flexflow_tpu.profiling import quantiles as jax_quantiles
from flexflow_tpu_torch import profiling
from flexflow_tpu_torch.search.mcmc import search
from flexflow_tpu_torch.search.simulator import Simulator


def _ops():
    m = cases.moe(ft)
    a = cases.alexnet(ft)
    t = cases.transformer(ft)
    return {op.name: op for op in m.layers + a.layers + t.layers}


@pytest.mark.parametrize("name", ["conv2d", "pool2d", "dense", "flat",
                                  "embedding", "rmsnorm", "moe",
                                  "attention_0", "ln_attn_0", "dropout"])
def test_profile_op_is_finite_for_float_ops(name):
    op = _ops()[name]
    r = profiling.profile_op(op, "float32", warmup=1, iters=2,
                             device="cpu")
    assert math.isfinite(r["fwd_ms"]) and r["fwd_ms"] > 0
    assert math.isfinite(r["bwd_ms"]) and r["bwd_ms"] >= 0


def test_profile_op_gives_nan_for_int_only_ops():
    m = cases._model(ft)
    ids = m.create_tensor((8, 16), "int32")
    m.reshape(ids, (8, 4, 4))
    r = profiling.profile_op(m.layers[0], device="cpu")
    assert math.isnan(r["fwd_ms"]) and math.isnan(r["bwd_ms"])


def test_profile_op_times_a_partition_sub_shape():
    op = _ops()["dense"]
    ins, ws = op.sub_problem((2, 2))
    r = profiling.profile_op(op, "float32", warmup=1, iters=2,
                             input_shapes=ins, weight_shapes=ws,
                             device="cpu")
    assert math.isfinite(r["fwd_ms"])


def _measuring():
    return Simulator(spec=cases.REF, num_devices=8, measure=True,
                     compute_dtype="float32", device="cpu")


def test_indivisible_dims_score_inf():
    op = _ops()["dense"]
    sim = _measuring()
    assert sim._measure_op(op, (3, 1)) == (math.inf, math.inf)
    assert sim._op_time(op, (3, 1), backward=True) == math.inf
    assert (op.name, (3, 1)) in sim.measured()


def test_out_of_memory_scores_inf(monkeypatch):
    def oom(*a, **k):
        raise torch.OutOfMemoryError("out of memory")

    monkeypatch.setattr(profiling, "profile_op", oom)
    assert _measuring()._measure_op(_ops()["dense"], (2, 1)) == \
        (math.inf, math.inf)


def test_other_measurement_errors_propagate(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("nvcc failed for flash_attention.cu")

    monkeypatch.setattr(profiling, "profile_op", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _measuring()._measure_op(_ops()["attention_0"], (2, 1, 1))


def test_int_only_ops_fall_back_to_the_analytic_times():
    m = cases._model(ft)
    ids = m.create_tensor((8, 16), "int32")
    m.reshape(ids, (8, 4, 4))
    sim = _measuring()
    op = m.layers[0]
    fwd, bwd = sim._measure_op(op, (1, 1, 1))
    assert fwd == sim._analytic_time(op, (1, 1, 1), False)
    assert bwd == sim._analytic_time(op, (1, 1, 1), True)


def test_measured_search_runs_and_keys_its_cache_as_jax():
    m = cases.diamond(ft)
    sim = Simulator(num_devices=4, measure=True, compute_dtype="float32",
                    device="cpu")
    best, mesh, t = search(m.layers, 4, budget=6, seed=0, sim=sim)
    assert math.isfinite(t) and t > 0
    names = {op.name for op in m.layers}
    measured = sim.measured()
    assert measured
    for key, (fwd, bwd) in measured.items():
        name, dims = key
        assert name in names and isinstance(dims, tuple)
        assert fwd > 0 and bwd >= 0


def test_fit_prints_the_profile_table(capsys):
    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", profiling=True)
    m = ft.FFModel(cfg, device="cpu")
    x = m.create_tensor((4, 8))
    m.softmax(m.dense(x, 3))
    m.compile(ft.SGDOptimizer(lr=0.1))
    m.init_layers(seed=0)
    xs = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
    y = np.zeros((8, 1), np.int32)
    m.fit(xs, y, epochs=1)
    out = capsys.readouterr().out
    assert "fwd(ms)" in out and "dense" in out and "softmax" in out


def test_profile_model_rows():
    m = cases.diamond(ft)
    m.compile(ft.SGDOptimizer(lr=0.1))
    rows = profiling.profile_model(m)
    assert [r["name"] for r in rows] == [op.name for op in m.layers]
    assert all(math.isfinite(r["fwd_ms"]) for r in rows)


def test_time_calls_counts_calls():
    rate, n = profiling.time_calls(lambda: None, min_time_s=0.01)
    assert n >= 1 and rate > 0


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(0, 1e6, allow_nan=False), max_size=200),
       st.lists(st.sampled_from([0.0, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0]),
                min_size=1, max_size=4))
def test_quantiles_equal_the_jax_package(samples, qs):
    got = profiling.quantiles(samples, tuple(qs))
    want = jax_quantiles(samples, tuple(qs))
    assert list(got) == list(want)
    for q in got:   # an empty sample gives NaN in both
        assert got[q] == want[q] or (math.isnan(got[q])
                                     and math.isnan(want[q]))
