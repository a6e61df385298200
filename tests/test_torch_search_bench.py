"""``search-bench`` in the port (``search/bench.py``) against the JAX
package's, on the CPU.

Under the reference spec (the JAX package's DeviceSpec values,
``_torch_search_cases.reference_spec``) and ``device="cpu"`` (the dense
attention rule the JAX package charges at these sequence lengths), a
row's graph, keys, best mesh and best simulated time, its search's
convergence stamps and its hybrid arm are the JAX package's, analytic
or calibrated.  Throughputs are timed on the host and are only checked
to be positive.
"""

import json

import pytest

import _torch_search_cases as cases
from flexflow_tpu.search import bench as jax_bench
from flexflow_tpu.search import calibration as jc
from flexflow_tpu_torch.search import bench as port_bench
from flexflow_tpu_torch.search import calibration as pc

TIMED = ("proposals_per_sec_full", "proposals_per_sec_delta", "speedup",
         "time_to_best_ms", "engine_stats")


def _rows(name, est=None, **kw):
    jest = pest = None
    if est is not None:
        jest = (jc.TableEstimator if est == "table"
                else jc.RidgeEstimator)(jc.default_table())
        pest = (pc.TableEstimator if est == "table"
                else pc.RidgeEstimator)(pc.default_table())
    kw = dict(dict(num_devices=8, steps=16, budget=30, min_time_s=0.02),
              **kw)
    want = jax_bench.bench_graph(name, estimator=jest, **kw)
    got = port_bench.bench_graph(name, estimator=pest, spec=cases.REF,
                                 device="cpu", **kw)
    return got, want


def _untimed(row):
    out = {k: v for k, v in row.items() if k not in TIMED}
    if "hybrid" in out:
        out["hybrid"] = {k: v for k, v in out["hybrid"].items()
                         if k not in TIMED}
    return out


@pytest.mark.parametrize("est", [None, "table", "ridge"])
@pytest.mark.parametrize("name", ["transformer", "dlrm", "mlp"])
def test_bench_row_equals_the_jax_package(name, est):
    got, want = _rows(name, est)
    json.dumps(got)
    assert set(got) == set(want)
    assert set(got["engine_stats"]) == set(want["engine_stats"])
    assert _untimed(got) == _untimed(want)
    assert got["proposals_per_sec_full"] > 0
    assert got["proposals_per_sec_delta"] > 0
    assert got["estimator"] == (est or "analytic")
    assert got["calibration_digest"] == (
        None if est is None else pc.default_table().digest)
    assert got["device_kind"] == "cpu"


@pytest.mark.parametrize("name", ["inception", "transformer", "mlp"])
def test_hybrid_arm_equals_the_jax_package(name):
    got, want = _rows(name, budget=20, hybrid=True)
    assert _untimed(got) == _untimed(want)
    assert got["hybrid"]["search_budget"] == 10
    rows = [got]
    assert port_bench.hybrid_acceptance(rows) == \
        jax_bench.hybrid_acceptance([want])


def test_hybrid_acceptance_and_validation_equal():
    rows = []
    for graph, beats, decomp, props in (
            ("transformer", True, False, 7), ("dlrm", False, False, 3),
            ("inception", True, False, 5), ("mlp", True, True, 0)):
        rows.append({"graph": graph, "num_devices": 8, "device_kind": "cpu",
                     "precision_policy": "f32", "estimator": "analytic",
                     "calibration_digest": None, "search_budget": 20,
                     "best_simulated_ms": 1.0, "time_to_best_ms": 0.1,
                     "acceptance_rate": 0.5,
                     "proposals_to_within_1pct": 2,
                     "hybrid": {"search_budget": 10,
                                "best_simulated_ms": 1.0, "regions": 1,
                                "exact_ops": 2, "residual_ops": 1,
                                "fully_decomposable": decomp,
                                "proposals": props, "beats_mcmc": beats,
                                "time_to_best_ms": 0.1,
                                "acceptance_rate": None,
                                "proposals_to_within_1pct": None}})
    for sub in (rows, rows[:1], rows[1:2], rows[3:]):
        assert port_bench.hybrid_acceptance(sub) == \
            jax_bench.hybrid_acceptance(sub)
    good = {"kind": "search_hybrid_bench", "results": rows,
            "acceptance": port_bench.hybrid_acceptance(rows)}
    bad_row = dict(rows[0], hybrid=dict(rows[0]["hybrid"],
                                        search_budget=15, proposals=-1))
    del bad_row["estimator"]
    del bad_row["hybrid"]["regions"]
    payloads = [good, [], {"kind": "x"}, dict(good, results=[]),
                dict(good, results=[1, dict(rows[1], hybrid=None),
                                    bad_row],
                     acceptance={"hybrid_le_mcmc_at_half_budget": 1}),
                dict(good, acceptance=None),
                dict(good, results=[{k: v for k, v in rows[0].items()
                                     if k != "calibration_digest"}])]
    for p in payloads:
        assert port_bench.validate_hybrid_bench(p) == \
            jax_bench.validate_hybrid_bench(p)
    assert port_bench.validate_hybrid_bench(good) == []


def test_convergence_stamps_and_proposal_sequence_equal():
    for st in ({}, {"proposals": 10, "accepted": 4, "time_to_best_ms": 1.25,
                    "best_trace": [(0, 5.0), (3, 2.02), (7, 2.0)]},
               {"proposals": 3, "accepted": 0,
                "best_trace": [(0, float("inf"))]}):
        assert port_bench._convergence_stamps(st) == \
            jax_bench._convergence_stamps(st)
    jm, pm = cases.pair("transformer")
    jseq = jax_bench._proposal_sequence(jm.layers, 8, 12, 3)
    pseq = port_bench._proposal_sequence(pm.layers, 8, 12, 3)
    assert [{k: cases.port_pc(v) for k, v in s.items()} for s in jseq] == \
        pseq


def test_main_writes_the_payload(tmp_path, capsys):
    out = tmp_path / "bench.json"
    port_bench.main(["--graphs", "mlp", "--devices", "4", "--steps", "8",
                     "--budget", "6", "--min-time", "0.02", "--hybrid",
                     "--device", "cpu", "--out", str(out)])
    payload = json.loads(capsys.readouterr().out)
    assert json.loads(out.read_text()) == payload
    assert payload["kind"] == "search_hybrid_bench"
    assert port_bench.validate_hybrid_bench(payload) == []
    assert payload["acceptance"]["fully_decomposable_zero_proposals"]
    with pytest.raises(SystemExit):
        port_bench.main(["--graphs", "mlp", "--estimator", "table",
                         "--device", "cpu"])
    with pytest.raises(SystemExit):
        port_bench.main(["--graphs", "resnet", "--device", "cpu"])
