"""The port's fleet bench (``serving/fleet/bench.py``) against the JAX
package's, on the CPU at a small size (hidden 16, cells of 0.2 s).

* ``validate_fleet_bench_json`` gives the JAX diagnostics on the
  committed ``artifacts/fleet_bench_r13.json`` (read, never written) and
  on mutated copies of it, one mutation a case.
* ``_reconciled`` agrees with the JAX identity on balanced and
  unbalanced counters.
* ``run_fleet_bench``'s payload carries the JAX payload's nested keys
  from the same arguments, on the CPU, with its logic booleans
  (``a_queue_bounded``, ``swap_zero_failed``, ``swap_reconciled``) true.
  The isolation ratio rests on host timing and is not compared.
"""

import copy
import json
import os

import pytest

import flexflow_tpu.serving.fleet.bench as jax_fb
from flexflow_tpu.fflogger import silenced as jax_silenced
from flexflow_tpu_torch.fflogger import silenced
from flexflow_tpu_torch.serving.fleet import bench as port_fb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(requests=32, rows_lo=1, rows_hi=4, max_batch=8, hidden_a=16,
             hidden_b=16, cell_seconds=0.2, seed=0)


@pytest.fixture(scope="module")
def artifact():
    with open(os.path.join(REPO, "artifacts", "fleet_bench_r13.json")) as f:
        return json.load(f)


def _drop(*path):
    def mutate(obj):
        for k in path[:-1]:
            obj = obj[k]
        del obj[path[-1]]
    return mutate


def _set(value, *path):
    def mutate(obj):
        for k in path[:-1]:
            obj = obj[k]
        obj[path[-1]] = value
    return mutate


MUTATIONS = {
    "as committed": lambda obj: None,
    "another bench": _set("serve-bench", "bench"),
    "no bench": _drop("bench"),
    "swap not an object": _set([], "swap"),
    "no summary": _drop("summary"),
    "ratio a string": _set("1.0", "summary", "b_goodput_ratio"),
    "no solo goodput": _drop("summary", "b_goodput_solo_rps"),
    "isolation an int": _set(1, "summary", "isolation_holds"),
    "swap flag missing": _drop("summary", "swap_reconciled"),
    "failed a float": _set(0.0, "swap", "in_flight_failed"),
    "config missing": _drop("config"),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_validate_gives_the_jax_diagnostics(artifact, case):
    obj = copy.deepcopy(artifact)
    MUTATIONS[case](obj)
    want = jax_fb.validate_fleet_bench_json(obj)
    assert port_fb.validate_fleet_bench_json(obj) == want
    assert (want == []) == (case == "as committed")


@pytest.mark.parametrize("obj", [[], "fleet-bench", None])
def test_validate_refuses_a_non_object_as_the_jax_function(obj):
    assert port_fb.validate_fleet_bench_json(obj) == \
        jax_fb.validate_fleet_bench_json(obj) == \
        ["artifact must be a JSON object"]


@pytest.mark.parametrize("shed,submitted", [(0, 10), (2, 12), (1, 12)])
def test_reconciled_equals_the_jax_identity(shed, submitted):
    stats = {"requests": 8, "rejected": 1, "shed": shed, "expired": 1,
             "errors": 0}
    assert port_fb._reconciled(stats, submitted) == \
        jax_fb._reconciled(stats, submitted)


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return None


def test_fleet_bench_payload_has_the_jax_keys_and_logic():
    with silenced("ff", "serve"), jax_silenced("ff", "serve"):
        want = jax_fb.run_fleet_bench(**SMALL)
        got = port_fb.run_fleet_bench(**SMALL, device="cpu")
    assert _keys(got) == _keys(want)
    assert got["bench"] == "fleet-bench" and got["backend"] == "cpu"
    assert got["device_kind"] == "cpu"
    assert {k: v for k, v in got["config"].items() if k != "slo_ms"} == \
        {k: v for k, v in want["config"].items() if k != "slo_ms"}
    assert port_fb.validate_fleet_bench_json(got) == []
    s = got["summary"]
    assert s["a_queue_bounded"] and s["swap_zero_failed"] \
        and s["swap_reconciled"], s
    assert got["swap"]["engine_generations"] == 2
    assert got["solo_b"]["reconciled"] and got["contended_b"]["reconciled"]
    assert got["contended_a_2x"]["reconciled"]
