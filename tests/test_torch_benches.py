"""The port's benches (``train_bench.py``, ``precision_bench.py``,
``serving/bench.py``) against the JAX package's, on the CPU at tiny
sizes.

* Each bench's payload carries the JAX payload's keys (section by
  section, row by row); the port adds ``device`` to train-bench's rows.
* train-bench's ``dispatches`` equal the JAX rows' for every K, and
  ``bench_k``'s final loss is the JAX one within 1e-5 (absolute and
  relative: float32 steps of one MLP whose sums associate differently,
  the bound of ``tests/test_torch_train_knobs.py``) when the JAX model's
  weights are carried across with ``interop.params_from_jax_numpy``.
* precision-bench's search section under the JAX package's device spec
  (``_torch_search_cases.reference_spec``) and the dense attention rule
  (``device="cpu"``) equals the JAX section field for field; under the
  port's default, ``H100_SXM_SPEC``, it is recorded as it comes out.
* serve-bench on the CPU passes its bitwise engine-against-``predict``
  check, its ``--trace-out`` section reconciles, and the exported trace
  validates; the overload sweep gives one cell per multiple and policy.
"""

import contextlib
import io
import json

import numpy as np
import pytest

import flexflow_tpu.precision_bench as jax_pb
import flexflow_tpu.serving.bench as jax_sb
import flexflow_tpu.train_bench as jax_tb
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import interop
from flexflow_tpu_torch import precision_bench as port_pb
from flexflow_tpu_torch import train_bench as port_tb
from flexflow_tpu_torch.fflogger import silenced
from flexflow_tpu_torch.obs import trace as port_trace
from flexflow_tpu_torch.serving import bench as port_sb

from _torch_search_cases import reference_spec

TRAIN = dict(steps=6, batch_size=8, epochs=2, hidden=16, seed=0)
RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_default_device():
    yield
    ft.set_default_device(None)


def _payload(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        main(argv)
    return json.loads(out.getvalue())


def _assert_keys(port, jax_, path="payload"):
    """Every key of the JAX payload is in the port's, recursively into
    dicts and the rows of lists of dicts."""
    if isinstance(jax_, dict):
        assert isinstance(port, dict), path
        missing = set(jax_) - set(port)
        assert not missing, (path, sorted(missing))
        for k, v in jax_.items():
            if isinstance(v, (dict, list)) and k not in (
                    "best_mesh", "terminal_phases", "buckets"):
                _assert_keys(port[k], v, f"{path}.{k}")
    elif isinstance(jax_, list) and jax_ and isinstance(jax_[0], dict):
        assert len(port) == len(jax_), path
        for i, (p, j) in enumerate(zip(port, jax_)):
            _assert_keys(p, j, f"{path}[{i}]")


def test_train_bench_payload_has_the_jax_keys_and_dispatches():
    argv = ["--ks", "1,2,4", "--steps", "6", "--batch", "8", "--epochs",
            "1", "--hidden", "16"]
    port = _payload(port_tb.main, argv + ["--device", "cpu"])
    jax_ = _payload(jax_tb.main, argv)
    _assert_keys(port, jax_)
    assert [r["dispatches"] for r in port["results"]] == \
        [r["dispatches"] for r in jax_["results"]] == [6, 3, 2]
    assert all(r["device"] == "cpu" and r["steps_timed"] == 6
               for r in port["results"])
    assert port["comm_plan_digest"] == jax_["comm_plan_digest"]
    assert port["precision_policy"] == jax_["precision_policy"] == "f32"


@pytest.mark.parametrize("k", [1, 2, 4])
def test_bench_k_final_loss_equals_the_jax_bench(k):
    jax_model = jax_tb._build_model(k, TRAIN["batch_size"],
                                    TRAIN["hidden"], TRAIN["seed"])
    weights = {p.name: np.asarray(jax_model.get_weights(p.name))
               for p in jax_model.parameters}
    want = jax_tb.bench_k(k, **TRAIN)
    got = port_tb.bench_k(
        k, **TRAIN, device="cpu",
        init=lambda m: interop.params_from_jax_numpy(m, weights))
    assert got["dispatches"] == want["dispatches"]
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=RTOL, atol=ATOL)
    assert {k: v for k, v in got.items() if k != "device"}.keys() == \
        want.keys()


def test_precision_search_under_the_jax_spec_equals_the_jax_section():
    want = jax_pb.bench_search(budget=60, seed=0, num_devices=8)
    got = port_pb.bench_search(budget=60, seed=0, num_devices=8,
                               spec=reference_spec(), device="cpu")
    assert got == want


def test_precision_search_on_the_h100_spec_keeps_the_jax_fields():
    want = jax_pb.bench_search(budget=30, seed=0, num_devices=8)
    got = port_pb.bench_search(budget=30, seed=0, num_devices=8)
    assert got.keys() == want.keys()
    assert isinstance(got["mixed_beats_baseline"], bool)
    assert got["baseline_all_f32_ms"] > 0 and got["mixed_precision_ms"] > 0


def test_precision_bench_payload_has_the_jax_keys():
    argv = ["--budget", "20", "--steps", "4", "--epochs", "1",
            "--requests", "16"]
    port = _payload(port_pb.main, argv + ["--device", "cpu"])
    jax_ = _payload(jax_pb.main, argv)
    _assert_keys(port, jax_)
    assert port["backend"] == "cpu"
    assert port["serve"]["quality"]["bound_ok"] is True
    assert port["serve"]["int8_policy"] == jax_["serve"]["int8_policy"]
    assert port["train"]["bfloat16"]["precision_policy"] == \
        jax_["train"]["bfloat16"]["precision_policy"]


@pytest.fixture
def tracer():
    t = port_trace.get_tracer()
    yield t
    t.disable()
    t.reset()


def test_serve_bench_payload_parity_and_reconciled_trace(tmp_path, tracer):
    argv = ["--requests", "48", "--max-batch", "16", "--hidden", "16"]
    raw = tmp_path / "raw.json"
    port = _payload(port_sb.main, argv + ["--device", "cpu",
                                          "--trace-out", str(raw)])
    jax_ = _payload(jax_sb.main, argv + ["--trace-out",
                                         str(tmp_path / "jax_raw.json")])
    jax_trace = jax_.pop("trace")
    _assert_keys(port, jax_)
    assert port["backend"] == "cpu"
    assert port["config"]["buckets"] == jax_["config"]["buckets"]
    trace = port["trace"]
    assert trace.keys() == jax_trace.keys()
    assert trace["reconciled"] is True and trace["dropped"] == 0
    assert trace["counters"]["submitted"] == \
        sum(trace["terminal_phases"].values())
    with open(raw) as f:
        assert port_trace.validate_chrome_trace(
            port_trace.to_chrome(json.load(f))) == []
    assert not tracer.active    # the bench turns the tracer off


def test_serve_bench_parity_check_is_bitwise_on_the_cpu(monkeypatch):
    """On the CPU with the default buckets the engine-against-predict
    check demands bit equality; a bucket-1 list or a CUDA device takes
    the loose one."""
    import torch
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert port_sb._bitwise_parity((2, 4, 8), cpu)
    assert not port_sb._bitwise_parity((1, 2, 4), cpu)
    assert not port_sb._bitwise_parity((2, 4, 8), cuda)
    seen = []
    real = np.testing.assert_array_equal
    monkeypatch.setattr(np.testing, "assert_array_equal",
                        lambda a, b: seen.append(1) or real(a, b))
    with silenced("serve"):
        payload = port_sb.run_serve_bench(requests=24, max_batch=8,
                                          hidden=8, device="cpu")
    # request 0 in each of the two engine runs, then 8 engine-vs-naive
    # pairs
    assert len(seen) == 10
    assert payload["engine"]["dispatches"] > 0


def test_overload_sweep_has_one_cell_per_multiple_and_policy():
    kw = dict(requests=32, max_batch=8, hidden=8, cell_seconds=0.05,
              mults=(0.5, 2.0), policies=("fifo", "shed_oldest"))
    port = port_sb.run_overload_bench(device="cpu", **kw)
    jax_ = jax_sb.run_overload_bench(**kw)
    _assert_keys(port, jax_)
    cells = [(c["policy"], c["offered_mult"]) for c in port["cells"]]
    assert cells == [(p, m) for p in kw["policies"] for m in kw["mults"]]
    assert all(c["reconciled"] for c in port["cells"])
    assert set(port["summary"]) == set(jax_["summary"])
    assert port["backend"] == "cpu" and port["device_kind"] == "cpu"
