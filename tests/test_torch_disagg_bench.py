"""The port's disaggregated-serving bench (``serving/cluster/bench.py``)
against the JAX package's, on the CPU.

* The calibrated replay (``_replay_colo`` at each chunk size and
  monolithic, ``_replay_disagg``) and the run helpers (``_mk_run``,
  ``_goodput``, ``_keep_best``) give the JAX outputs on one fixed
  calibration dict and one list of lengths: equal rows, floats included,
  since both run the same Python arithmetic.
* ``run_disagg_bench``'s payload carries the JAX payload's nested keys
  from the same arguments (1 layer, d_model 32, ``max_seq`` 64), with
  its logic booleans (colo/disagg tokens identical with the prefix cache
  on and off, reconciliation, every stream migrated) true, ``backend``
  the torch device type and ``config.pf_pace_s`` 0.0.
* The bench restores the process's switch interval on every way out,
  a failing arm included.
* Each wall arm reads its engines' ``stats()`` after they stop: with the
  engine's count of a finished request delayed 50 ms, a snapshot taken
  while the engines run (the order before the repair) misses the last
  request, and the arms' snapshots do not.
"""

import sys
import time

import pytest

import flexflow_tpu.serving.cluster.bench as jax_cb
from flexflow_tpu.fflogger import silenced as jax_silenced
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.fflogger import silenced
from flexflow_tpu_torch.serving.cluster import bench as port_cb
from flexflow_tpu_torch.serving.generation import bench as port_gb
from flexflow_tpu_torch.serving.generation.engine import (GenerationEngine,
                                                          GenerationMetrics)

from test_torch_gen_bench import _assert_keys

CAL = {"decode_step_ms": 3.25, "chunk_op_ms": {"8": 2.5, "16": 4.75},
       "mono_prefill_ms": [11.0, 13.5, 9.25, 12.0],
       "migrate_export_ms": 0.75, "migrate_import_ms": 0.5,
       "migrate_handoff_ms": 0.25}
LENGTHS = [40, 53, 33, 47]
SMALL = dict(requests=2, prompt_lo=40, prompt_hi=48, flood_new=2,
             victim_new=10, slots=2, max_seq=64, d_model=32, num_heads=2,
             num_layers=1, seed=0, chunks=(8, 16), pf_chunk=16, repeats=1,
             parity_prompts=2, parity_new=4)


@pytest.fixture(autouse=True)
def _quiet():
    with silenced("ff", "serve"), jax_silenced("ff", "serve"):
        yield
    ft.set_default_device(None)


@pytest.mark.parametrize("chunk", [0, 8, 16])
@pytest.mark.parametrize("flood_new", [1, 3])
def test_replay_colo_equals_the_jax_replay(chunk, flood_new):
    assert port_cb._replay_colo(CAL, LENGTHS, chunk, flood_new) == \
        jax_cb._replay_colo(CAL, LENGTHS, chunk, flood_new)


@pytest.mark.parametrize("flood_new", [1, 2, 5])
def test_replay_disagg_equals_the_jax_replay(flood_new):
    assert port_cb._replay_disagg(CAL, LENGTHS, flood_new) == \
        jax_cb._replay_disagg(CAL, LENGTHS, flood_new)


SNAPS = [{"submitted": 3, "requests": 0, "rejected": 0, "shed": 0,
          "expired": 0, "errors": 0, "cancelled": 0},
         {"submitted": 0, "requests": 3, "rejected": 0, "shed": 0,
          "expired": 0, "errors": 0, "cancelled": 0}]


@pytest.mark.parametrize("gaps", [[0.004, 0.0125, 0.007], []])
def test_run_helpers_equal_the_jax_helpers(gaps):
    ttfts = [0.021, 0.0335, 0.018]
    got = port_cb._mk_run(gaps, ttfts, 0.25, SNAPS, 2)
    want = jax_cb._mk_run(gaps, ttfts, 0.25, SNAPS, 2)
    assert got == want
    assert got["reconciliation_ok"]
    unbalanced = [dict(SNAPS[0], submitted=4), SNAPS[1]]
    assert port_cb._mk_run(gaps, ttfts, 0.25, unbalanced, 2) == \
        jax_cb._mk_run(gaps, ttfts, 0.25, unbalanced, 2)
    for slo in (20.0, 25.0, 40.0):
        assert port_cb._goodput(got, slo) == jax_cb._goodput(want, slo)
    other = port_cb._mk_run([0.009], ttfts, 0.3, SNAPS, 2)
    for a, b in ((None, got), (got, other), (other, got)):
        assert port_cb._keep_best(a, b) == jax_cb._keep_best(a, b)


def test_disagg_bench_payload_has_the_jax_keys_and_logic():
    want = jax_cb.run_disagg_bench(**SMALL)
    got = port_cb.run_disagg_bench(**SMALL, device="cpu")
    _assert_keys(got, want)
    assert got["bench"] == "disagg" and got["backend"] == "cpu"
    assert got["num_devices"] == 1 and got["device_kind"] == "cpu"
    assert got["estimator"] == want["estimator"] == "calibrated-replay"
    assert got["config"].pop("pf_pace_s") == 0.0
    assert {k: v for k, v in got["config"].items() if k != "slo_ms"} == \
        {k: v for k, v in want["config"].items() if k != "slo_ms"}
    acc = got["acceptance"]
    assert acc["tokens_bit_identical"] and acc["reconciliation_ok"] \
        and acc["all_migrated"], acc
    assert got["parity"] == {"prompts": 2, "max_new": 4,
                             "prefix_on": True, "prefix_off": True}
    assert got["disagg"]["migrations"] == SMALL["requests"] + 1
    assert got["comm_plan_digest"] == want["comm_plan_digest"]


def test_switch_interval_restored_when_an_arm_fails(monkeypatch):
    def boom(*a, **kw):
        assert sys.getswitchinterval() == 0.0005
        raise RuntimeError("arm failed")

    monkeypatch.setattr(port_cb, "run_colo_arm", boom)
    before = sys.getswitchinterval()
    with pytest.raises(RuntimeError, match="arm failed"):
        port_cb.run_disagg_bench(**SMALL, device="cpu")
    assert sys.getswitchinterval() == before


def _snapshot_while_running(arm, model, floods):
    """The wall arm as it was before the repair: the engines' stats()
    read as soon as the streams end, while the engines still run."""
    args = (floods, SMALL["victim_new"], SMALL["flood_new"])
    if arm == "colo":
        eng = GenerationEngine(model, slots=SMALL["slots"],
                               max_seq=SMALL["max_seq"], stats_every=0,
                               prefill_chunk=SMALL["pf_chunk"],
                               prefix_cache="off")
        with eng:
            gaps, ttfts, dt = port_cb._interference_once(eng.submit, *args)
            snaps = [eng.stats()]
    else:
        router, fleets, engines = port_cb.build_disagg(
            model, SMALL["slots"], SMALL["max_seq"], SMALL["pf_chunk"])
        try:
            gaps, ttfts, dt = port_cb._interference_once(
                lambda p, **kw: router.submit("lm", p, **kw), *args)
            snaps = [e.stats() for e in engines]
        finally:
            router.stop()
            for f in fleets:
                f.stop()
    return port_cb._mk_run(gaps, ttfts, dt, snaps, SMALL["flood_new"])


@pytest.mark.parametrize("arm", ["colo", "disagg"])
def test_arm_snapshots_count_a_delayed_last_request(arm, monkeypatch):
    counted = GenerationMetrics.record_request

    def late(self, *a, **kw):
        time.sleep(0.05)
        counted(self, *a, **kw)

    monkeypatch.setattr(GenerationMetrics, "record_request", late)
    model = port_gb._build_lm(SMALL["slots"], SMALL["max_seq"],
                              SMALL["d_model"], SMALL["num_heads"],
                              SMALL["num_layers"], SMALL["seed"],
                              device="cpu")
    floods = port_cb.make_flood_trace(SMALL["requests"], SMALL["prompt_lo"],
                                      SMALL["prompt_hi"], SMALL["seed"])
    assert not _snapshot_while_running(arm, model,
                                       floods)["reconciliation_ok"]
    run = (port_cb.run_colo_arm if arm == "colo" else
           port_cb.run_disagg_arm)
    got = run(model, SMALL["slots"], SMALL["max_seq"], SMALL["pf_chunk"],
              floods, SMALL["victim_new"], SMALL["flood_new"], 1)
    assert got["reconciliation_ok"], got
