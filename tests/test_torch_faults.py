"""The port's ``FF_FAULT`` switchboard against the JAX package's, on the
CPU: the grammar parses every spec to the same ``FaultSpec`` as
``flexflow_tpu.faults.parse_faults`` and rejects the same typos; rank
and attempt scoping; the per-family filters; and the serving,
generation and fleet fire points in the port's engines (the router's
are held in ``tests/test_torch_cluster.py``).
"""

import dataclasses
import os

import numpy as np
import pytest

from flexflow_tpu import faults as jax_faults
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import faults
from flexflow_tpu_torch.fflogger import capture_events, silenced
from flexflow_tpu_torch.serving import (GenerationCancelled,
                                        GenerationEngine, ServingEngine)

NFEAT, NCLS = 12, 5

GOOD = [
    "", "kill_at_step:7,rank=1",
    "kill_at_step:7,rank=1;corrupt_ckpt:latest,attempt=*;"
    "slow_rank:0,delay=0.5;spawn_fail_attempt:2",
    "grow_at_step:5;shrink_at_step:3,devices=2,rank=1",
    "serve_slow_dispatch:3,ms=20", "serve_fail_dispatch:2,every=3",
    "serve_queue_spike:4,rows=64", "serve_cancel_at_token:5",
    "serve_slow_decode:200,ms=40", "spec_draft_fail:2",
    "fleet_load_fail:ranker;fleet_swap_at_dispatch:5",
    "migrate_fail_at:1", "route_host_down:pf0",
    "migrate_fail_at:2;route_host_down:dc0,attempt=1",
    " corrupt_ckpt:4 ; kill_at_step:5 , rank = 1 ",
    "hang_at_step:5,rank=0,attempt=0", "kill_at_step:-1,exit=9",
]

BAD = [
    "kill_at_stpe:7", "kill_at_step", "kill_at_step:",
    "kill_at_step:7,bogus=1", "kill_at_step:7,rank",
    "corrupt_ckpt:latst", "shrink_at_step:half", "grow_at_step:5,devices=0",
    "grow_at_step:5,devices=x", "serve_slow_dispatch:2,ms=-1",
    "kill_at_step:7,exit=9.5", "serve_fail_dispatch:2,every=0",
    "fleet_load_fail", "migrate_fail_at:one", "route_host_down",
    "migrate_fail_at:1,rows=0",
]


@pytest.fixture
def fault_env():
    faults.reset()
    yield
    os.environ.pop("FF_FAULT", None)
    faults.reset()


@pytest.mark.parametrize("text", GOOD)
def test_grammar_parses_equal_to_jax(text):
    got = [dataclasses.astuple(s) for s in faults.parse_faults(text)]
    want = [dataclasses.astuple(s) for s in jax_faults.parse_faults(text)]
    assert got == want


@pytest.mark.parametrize("text", BAD)
def test_typos_rejected_as_jax(text):
    with pytest.raises(ValueError) as ours:
        faults.parse_faults(text)
    with pytest.raises(ValueError) as theirs:
        jax_faults.parse_faults(text)
    assert str(ours.value) == str(theirs.value)


def test_kinds_and_families_equal_jax():
    for name in ("KINDS", "SERVE_KINDS", "GENERATION_KINDS",
                 "FLEET_KINDS", "ROUTER_KINDS"):
        assert getattr(faults, name) == getattr(jax_faults, name)


def test_family_filters_and_scoping(fault_env, monkeypatch):
    os.environ["FF_FAULT"] = ("serve_slow_dispatch:1;spec_draft_fail:1;"
                              "fleet_load_fail:a;migrate_fail_at:2;"
                              "route_host_down:h,rank=1;"
                              "serve_fail_dispatch:1,attempt=1")
    faults.reset()
    assert [s.kind for s in faults.serve_faults()] == [
        "serve_slow_dispatch"]
    assert [s.kind for s in faults.generation_faults()] == [
        "spec_draft_fail"]
    assert [s.arg for s in faults.fleet_faults()] == ["a"]
    # the rank is unknown: the rank-qualified spec does not fire
    assert faults.current_rank() is None
    assert [s.kind for s in faults.router_faults()] == ["migrate_fail_at"]
    faults.set_rank(1)
    assert [s.kind for s in faults.router_faults()] == [
        "migrate_fail_at", "route_host_down"]
    monkeypatch.setenv("FF_ELASTIC_ATTEMPT", "1")
    assert [s.kind for s in faults.serve_faults()] == [
        "serve_fail_dispatch"]
    faults.reset()
    assert faults.current_rank() is None


def test_no_plan_is_cost_free(fault_env):
    assert faults.plan() is None
    assert faults.serve_faults() == [] == faults.router_faults()


# ----------------------------------------------------------------------
# fire points in the port's engines
# ----------------------------------------------------------------------
def _dense():
    cfg = ft.FFConfig(batch_size=8, compute_dtype="float32", seed=0)
    m = ft.FFModel(cfg, device="cpu")
    x = m.create_tensor((8, NFEAT), name="x")
    m.dense(x, NCLS)
    m.compile()
    m.init_layers(seed=0)
    return m


def _rows(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, NFEAT)).astype(np.float32)


def test_serve_slow_dispatch_sleeps_through_the_injected_sleep(fault_env):
    os.environ["FF_FAULT"] = "serve_slow_dispatch:2,ms=30"
    faults.reset()
    slept = []
    with silenced("serve"), ServingEngine(_dense(), stats_every=0,
                                          sleep=slept.append) as eng:
        for i in range(3):
            eng.submit(_rows(2, i)).result(timeout=60)
    assert slept == [0.03, 0.03]


def test_serve_fail_dispatch_fails_batches_and_serves_on(fault_env,
                                                         tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("FF_FLIGHT_DIR", str(tmp_path))
    os.environ["FF_FAULT"] = "serve_fail_dispatch:2"
    faults.reset()
    with capture_events("serve") as ev:
        with ServingEngine(_dense(), stats_every=0,
                           max_wait_ms=0.0) as eng:
            outs = []
            for i in range(4):
                try:
                    outs.append(eng.submit(_rows(2, i)).result(timeout=60))
                except RuntimeError as e:
                    outs.append(e)
            snap = eng.stats()
    assert [isinstance(o, RuntimeError) for o in outs] == [
        True, True, False, False]
    assert snap["errors"] == 2 and snap["requests"] == 2
    errs = [e for e in ev if e["event"] == "serve_dispatch_error"]
    assert len(errs) == 2 and "injected" in errs[0]["error"]
    states = [e["state"] for e in ev if e["event"] == "serve_health"]
    assert "degraded" in states            # two consecutive errors
    assert any(p.name.startswith("flight_serve_dispatch_error")
               for p in tmp_path.iterdir())


def test_serve_queue_spike_goes_through_admission(fault_env):
    os.environ["FF_FAULT"] = "serve_queue_spike:0,rows=64"
    faults.reset()
    with silenced("serve"), ServingEngine(
            _dense(), stats_every=0, max_queue_rows=16,
            admission="reject") as eng:
        eng.submit(_rows(2)).result(timeout=60)
    snap = eng.stats()
    # the spike fires before dispatch 0, with the request already taken
    # off the queue: 64 rows in chunks of max_batch 8 against a 16-row
    # bound, two chunks admitted and six rejected, each submitted
    assert snap["submitted"] == 1 + 8
    assert snap["rejected"] == 6 and snap["requests"] == 1


def _lm():
    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=0)
    m = ft.build_transformer_lm(cfg, num_layers=1, d_model=32, num_heads=2,
                                d_ff=64, seq_len=32, vocab_size=50,
                                device="cpu")[0]
    m.compile()
    m.init_layers(seed=0)
    return m


def test_serve_cancel_at_token_cancels_one_stream(fault_env):
    lm = _lm()
    os.environ["FF_FAULT"] = "serve_cancel_at_token:3"
    faults.reset()
    with capture_events("serve") as ev:
        with GenerationEngine(lm, slots=2, stats_every=0) as eng:
            a = eng.submit([3, 1, 4], max_new_tokens=8)
            with pytest.raises(GenerationCancelled):
                a.result(timeout=60)
            b = eng.submit([2, 7], max_new_tokens=8)
            assert len(b.result(timeout=60)) == 8
        snap = eng.stats()
    assert snap["cancelled"] == 1 and snap["requests"] == 1
    assert [e["at_token"] for e in ev
            if e["event"] == "gen_fault_cancel"] == [3]


def test_serve_slow_decode_and_spec_draft_fail(fault_env):
    lm = _lm()
    with silenced("serve"), GenerationEngine(lm, slots=2) as eng:
        want = [int(t) for t in eng.submit([5, 6, 7], max_new_tokens=6)
                .result(timeout=60)]
    os.environ["FF_FAULT"] = "serve_slow_decode:2,ms=10;spec_draft_fail:1"
    faults.reset()
    slept = []
    with capture_events("serve") as ev:
        eng = GenerationEngine(lm, slots=2, draft_model=lm, spec_gamma=2,
                               sleep=slept.append)
        with eng:
            got = [int(t) for t in eng.submit([5, 6, 7], max_new_tokens=6)
                   .result(timeout=60)]
        snap = eng.stats()
    assert got == want
    assert slept == [0.01, 0.01]
    assert snap["spec"] == "fallback" and snap["errors"] == 0
    health = [e for e in ev if e["event"] == "serve_health"
              and e.get("component") == "speculation"]
    assert [h["reason"] for h in health] == ["draft_error"]
    assert "spec_draft_fail" in health[0]["error"]
