"""KV page migration and the disaggregated cluster of the port against
the JAX package, on the CPU.

A 2-layer, 32-wide causal LM (vocab 61, 64 positions) is built in both
packages with the JAX weights carried across, in float32.  The page
functions (``export_pages``/``import_pages``) give the JAX functions'
rows on the same pool contents, padded and not; a payload of another
geometry leaves the destination pool bit-unchanged.  A stream handed
from one engine to another decodes the co-located tokens, token for
token, equal to the JAX co-located engine's, with the prefix cache on and
off, both pools drain, and each payload's ``nbytes`` equals the JAX
payload's.  Through the router (the port's ``build_disagg``): routes,
migrations and ``migrated_bytes`` equal the JAX router's, speculative
decode on the decode host speculates and keeps the tokens, the
``migrate_fail_at`` and ``route_host_down`` faults behave as in
``tests/test_cluster.py``, and route and migrate spans reconcile with the
terminals.  Then the autoscaler, shared dispatcher turns and the FF132
topology gate, each held against the JAX package's.
"""

import os
import time

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.fflogger import silenced as jax_silenced
from flexflow_tpu.models import build_transformer_lm as jax_build_lm
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu.serving.cluster.bench import build_disagg as jax_disagg
from flexflow_tpu.serving.fleet import ModelRegistry as JaxRegistry
from flexflow_tpu.serving.fleet import TenantAutoscaler as JaxAutoscaler
from flexflow_tpu.serving.fleet import \
    fleet_gate_report as jax_fleet_gate_report
from flexflow_tpu.serving.generation import \
    GenerationEngine as JaxGenerationEngine
from flexflow_tpu.serving.generation.pages import \
    export_pages as jax_export_pages
from flexflow_tpu.serving.generation.pages import \
    import_pages as jax_import_pages
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import faults, interop
from flexflow_tpu_torch.fflogger import capture_events, silenced
from flexflow_tpu_torch.obs.trace import get_tracer
from flexflow_tpu_torch.serving.cluster import FleetRouter
from flexflow_tpu_torch.serving.cluster.bench import (_reconciled,
                                                      build_disagg)
from flexflow_tpu_torch.serving.fleet import (FleetEngine, ModelRegistry,
                                              TenantAutoscaler,
                                              fleet_gate_report)
from flexflow_tpu_torch.serving.generation import GenerationEngine
from flexflow_tpu_torch.serving.generation.pages import (export_pages,
                                                         import_pages)

VOCAB, SEQ, SLOTS = 61, 64, 4
LM = dict(num_layers=2, d_model=32, num_heads=2, d_ff=64, seq_len=SEQ,
          vocab_size=VOCAB)


@pytest.fixture(scope="module")
def lms():
    jcfg = ff.FFConfig(batch_size=4, compute_dtype="float32", seed=0)
    jm = jax_build_lm(jcfg, **LM)[0]
    jm.compile(ff.SGDOptimizer(lr=0.01), mesh=MachineMesh({"n": 1}))
    jm.init_layers(seed=0)
    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=0)
    tm = ft.build_transformer_lm(cfg, device="cpu", **LM)[0]
    tm.compile()
    tm.init_layers(seed=0)
    interop.params_from_jax_numpy(
        tm, {p.name: jm.get_weights(p.name) for p in jm.parameters})
    return jm, tm


@pytest.fixture
def tracer():
    tr = get_tracer()
    tr.reset()
    tr.configure(sample_rate=1.0)
    yield tr
    tr.disable()
    tr.reset()


@pytest.fixture
def fault_env():
    faults.reset()
    yield
    os.environ.pop("FF_FAULT", None)
    faults.reset()


def _prompts(n, seed=3, lo=4, hi=SEQ // 2):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, int(rng.integers(lo, hi))
                         ).astype(np.int32) for _ in range(n)]


def _shared_prompts():
    """Prompts over one 20-token prefix: a full page the trie shares."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, VOCAB, 20).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(1, VOCAB, n).astype(
        np.int32)]) for n in (3, 5, 2)]


def _tokens(stream, timeout=120):
    return [int(t) for t in stream.result(timeout=timeout)]


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def _drained(*engines):
    _wait(lambda: all(e._pool.pages_in_use == 0 for e in engines))
    return True


def _stop(router, fleets):
    router.stop()
    for f in fleets:
        f.stop()


def _colo(engine_cls, model, prompts, max_new, prefix_cache, quiet):
    eng = engine_cls(model, slots=SLOTS, max_seq=SEQ, stats_every=0,
                     prefill_chunk=8, prefix_cache=prefix_cache)
    with quiet("serve"), eng:
        return [_tokens(eng.submit(p, max_new_tokens=max_new))
                for p in prompts]


# ----------------------------------------------------------------------
# the page functions
# ----------------------------------------------------------------------
def _pool(seed, num_pages=6, psize=4, heads=3):
    rng = np.random.default_rng(seed)
    return {"attn0": {
        "k": rng.standard_normal((num_pages, psize, heads, 2)
                                 ).astype(np.float32),
        "v": rng.standard_normal((num_pages, psize, heads, 2)
                                 ).astype(np.float32)}}


@pytest.mark.parametrize("pad_to", [0, 2, 5])
def test_export_import_pages_equal_jax(pad_to):
    import jax.numpy as jnp

    src = _pool(0)
    dst = _pool(1)
    chain, dest = [4, 0], [1, 5]
    payload = export_pages(
        {n: {k: torch.from_numpy(v) for k, v in sub.items()}
         for n, sub in src.items()}, chain, 6, pad_to=pad_to)
    jpayload = jax_export_pages(
        {n: {k: jnp.asarray(v) for k, v in sub.items()}
         for n, sub in src.items()}, chain, 6, pad_to=pad_to)
    for leaf in ("k", "v"):
        got = payload["attn0"][leaf]
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jpayload["attn0"][leaf]))
    tdst = {n: {k: torch.from_numpy(v.copy()) for k, v in sub.items()}
            for n, sub in dst.items()}
    out = import_pages(tdst, payload, dest)
    jout = jax_import_pages(
        {n: {k: jnp.asarray(v) for k, v in sub.items()}
         for n, sub in dst.items()}, jpayload, dest)
    assert out is tdst                          # written in place
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(tdst["attn0"][leaf].numpy(),
                                      np.asarray(jout["attn0"][leaf]))
        np.testing.assert_array_equal(tdst["attn0"][leaf][dest].numpy(),
                                      src["attn0"][leaf][chain])


def test_export_pages_rejects_non_page_major():
    bad = {"lstm0": {"state": torch.zeros((3, 8))}}
    with pytest.raises(ValueError, match="page-major"):
        export_pages(bad, [0], num_pages=6)


@pytest.mark.parametrize("which", ["geometry", "graph", "rows"])
def test_mismatched_payload_leaves_pool_unchanged(which):
    src = {n: {k: torch.from_numpy(v) for k, v in sub.items()}
           for n, sub in _pool(0).items()}
    payload = export_pages(src, [2, 3], 6)
    if which == "geometry":
        payload["attn0"]["v"] = payload["attn0"]["v"][:, :2]
    elif which == "graph":
        payload = {"attn1": payload["attn0"]}
    dst = {n: {k: torch.from_numpy(v) for k, v in sub.items()}
           for n, sub in _pool(1).items()}
    before = {k: v.clone() for k, v in dst["attn0"].items()}
    pages = [0, 1, 4] if which == "rows" else [0, 1]
    with pytest.raises(ValueError):
        import_pages(dst, payload, pages)
    for k, v in dst["attn0"].items():
        assert torch.equal(v, before[k])


def test_payload_owns_its_memory():
    src = {n: {k: torch.from_numpy(v.copy()) for k, v in sub.items()}
           for n, sub in _pool(0).items()}
    first = export_pages(src, [1], 6)
    keep = first["attn0"]["k"].clone()
    src["attn0"]["k"][1] += 1.0
    second = export_pages(src, [1], 6)
    # one host buffer a payload, not shared with the next export
    assert torch.equal(first["attn0"]["k"], keep)
    assert not torch.equal(second["attn0"]["k"], keep)
    assert (first["attn0"]["k"].untyped_storage().data_ptr()
            == first["attn0"]["v"].untyped_storage().data_ptr())


# ----------------------------------------------------------------------
# migration between two engines
# ----------------------------------------------------------------------
def _pair_handoff(dst):
    """A handoff into ``dst`` that records each payload's nbytes and
    chain length."""
    seen = []

    def handoff(payload):
        seen.append((payload["nbytes"], payload["pages_used"]))
        return dst.adopt_migrated(payload)
    return handoff, seen


def _migrate_run(engine_cls, model, prompts, pc, quiet):
    pf = engine_cls(model, slots=SLOTS, max_seq=SEQ, stats_every=0,
                    prefill_chunk=8, prefix_cache=pc)
    dc = engine_cls(model, slots=SLOTS, max_seq=SEQ, stats_every=0,
                    prefix_cache=pc)
    handoff, seen = _pair_handoff(dc)
    with quiet("serve"), dc, pf:
        outs = [_tokens(pf.submit(p, max_new_tokens=6, handoff=handoff))
                for p in prompts]
        _drained(pf, dc) if pc == "off" else None
        snaps = [pf.stats(), dc.stats()]
    return outs, seen, snaps, (pf, dc)


@pytest.mark.parametrize("pc", ["off", "on"])
def test_engine_handoff_migrates_with_jax_parity(lms, pc):
    jm, tm = lms
    prompts = _prompts(3) + _shared_prompts()
    want = _colo(JaxGenerationEngine, jm, prompts, 6, pc, jax_silenced)
    assert _colo(GenerationEngine, tm, prompts, 6, pc, silenced) == want
    outs, seen, snaps, (pf, dc) = _migrate_run(GenerationEngine, tm,
                                               prompts, pc, silenced)
    jouts, jseen, _, _ = _migrate_run(JaxGenerationEngine, jm, prompts,
                                      pc, jax_silenced)
    assert outs == want == jouts
    assert seen == jseen and len(seen) == len(prompts)
    n = len(prompts)
    assert len(pf.migrate_export_ms) == len(dc.migrate_import_ms) == n
    assert snaps[0]["requests"] == 0 and snaps[1]["requests"] == n
    assert _reconciled(snaps)
    if pc == "on":
        # the prompts' full pages joined the decode engine's trie too
        assert snaps[1]["prefix_pages_cached"] >= 1


def test_lstm_graph_cannot_migrate_and_decodes_here():
    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=5)
    lstm = ft.build_lstm_lm(cfg, vocab_size=VOCAB, embed_dim=24,
                            hidden_dim=24, num_layers=1, seq_len=32,
                            device="cpu")[0]
    lstm.compile()
    lstm.init_layers(seed=5)
    prompt = [3, 1, 4, 1]
    with silenced("serve"), GenerationEngine(lstm, slots=2) as eng:
        want = _tokens(eng.submit(prompt, max_new_tokens=5))
    offered = []
    with capture_events("serve") as ev, \
            GenerationEngine(lstm, slots=2) as eng:
        got = _tokens(eng.submit(prompt, max_new_tokens=5,
                                 handoff=offered.append))
        snap = eng.stats()
    assert got == want and offered == [] and snap["errors"] == 0
    health = [e for e in ev if e["event"] == "serve_health"
              and e.get("component") == "migration"]
    assert [h["reason"] for h in health] == ["handoff_error"]
    assert "not pageable" in health[0]["error"]


def test_declined_handoff_decodes_colocated(lms):
    tm = lms[1]
    prompt = _prompts(1, seed=9)[0]
    want = _colo(GenerationEngine, tm, [prompt], 6, "off", silenced)
    with capture_events("serve") as ev, GenerationEngine(
            tm, slots=SLOTS, max_seq=SEQ, prefix_cache="off") as eng:
        got = _tokens(eng.submit(prompt, max_new_tokens=6,
                                 handoff=lambda p: False))
    assert [got] == want
    assert [e["reason"] for e in ev if e["event"] == "serve_health"
            and e.get("component") == "migration"] == ["handoff_declined"]


# ----------------------------------------------------------------------
# through the router
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pc", ["off", "on"])
def test_disagg_router_equals_jax(lms, pc):
    jm, tm = lms
    prompts = _prompts(2) + _shared_prompts()[:2]
    want = _colo(JaxGenerationEngine, jm, prompts, 6, pc, jax_silenced)
    with jax_silenced("serve"):
        jrouter, jfleets, _ = jax_disagg(jm, SLOTS, SEQ, 8,
                                         prefix_cache=pc, pf_pace_s=0.0)
        try:
            jgot = [_tokens(jrouter.submit("lm", p, max_new_tokens=6))
                    for p in prompts]
            jstats = jrouter.stats()
        finally:
            _stop(jrouter, jfleets)
    with silenced("serve"):
        router, fleets, (pf, dc) = build_disagg(tm, SLOTS, SEQ, 8,
                                                prefix_cache=pc)
    try:
        with silenced("serve"):
            got = [_tokens(router.submit("lm", p, max_new_tokens=6))
                   for p in prompts]
        rstats = router.stats()
        assert _reconciled([pf.stats(), dc.stats()])
        if pc == "off":
            assert _drained(pf, dc)
    finally:
        with silenced("serve"):
            _stop(router, fleets)
    assert got == want == jgot
    for key in ("routes", "migrations", "migrated_bytes",
                "migrate_attempts"):
        assert rstats[key] == jstats[key], key
    assert rstats["migrations"] == len(prompts)
    assert rstats["hosts"] == {
        "pf0": {"role": "prefill", "down": False, "models": ["lm"]},
        "dc0": {"role": "decode", "down": False, "models": ["lm"]}}


def test_speculative_decode_composes_with_migration(lms):
    tm = lms[1]
    prompt = np.arange(1, 7, dtype=np.int32)
    want = _colo(GenerationEngine, tm, [prompt], 8, "off", silenced)[0]
    with silenced("serve"):
        pf_eng = GenerationEngine(tm, slots=SLOTS, max_seq=SEQ,
                                  stats_every=0, prefill_chunk=8,
                                  prefix_cache="off")
        dc_eng = GenerationEngine(tm, slots=SLOTS, max_seq=SEQ,
                                  stats_every=0, prefix_cache="off",
                                  draft_model=tm, spec_gamma=2)
        pf, dc = FleetEngine(device="cpu"), FleetEngine(device="cpu")
        pf.add_engine("lm", pf_eng)
        dc.add_engine("lm", dc_eng)
        pf.start()
        dc.start()
        router = FleetRouter()
        router.add_host("pf0", pf, role="prefill")
        router.add_host("dc0", dc, role="decode")
        router.start()
    try:
        with silenced("serve"):
            got = _tokens(router.submit("lm", prompt, max_new_tokens=8))
        assert router.stats()["migrations"] == 1
        snap = dc_eng.stats()
        assert snap["spec_proposed_tokens"] > 0
        # the draft is the target itself: every proposal verifies
        assert snap["spec_accepted_tokens"] == snap["spec_proposed_tokens"]
        assert snap["spec_fallbacks"] == 0
        assert _reconciled([pf_eng.stats(), snap])
        assert _drained(pf_eng, dc_eng)
    finally:
        with silenced("serve"):
            _stop(router, (pf, dc))
    assert got == want


def _mixed_pair(model, slots0=2, slots1=2):
    engines = [GenerationEngine(model, slots=s, max_seq=SEQ,
                                stats_every=0, prefill_chunk=8,
                                prefix_cache="off")
               for s in (slots0, slots1)]
    fleets = (FleetEngine(device="cpu"), FleetEngine(device="cpu"))
    for f, e in zip(fleets, engines):
        f.add_engine("lm", e)
        f.start()
    r = FleetRouter()
    r.add_host("m0", fleets[0], role="mixed")
    r.add_host("m1", fleets[1], role="mixed")
    r.start()
    return r, fleets, tuple(engines)


class TestRouterFaults:
    def test_migrate_fail_at_falls_back_colocated(self, lms, tmp_path,
                                                  monkeypatch, fault_env):
        monkeypatch.setenv("FF_FLIGHT_DIR", str(tmp_path))
        tm = lms[1]
        prompt = np.arange(1, 7, dtype=np.int32)
        want = _colo(GenerationEngine, tm, [prompt], 6, "on", silenced)[0]
        os.environ["FF_FAULT"] = "migrate_fail_at:1"
        faults.reset()
        with silenced("serve"):
            router, fleets, (pf_eng, dc_eng) = build_disagg(
                tm, SLOTS, SEQ, 8)
        try:
            with silenced("serve"), capture_events("serve") as events:
                got = _tokens(router.submit("lm", prompt,
                                            max_new_tokens=6))
            rstats = router.stats()
            pf_snap, dc_snap = pf_eng.stats(), dc_eng.stats()
            assert _drained(pf_eng, dc_eng)
        finally:
            with silenced("serve"):
                _stop(router, fleets)
        assert got == want
        health = [e for e in events if e["event"] == "serve_health"
                  and e.get("component") == "migration"]
        assert len(health) == 1
        assert health[0]["status"] == "fallback"
        assert health[0]["reason"] == "handoff_error"
        assert rstats["migrations"] == 0
        assert rstats["migrate_attempts"] == 1
        assert pf_snap["requests"] == 1 and pf_snap["errors"] == 0
        assert dc_snap["submitted"] == 0 and dc_snap["errors"] == 0
        assert _reconciled([pf_snap, dc_snap])
        assert any("gen_migrate_error" in p.read_text()
                   for p in tmp_path.iterdir())

    def test_route_host_down_fault_drains_to_survivor(self, lms,
                                                      fault_env):
        os.environ["FF_FAULT"] = "route_host_down:m0"
        faults.reset()
        with silenced("serve"):
            router, fleets, (e0, e1) = _mixed_pair(lms[1])
        try:
            with silenced("serve"), capture_events("serve") as events:
                outs = [_tokens(router.submit("lm", p, max_new_tokens=4))
                        for p in _prompts(3, seed=5)]
            assert all(len(o) == 4 for o in outs)
            assert router.stats()["hosts"]["m0"]["down"] is True
            snap0, snap1 = e0.stats(), e1.stats()
            assert snap0["submitted"] == 0
            assert snap1["requests"] == 3 and snap1["errors"] == 0
            assert _reconciled([snap0, snap1])
            assert _drained(e0, e1)
        finally:
            with silenced("serve"):
                _stop(router, fleets)
        assert "router_host_down" in [e["event"] for e in events]

    def test_mark_down_requeues_queued_streams_to_survivor(self, lms):
        with silenced("serve"):
            router, fleets, (e0, e1) = _mixed_pair(lms[1], slots0=2)
        try:
            with silenced("serve"), capture_events("serve") as events:
                f0 = fleets[0]
                s1 = f0.submit("lm", _prompts(1, seed=7)[0],
                               max_new_tokens=32)
                s2 = f0.submit("lm", _prompts(1, seed=8)[0],
                               max_new_tokens=32)
                next(iter(s1))
                next(iter(s2))
                s3 = f0.submit("lm", _prompts(1, seed=9)[0],
                               max_new_tokens=4)
                s4 = f0.submit("lm", _prompts(1, seed=10)[0],
                               max_new_tokens=4)
                moved = router.mark_down("m0")
                assert moved == {"lm": 2}
                assert len(_tokens(s3)) == 4
                assert len(_tokens(s4)) == 4
                assert len(_tokens(s1)) == 32
                assert len(_tokens(s2)) == 32
            snap0, snap1 = e0.stats(), e1.stats()
            assert snap0["errors"] == 0 and snap1["errors"] == 0
            assert snap1["requests"] == 2
            assert _reconciled([snap0, snap1])
            assert _drained(e0, e1)
        finally:
            with silenced("serve"):
                _stop(router, fleets)
        assert "router_host_down" in [e["event"] for e in events]


def test_route_and_migrate_spans_reconcile(lms, tracer):
    prompts = _prompts(2, seed=11)
    with silenced("serve"):
        router, fleets, _ = build_disagg(lms[1], SLOTS, SEQ, 8)
    try:
        with silenced("serve"):
            for p in prompts:
                router.submit("lm", p, max_new_tokens=4).result(
                    timeout=120)
        rstats = router.stats()
    finally:
        with silenced("serve"):
            _stop(router, fleets)
    by_name = {}
    for s in tracer.snapshot()["spans"]:
        by_name.setdefault(s["name"], []).append(s)
    assert len(by_name.get("route", [])) == len(prompts)
    legs = {}
    for s in by_name.get("migrate", []):
        legs[s["args"]["phase"]] = legs.get(s["args"]["phase"], 0) + 1
    assert legs == {"export": len(prompts), "import": len(prompts)}
    assert rstats["migrations"] == len(prompts)
    assert tracer.terminal_phase_counts() == {"completed": len(prompts)}
    for s in by_name["route"]:
        assert s["args"]["host"] == "pf0"
        assert s["args"]["role"] == "prefill"
    assert router._c_migrations.labels(
        eng=router._eng, status="ok").value == len(prompts)
    assert router._c_bytes.value == rstats["migrated_bytes"] > 0


# ----------------------------------------------------------------------
# the autoscaler, shared turns, the FF132 gate
# ----------------------------------------------------------------------
_SAMPLES = [("a", 8.0, 1.0, 0.0), ("a", 8.0, 2.0, 0.5),
            ("a", 8.0, 2.0, 1.5), ("a", 8.0, 4.0, 3.0),
            ("a", 0.0, 4.0, 8.0), ("a", 0.0, 2.0, 9.5),
            ("a", 0.0, 1.0, 11.0), ("b", 9.0, 3.0, 0.0),
            ("b", 9.0, 6.0, 2.0), ("b", 0.0, 6.0, 9.0)]


def test_autoscaler_decisions_equal_jax():
    sc = TenantAutoscaler(window_s=4.0, every_s=1.0, high_depth=4.0,
                          low_depth=0.5, grow=2.0, max_scale=4.0)
    jsc = JaxAutoscaler(window_s=4.0, every_s=1.0, high_depth=4.0,
                        low_depth=0.5, grow=2.0, max_scale=4.0)
    got = [sc.observe(*s) for s in _SAMPLES]
    assert got == [jsc.observe(*s) for s in _SAMPLES]
    assert got[:4] == [2.0, None, 4.0, None]
    sc.forget("a")
    assert sc.observe("a", 0.0, 1.0, 12.0) is None


@pytest.mark.parametrize("kw", [dict(grow=1.0),
                                dict(low_depth=4.0, high_depth=4.0),
                                dict(window_s=0.0), dict(max_scale=0.5)])
def test_autoscaler_validation(kw):
    with pytest.raises(ValueError):
        TenantAutoscaler(**kw)


def _lm_builder(cfg, device):
    return ft.build_transformer_lm(cfg, num_layers=1, d_model=32,
                                   num_heads=2, d_ff=64, seq_len=32,
                                   vocab_size=50, device=device)[0]


def _jax_lm_builder(cfg):
    return jax_build_lm(cfg, num_layers=1, d_model=32, num_heads=2,
                        d_ff=64, seq_len=32, vocab_size=50)[0]


def test_share_identical_bit_parity():
    reg = ModelRegistry()
    for name in ("a", "b"):
        reg.register(name, _lm_builder, engine="generation", batch_size=2,
                     generation={"slots": 2, "max_new_tokens": 8,
                                 "stats_every": 0})
    prompt = [3, 1, 4, 1, 5]
    outs = {}
    for share in (False, True):
        with silenced("serve"), FleetEngine(
                reg, device="cpu", share_identical=share) as fl:
            streams = [(n, fl.submit(n, prompt, max_new_tokens=8))
                       for n in ("a", "b") for _ in range(2)]
            outs[share] = [(n, _tokens(s)) for n, s in streams]
            shared = fl._c_shared.value
        assert (shared > 0) == share
    assert outs[True] == outs[False]
    assert len({tuple(t) for _, t in outs[True]}) == 1


def _role_registries(decode_gen=None, prefill_gen=None, with_decode=True):
    regs = []
    for cls, builder in ((ModelRegistry, _lm_builder),
                         (JaxRegistry, _jax_lm_builder)):
        reg = cls()
        reg.register("pf", builder, engine="generation", batch_size=2,
                     role="prefill",
                     generation=dict({"slots": 2, "max_seq": 32,
                                      "stats_every": 0},
                                     **(prefill_gen or {})))
        if with_decode:
            reg.register("dc", builder, engine="generation",
                         batch_size=2, role="decode",
                         generation=dict({"slots": 2, "max_seq": 32,
                                          "stats_every": 0},
                                         **(decode_gen or {})))
        regs.append(reg)
    return regs


@pytest.mark.parametrize("case,ff132", [
    (dict(with_decode=False), 1),
    (dict(decode_gen={"num_pages": 1}), 1),
    (dict(prefill_gen={"page_size": 8}, decode_gen={"page_size": 16}), 1),
    ({}, 0)])
def test_ff132_topology_gate_equals_jax(case, ff132):
    reg, jreg = _role_registries(**case)
    report, rows = fleet_gate_report(reg, hbm_gb=16.0,
                                     xla_temp_factor=2.1)
    jreport, jrows = jax_fleet_gate_report(jreg, hbm_gb=16.0,
                                           xla_temp_factor=2.1)
    assert report.codes().count("FF132") == ff132
    assert report.codes() == jreport.codes()
    assert ([d.message for d in report.diagnostics]
            == [d.message for d in jreport.diagnostics])
    for r, j in zip(rows, jrows):
        assert r == j
    if not ff132:
        pf = next(r for r in rows if r["name"] == "pf")
        assert pf["staging_bytes"] > 0
        assert pf["ff108_bytes"] > pf["resident_bytes"]
