"""``GenerationEngine.from_strategy`` in the port: sharded generation at
``{"n": 2, "c": 2}`` on four gloo CPU ranks (``tests/_torch_a8b_worker.py``),
the cases of ``tests/test_generation.py``'s sharded engine, from-fresh
and sharded-speculation tests with their strategy file.  Rank 0 owns
the engine and broadcasts a plan a dispatch; the other ranks apply
them.  Greedy tokens equal the JAX package's ``reference_decode`` and
the port's one-device engine, with and without a replicated draft and
from a fresh model; ``kv_cache_bytes`` equals the JAX
``kv_cache_bytes`` for the mesh (half the one-device bytes: heads over
``c``, pages replicated) and is what each rank allocates; with a draft
no round falls back; every follower ran as many dispatches as rank 0
and refuses ``submit``.
"""

import os

import numpy as np
import pytest

import _torch_a8b_cases as cases
import _torch_mesh_cases as mesh_cases
import flexflow_tpu as ff
from flexflow_tpu.analysis import kv_cache_bytes as jax_kv_cache_bytes
from flexflow_tpu.parallel.mesh import MachineMesh as JaxMesh
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import interop


def reference_decode(model, prompt, max_new):
    """tests/test_generation.py's replicated decode: the full forward
    over the padded prompt at every step, argmax at the last position."""
    toks = [int(t) for t in prompt]
    for _ in range(max_new):
        padded = np.zeros((1, cases.SEQ), np.int32)
        padded[0, :len(toks)] = toks
        probs = model.predict([padded], batch_size=2)
        toks.append(int(np.argmax(probs[0, len(toks) - 1])))
    return toks[len(prompt):]


def _one_device_tokens(model, prompts, max_new, **kw):
    eng = ft.GenerationEngine(model, slots=cases.SLOTS, **kw)
    with eng:
        streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        return [[int(t) for t in s.result(timeout=120)] for s in streams]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("gen_mesh"))
    jm = cases.build_lm(ff)
    jm.compile(ff.SGDOptimizer(lr=0.01), mesh=JaxMesh({"n": 1}))
    jm.init_layers(seed=0)
    weights = {p.name: np.asarray(jm.get_weights(p.name))
               for p in jm.parameters}
    np.savez(os.path.join(wd, "init.npz"),
             **{f"lm|{k}": v for k, v in weights.items()})
    cases.write_tp_strategy(ft, os.path.join(wd, "gen_tp.pb"))
    prompts = cases.prompts()
    refs = [reference_decode(jm, p, 6) for p in prompts[:4]]
    # the port's one-device engine: the JAX weights, and a fresh seed-0
    # model (the port's own initialisation)
    pm = cases.build_lm(ft, device="cpu")
    pm.compile()
    pm.init_layers(seed=0)
    interop.params_from_jax_numpy(pm, weights)
    one = _one_device_tokens(pm, prompts[:4], 6)
    fresh = cases.build_lm(ft, device="cpu")
    fresh.compile()
    fresh.init_layers(seed=0)
    one_fresh = _one_device_tokens(fresh, prompts[:1], 4)
    rep = jax_kv_cache_bytes(jm.layers, {"n": 1}, cases.SLOTS, cases.SEQ,
                             kv_dtype_bytes=4)
    shd = jax_kv_cache_bytes(jm.layers, dict(cases.GEN_MESH), cases.SLOTS,
                             cases.SEQ, kv_dtype_bytes=4)
    ranks = mesh_cases.spawn("gen", wd, script="_torch_a8b_worker.py")
    return {"refs": refs, "one": one, "one_fresh": one_fresh,
            "kv": (rep, shd), "ranks": [r["json"] for r in ranks]}


def test_sharded_engine_matches_the_reference(runs):
    """Acceptance pin, sharded half: tokens == JAX reference_decode ==
    the port's one-device engine, on the strategy's {n: 2, c: 2} mesh
    (a compiled model's live parameters re-placed)."""
    r0 = runs["ranks"][0]
    assert r0["mesh"] == cases.GEN_MESH
    assert r0["tp"]["outs"] == runs["refs"] == runs["one"]


def test_sharded_kv_cache_bytes_match_jax(runs):
    """Heads over c halve the pools once (pages replicated over n), as
    the JAX accounting says, and each rank allocates exactly that."""
    rep, shd = runs["kv"]
    assert shd == rep / 2
    for rec in runs["ranks"]:
        assert rec["kv_cache_bytes"] == shd
        assert rec["pool_bytes"] == shd
        # 2 heads of 16 over c = 2: each rank holds one head's rows
        assert rec["local_wq"] == [16, 32]


def test_from_strategy_on_a_fresh_model(runs):
    """An uncompiled model is compiled under the strategy's inferred
    mesh and initialised there: tokens equal the one-device engine on a
    model initialised from the same seed."""
    r0 = runs["ranks"][0]
    assert r0["fresh_mesh"] == cases.GEN_MESH
    assert r0["fresh"]["outs"] == runs["one_fresh"]


def test_sharded_speculation_matches_the_reference(runs):
    """A replicated, co-hosted draft (the same weights) on the sharded
    target: the tokens are the reference's, the draft ran and no round
    fell back."""
    spec = runs["ranks"][0]["spec"]
    assert spec["outs"] == runs["refs"][:3]
    assert spec["draft_dispatches"] > 0
    assert spec["spec_fallbacks"] == 0


@pytest.mark.parametrize("run", ["tp", "spec", "fresh"])
def test_followers_apply_every_plan(runs, run):
    """Every follower ran as many dispatches as rank 0 and decided
    nothing: its streams are empty."""
    counts = [rec[run]["dispatches"] for rec in runs["ranks"]]
    assert counts[0] > 0 and len(set(counts)) == 1
    assert all(rec[run]["outs"] == [] for rec in runs["ranks"][1:])


def test_only_rank_0_accepts_submit(runs):
    for rec in runs["ranks"][1:]:
        assert rec["follower_submit"].startswith("RuntimeError")
        assert "rank 0" in rec["follower_submit"]
    assert "follower_submit" not in runs["ranks"][0]
    assert runs["ranks"][0]["tp"]["plan_bytes"] > 0
