"""``FFModel.reshard`` in the port: an in-process change of mesh
factorization on four gloo CPU ranks (``tests/_torch_a8b_worker.py``),
``tests/test_reshard.py``'s pins.  From ``{"n": 2, "c": 2}`` to ``{"n":
4}``, ``{"c": 4}`` and ``{"n": 2, "p": 2}``: the losses after the
reshard are bit-equal to a run fixed on the target mesh that loads the
step-2 checkpoint, and within rtol 1e-4, atol 1e-5 (the mesh tests'
tolerance) of the JAX package's reshard on the same meshes (the
suite's virtual devices).  The optimizer state (momentum) moves
value-lossless; ``verify="error"`` rolls back and the model trains on;
another device count names ``run_elastic``; a re-search pinned to the
target mesh reshards onto the searched strategies and trains on.  A
4-rank checkpoint resumes on 2 ranks with the JAX event's fields
(``reshard_on_resume``).
"""

import json
import os

import jax
import numpy as np
import pytest

import _torch_a8b_cases as cases
import _torch_mesh_cases as mesh_cases
import flexflow_tpu as ff
from flexflow_tpu.parallel.mesh import MachineMesh as JaxMesh
import flexflow_tpu_torch as ft

RTOL, ATOL = 1e-4, 1e-5


def jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return JaxMesh(shape, devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's reshards and the ranks' results (the 4-rank
    suite, then the 2-rank resume of its checkpoint)."""
    wd = str(tmp_path_factory.mktemp("reshard"))
    jm = cases.mlp(ff, mesh=jax_mesh(cases.SOURCE))
    init = {f"mlp|{k}": v for k, v in cases.weights(jm).items()}
    np.savez(os.path.join(wd, "init.npz"), **init)
    jruns = {}
    for tag, target in cases.TARGETS.items():
        m = cases.mlp(ff, mesh=jax_mesh(cases.SOURCE))
        pre = cases.train(m, cases.PRE)
        m.reshard(new_mesh=jax_mesh(target))
        jruns[tag] = (pre, cases.train(m, cases.POST), cases.weights(m))
    ranks = mesh_cases.spawn("reshard", wd, script="_torch_a8b_worker.py")
    resume = mesh_cases.spawn("resume2", wd, world=2,
                              script="_torch_a8b_worker.py")
    # the JAX package's reshard_on_resume for the same move (4 -> 2)
    a = cases.mlp(ff, mesh=jax_mesh({"n": 4}), degrees={})
    cases.train(a, 2)
    a.save_checkpoint(os.path.join(wd, "jax_n4.npz"))
    b = cases.mlp(ff, mesh=jax_mesh({"n": 2}), degrees={})
    with ff.fflogger.capture_events("elastic") as jev:
        b.load_checkpoint(os.path.join(wd, "jax_n4.npz"))
    return {"jax": jruns, "ranks": ranks, "resume": resume, "wd": wd,
            "jax_resume": jev}


@pytest.mark.parametrize("tag", sorted(cases.TARGETS))
def test_reshard_is_bit_equal_to_the_fixed_mesh_run(runs, tag):
    for res in runs["ranks"]:
        np.testing.assert_array_equal(res[f"{tag}|post"], res[f"{tag}|ref"])
        assert res["json"][tag]["mesh"] == cases.TARGETS[tag]
        assert res["json"][tag]["events"] == ["reshard"]


@pytest.mark.parametrize("tag", sorted(cases.TARGETS))
def test_reshard_matches_the_jax_package(runs, tag):
    pre, post, weights = runs["jax"][tag]
    for res in runs["ranks"]:
        np.testing.assert_allclose(res[f"{tag}|pre"], pre, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(res[f"{tag}|post"], post, rtol=RTOL,
                                   atol=ATOL)
        for k, v in weights.items():
            np.testing.assert_allclose(res[f"{tag}|param|{k}"], v,
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def test_reshard_report_and_placements(runs):
    """The report carries the JAX keys; the c-split kernels hold the
    rows of the new c degree (64 -> 16 rows over {"c": 4}, the strategy's
    degree 2 of 4 on that axis giving 32 -> 16)."""
    for res in runs["ranks"]:
        rep = res["json"]["c4"]["report"]
        assert set(rep) == {"old_mesh", "new_mesh", "old_devices",
                            "new_devices", "researched", "step",
                            "strategy_digest"}
        assert rep["old_mesh"] == cases.SOURCE and rep["step"] == cases.PRE
        assert rep["researched"] is False
        assert res["json"]["c4"]["local"]["dense/kernel"] == [16, 8]
        assert res["json"]["n4"]["local"]["dense/kernel"] == [32, 8]


def test_reshard_keeps_the_optimizer_state(runs):
    """A save right after a reshard holds every array of a save right
    before it: parameters, the momentum slots and the step."""
    wd = runs["wd"]
    with np.load(os.path.join(wd, "before.npz")) as fa, \
            np.load(os.path.join(wd, "after.npz")) as fb:
        keys = [k for k in fa.files if k != "meta:manifest"]
        assert set(keys) == {k for k in fb.files if k != "meta:manifest"}
        assert any(k.startswith("opt:") for k in keys)
        for k in keys:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        man = json.loads(str(fb["meta:manifest"]))
        assert man["mesh_shape"] == {"n": 4} and man["num_devices"] == 4


def test_reshard_rollback_and_refusals(runs):
    for res in runs["ranks"]:
        b = res["json"]["behaviour"]
        assert b["verify"] == "VerificationError"
        assert b["kept_mesh"] == {"n": 4} and b["kept_config"]
        assert np.isfinite(b["loss_after_rollback"])
        for key in ("count", "mesh_count"):
            assert b[key].startswith("ValueError")
            assert "run_elastic" in b[key] and "num_devices" in b[key]
        assert b["research"]["researched"] is True
        assert b["research"]["new_mesh"] == {"n": 4}
        assert np.isfinite(b["research"]["loss"])
        assert b["args"] == ("ValueError: pass exactly one of new_mesh / "
                             "num_devices")


def test_reshard_on_resume_event_matches_jax(runs):
    """A 4-rank checkpoint resumed on 2 ranks: the event has the JAX
    event's fields and values for the same move, and training goes on."""
    jev = [e for e in runs["jax_resume"] if e["event"] ==
           "reshard_on_resume"]
    assert len(jev) == 1
    for res in runs["resume"]:
        rec = res["json"]
        # the suite's last save: 2 steps, the reshard, 1 step
        assert rec["path"] == "elastic_step3.npz" and rec["step"] == 3
        ev = [e for e in rec["events"] if e["event"] == "reshard_on_resume"]
        assert len(ev) == 1
        assert set(ev[0]) == set(jev[0]) - {"t", "t_ns"}
        for k in ("saved_mesh", "saved_devices", "mesh", "devices",
                  "research"):
            assert ev[0][k] == jev[0][k], k
        assert ev[0]["saved_digest"] != ev[0]["digest"]
        assert np.all(np.isfinite(res["loss"]))


def test_reshard_on_one_process():
    """Without a process group the world is one device: a reshard to
    one device moves nothing and trains on; anything larger names
    run_elastic; the argument checks are the JAX package's."""
    m = cases.mlp(ft, degrees={}, device="cpu")
    before = cases.weights(m)
    with ft.fflogger.capture_events("elastic") as ev:
        rep = m.reshard(num_devices=1)
    assert rep["old_devices"] == rep["new_devices"] == 1
    assert [e["event"] for e in ev] == ["reshard"]
    for k, v in cases.weights(m).items():
        np.testing.assert_array_equal(v, before[k])
    assert np.isfinite(cases.train(m, 1)[0])
    with pytest.raises(ValueError, match="exactly one"):
        m.reshard()
    with pytest.raises(ValueError, match="num_devices.*run_elastic"):
        m.reshard(num_devices=512)
    # a re-search (research=True, or a reshard budget above 0) searches
    # the one device's strategies and trains on
    assert m.reshard(num_devices=1, research=True)["researched"] is True
    m.config.reshard_search_budget = 5
    rep = m.reshard(num_devices=1)
    assert rep["researched"] is True and rep["new_devices"] == 1
    assert np.isfinite(cases.train(m, 1)[0])


def test_quantized_model_refuses_reshard():
    m = cases.mlp(ft, degrees={}, device="cpu")
    m.quantize_weights("int8")
    with pytest.raises(RuntimeError, match="reshard"):
        m.reshard(num_devices=1)
