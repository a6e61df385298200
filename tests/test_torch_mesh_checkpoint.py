"""Checkpoints across meshes and packages, and the one-rank group, on CPU
ranks (gloo, ``_torch_mesh_worker.py``): a run at n2 x c2 with Adam
saved by the port's ranks loads on one device, a one-device file loads
on the mesh, the JAX package's file from its n2 x c2 mesh loads on the
port's mesh and the port's mesh file loads in the JAX package, every
parameter bit-equal; ``interop.params_from_jax_numpy`` places full
arrays on a mesh model; and a one-rank mesh step is bit-equal to the
step without a mesh.

The mesh run itself is held to the JAX package's run on the same mesh
and to the port's one-device run at rtol 1e-4, atol 1e-5
(``tests/test_parallel.py``)."""

import json
import os

import numpy as np
import pytest

import _torch_mesh_cases as cases
import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.interop import params_from_jax_numpy
from flexflow_tpu_torch.resilience import verify_checkpoint
from test_torch_mesh import ATOL, RTOL, jax_mesh

CASE = cases.CASES["ckpt"]


def _one_device(w0):
    plain = dict(CASE, degrees={})
    m, logits = cases.build(ft, plain, device="cpu")
    cases.compile_model(ft, m, logits, plain)
    m.init_layers(seed=0)
    params_from_jax_numpy(m, w0)
    return m


def _jax_model():
    jm, logits = cases.build(ff, CASE)
    cases.compile_model(ff, jm, logits, CASE, mesh=jax_mesh(CASE["mesh"]))
    jm.init_layers(seed=0)
    return jm


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("mesh_ckpt"))
    jm = _jax_model()
    w0 = cases.weights(jm)
    np.savez(os.path.join(wd, "init.npz"),
             **{f"ckpt|{k}": v for k, v in w0.items()},
             **{f"mlp_n2c2|{k}": v for k, v in w0.items()})
    jloss = cases.train(jm, CASE)
    jm.save_checkpoint(os.path.join(wd, "jax_mesh.npz"))
    one = _one_device(w0)
    oloss = cases.train(one, CASE)
    one.save_checkpoint(os.path.join(wd, "port_one.npz"))
    ranks = cases.spawn("checkpoint", wd)
    return {"wd": wd, "w0": w0, "jax": (jloss, cases.weights(jm)),
            "one": (oloss, cases.weights(one), one), "ranks": ranks,
            "one_rank": cases.spawn("one_rank", wd, world=1)[0]}


def test_mesh_adam_run_matches_jax_and_one_device(runs):
    jl, jw = runs["jax"]
    ol, ow, _ = runs["one"]
    for res in runs["ranks"]:
        np.testing.assert_allclose(res["ckpt|loss"], jl, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res["ckpt|loss"], ol, rtol=RTOL, atol=ATOL)
        for k in jw:
            got = res[f"ckpt|param|{k}"]
            np.testing.assert_allclose(got, jw[k], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got, ow[k], rtol=RTOL, atol=ATOL)


def test_collectives_run_through_the_counted_kernels(runs):
    """The ranks ran DTensor's collectives through the runtime's own
    kernels (as under gloo on CUDA tensors), counted, on the device
    tensors, and the run above still equals the JAX package's."""
    for res in runs["ranks"]:
        counted = res["json"]["collectives"]
        assert counted["all_reduce"]["calls"] > 0
        assert counted["all_reduce"]["bytes"] > 0
        assert not any(c["host"] for c in counted.values())


def test_mesh_checkpoint_records_its_mesh_and_verifies(runs):
    path = os.path.join(runs["wd"], "port_mesh.npz")
    verify_checkpoint(path)
    with np.load(path) as z:
        manifest = json.loads(str(z["meta:manifest"]))
    text = json.dumps(manifest)
    assert '"n": 2' in text and '"c": 2' in text


def test_mesh_checkpoint_loads_on_one_device(runs):
    """Saved by the ranks at n2 x c2, loaded on one device: bit-equal."""
    m = _one_device(runs["w0"])
    m.load_checkpoint(os.path.join(runs["wd"], "port_mesh.npz"))
    mesh_w = runs["ranks"][0]
    for k, v in cases.weights(m).items():
        np.testing.assert_array_equal(v, mesh_w[f"ckpt|param|{k}"])


def test_one_device_checkpoint_loads_on_the_mesh(runs):
    """Saved on one device, loaded on n2 x c2: bit-equal, and the next
    step equals the one-device run's next step."""
    _, ow, one = runs["one"]
    nxt = cases.train(one, dict(CASE, steps=1), seed=1)
    for res in runs["ranks"]:
        for k, v in ow.items():
            np.testing.assert_array_equal(res[f"load|port_one|{k}"], v)
        np.testing.assert_allclose(res["load|port_one|loss"], nxt,
                                   rtol=RTOL, atol=ATOL)


def test_jax_mesh_checkpoint_loads_on_the_port_mesh(runs):
    _, jw = runs["jax"]
    for res in runs["ranks"]:
        for k, v in jw.items():
            np.testing.assert_array_equal(res[f"load|jax_mesh|{k}"], v)


def test_port_mesh_checkpoint_loads_in_the_jax_package(runs):
    jm = _jax_model()
    jm.load_checkpoint(os.path.join(runs["wd"], "port_mesh.npz"))
    mesh_w = runs["ranks"][0]
    for k, v in cases.weights(jm).items():
        np.testing.assert_array_equal(v, mesh_w[f"ckpt|param|{k}"])


def test_params_from_jax_numpy_places_shards_on_a_mesh(runs):
    """Full arrays in, each rank keeps its shard: the c-split kernels
    hold half their rows, and the gathered values are the arrays."""
    for res in runs["ranks"]:
        local = res["json"]["interop_local"]
        assert local["dense/kernel"] == [32, 16]
        assert local["dense_1/kernel"] == [4, 64]
        for k, v in runs["w0"].items():
            np.testing.assert_array_equal(res[f"interop|{k}"], v)


def test_one_rank_mesh_step_is_bit_equal_to_no_mesh(runs):
    res = runs["one_rank"]
    assert res["json"] == {"mesh": True, "plain": False}
    np.testing.assert_array_equal(res["mesh|loss"], res["plain|loss"])
    for k in runs["w0"]:
        np.testing.assert_array_equal(res[f"mesh|param|{k}"],
                                      res[f"plain|param|{k}"])
