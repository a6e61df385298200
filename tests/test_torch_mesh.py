"""The port on a mesh of four CPU ranks (gloo, ``_torch_mesh_worker.py``)
against the JAX package on the same mesh (its virtual CPU devices) and
against the port's own one-device run: MLPs at dp4, n2 x c2 and a
mixed degree, the multichip dryrun's CNN at n2 x c2 and with h split,
the training-loop knobs, the shard layouts, the FF106 record, A.8b's
items that compile (1-3), the in-process reshard (4) and
``from_strategy`` (5) in a one-process world.

The ranks are spawned once for the module; each case reads their
results.  Tolerances are the JAX package's parallel tests'
(``tests/test_parallel.py``): rtol 1e-4, atol 1e-5 on losses and
parameters, float32 throughout."""

import os

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec

import _torch_mesh_cases as cases
import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.parallel.mesh import MachineMesh as JaxMesh
from flexflow_tpu_torch.interop import params_from_jax_numpy

RTOL, ATOL = 1e-4, 1e-5
TRAINED = ("mlp_dp4", "mlp_n2c2", "mlp_mixed", "mlp_fallback", "cnn_n2c2",
           "cnn_hw")


def jax_mesh(shape):
    return JaxMesh(shape, devices=jax.devices()[:int(np.prod(
        list(shape.values())))])


def reference_runs(names, workdir):
    """The JAX package's run of each case on its mesh and the port's
    one-device run from the same initial parameters, which go to
    ``workdir/init.npz`` for the ranks."""
    init, jruns, one = {}, {}, {}
    for name in names:
        case = cases.CASES[name]
        jm, logits = cases.build(ff, case)
        cases.compile_model(ff, jm, logits, case, mesh=jax_mesh(case["mesh"]))
        jm.init_layers(seed=0)
        w0 = cases.weights(jm)
        init.update({f"{name}|{k}": v for k, v in w0.items()})
        jruns[name] = (cases.train(jm, case), cases.weights(jm),
                       set(jm.runtime_fallback_sites))
        plain = dict(case, degrees={})
        pm, plogits = cases.build(ft, plain, device="cpu")
        cases.compile_model(ft, pm, plogits, plain)
        pm.init_layers(seed=0)
        params_from_jax_numpy(pm, w0)
        one[name] = (cases.train(pm, plain), cases.weights(pm))
    np.savez(os.path.join(workdir, "init.npz"), **init)
    return jruns, one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("mesh_cnn"))
    jruns, one = reference_runs(TRAINED, wd)
    return {"jax": jruns, "one": one, "ranks": cases.spawn("cnn", wd)}


@pytest.mark.parametrize("name", TRAINED)
def test_mesh_training_matches_jax_and_one_device(runs, name):
    """Every rank's losses and gathered parameters equal the JAX
    package's on the same mesh and the port's one-device run."""
    jl, jw, _ = runs["jax"][name]
    ol, ow = runs["one"][name]
    for res in runs["ranks"]:
        loss = res[f"{name}|loss"]
        np.testing.assert_allclose(loss, jl, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(loss, ol, rtol=RTOL, atol=ATOL)
        for k in jw:
            got = res[f"{name}|param|{k}"]
            np.testing.assert_allclose(got, jw[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
            np.testing.assert_allclose(got, ow[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("name,route", [("cnn_n2c2", "kernel_per_shard"),
                                        ("cnn_hw", "spatial_gathered")])
def test_max_pool_route_on_the_mesh(runs, name, route):
    """The max pool runs the kernels' route on each rank's batch shard
    when its strategy leaves h and w whole (the plain version stands in
    for the kernel on the CPU), and the reduce_window equivalent with
    -inf padding when it splits them, as the JAX package routes."""
    for res in runs["ranks"]:
        routes = res["json"][name]["routes"]
        assert routes[route] == 1
        assert sum(routes.values()) == 1


def test_shard_shapes(runs):
    """A c-split kernel keeps its rows' shard (64x16 over {"c": 4} ->
    16x16, as test_param_sharding_placement), and the dryrun CNN's
    dense kernels hold half their output rows at n2 x c2."""
    for res in runs["ranks"]:
        assert res["json"]["c4_kernel_local"] == [16, 16]
        local = res["json"]["cnn_n2c2"]["local"]
        assert local["dense/kernel"] == [16, 512]
        assert local["dense_1/kernel"] == [4, 32]
        assert local["conv2d/kernel"] == [8, 3, 3, 3]


def test_dim_over_two_sub_axes_is_split_major_to_minor(runs):
    """A dim over "n" of an {"n": 4} mesh is split over n0 then n1, the
    block order of jax's PartitionSpec(("n0", "n1")): the rank at each
    mesh coordinate holds the rows the JAX device there holds."""
    jm = jax_mesh({"n": 4})
    full = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    arr = jax.device_put(full, jm.sharding(PartitionSpec("n", None)))
    devices = jm.mesh.devices
    by_coord = {}
    for shard in arr.addressable_shards:
        coord = tuple(int(c) for c in np.argwhere(devices == shard.device)[0])
        by_coord[coord] = np.asarray(shard.data)
    for res in runs["ranks"]:
        coord = tuple(res["json"]["n4_coordinate"])
        np.testing.assert_array_equal(res["n4_block"], by_coord[coord])


def test_default_mesh_is_data_parallel_over_every_rank(runs):
    for res in runs["ranks"]:
        assert res["json"]["default_shape"] == {"n": 4}


def test_machine_mesh_refuses_what_it_cannot_build():
    """Without a process group this process is one device; an unknown
    axis is named, as in the JAX package."""
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        ft.MachineMesh({"n": 2}, device="cpu")
    with pytest.raises(ValueError, match="unknown mesh axis 'q'"):
        ft.MachineMesh({"q": 2}, device="cpu")
    one = ft.MachineMesh(device="cpu")
    assert one.device_mesh is None and not one.is_distributed


def test_ranks_sharing_a_card_refuse_nccl(monkeypatch):
    """Two ranks on one GPU under NCCL raise before any group comes up;
    the backend is never switched quietly."""
    import torch

    from flexflow_tpu_torch.parallel import distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks"):
        distributed.initialize_distributed(
            init_method="file:///nonexistent", world_size=2, rank=0)
    assert distributed.default_backend("cuda") == "nccl"
    assert distributed.default_backend("cpu") == "gloo"
    assert not distributed.initialize_distributed()   # no group asked for


def test_replicate_fallbacks_drained_after_a_step(runs):
    """A degree no axis realizes replicates; the site is drained into
    ``runtime_fallback_sites`` after the step (FF106), the JAX
    package's sites."""
    want = runs["jax"]["mlp_fallback"][2]
    assert want
    for res in runs["ranks"]:
        got = {tuple(s) for s in res["json"]["mlp_fallback"]["fallbacks"]}
        assert got == want


@pytest.mark.parametrize("knob", sorted(cases.KNOBS))
def test_training_loop_knobs_on_the_mesh(runs, knob):
    """Gradient accumulation, multi-step windows, the padded tail and
    rematerialisation run under the mesh: fit's losses, evaluate, the
    full predict on every rank and the parameters equal the port's
    one-device run."""
    one = cases.knob_run(ft, knob)
    for res in runs["ranks"]:
        for k, v in one.items():
            np.testing.assert_allclose(res[f"knob|{knob}|{k}"], v,
                                       rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("what", ["p", "e", "host"])
def test_a8b_items_1_3_compile_on_the_mesh(runs, what):
    """The p and e axes and host-placed tables on a mesh compile since
    A.8b's items 1-3 were ported (``tests/test_torch_mesh_pipeline.py``
    holds them against the JAX package)."""
    for res in runs["ranks"]:
        msg = res["json"]["refusals"][what]
        assert msg == "no error", msg


@pytest.mark.parametrize("what", ["reshard"])
def test_a8b_items_refuse_on_the_mesh(runs, what):
    """``reshard`` (A.8b's item 4) moves the model onto another
    factorization of the same four ranks in process, and refuses only
    another device count, naming the supervisor that takes it
    (``tests/test_torch_reshard.py`` holds it against the JAX
    package)."""
    for res in runs["ranks"]:
        refusals = res["json"]["refusals"]
        assert refusals[what] == "no error", refusals[what]
        msg = refusals[what + "_count"]
        assert msg.startswith("ValueError") and "run_elastic" in msg


def test_sharded_generation_engine_refuses(tmp_path):
    """``from_strategy`` (A.8b's item 5) is ported: in a one-process
    world a one-device strategy compiles a fresh model, initialises it
    and serves the tokens of the plain engine
    (``tests/test_torch_generation_mesh.py`` holds the sharded engine
    against the JAX package); a strategy that needs more devices than
    the world has is refused as compile refuses it."""
    from flexflow_tpu_torch.models import build_transformer_lm
    from flexflow_tpu_torch.strategy.proto import save_strategy_file
    kw = dict(num_layers=1, d_model=16, num_heads=2, d_ff=32, seq_len=16,
              vocab_size=31, device="cpu")
    pb = str(tmp_path / "one.pb")
    save_strategy_file(pb, {"attention_0": ft.ParallelConfig(
        dims=(1, 1, 1), device_ids=(0,))})
    prompt = np.arange(1, 6, dtype=np.int32)
    fresh = build_transformer_lm(ft.FFConfig(batch_size=2, compute_dtype=
                                             "float32"), **kw)[0]
    with ft.GenerationEngine.from_strategy(fresh, pb, slots=2) as eng:
        got = [int(t) for t in eng.submit(prompt, max_new_tokens=4)
               .result(timeout=60)]
    plain = build_transformer_lm(ft.FFConfig(batch_size=2, compute_dtype=
                                             "float32"), **kw)[0]
    plain.compile()
    plain.init_layers(seed=plain.config.seed)
    with ft.GenerationEngine(plain, slots=2) as eng:
        want = [int(t) for t in eng.submit(prompt, max_new_tokens=4)
                .result(timeout=60)]
    assert got == want
    save_strategy_file(pb, {"attention_0": ft.ParallelConfig(
        dims=(2, 1, 2), device_ids=(0, 1, 2, 3))})
    other = build_transformer_lm(ft.FFConfig(batch_size=2, compute_dtype=
                                             "float32"), **kw)[0]
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        ft.GenerationEngine.from_strategy(other, pb, slots=2)
