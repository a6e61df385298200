"""The strategy simulator's event half in the port
(``search/simulator.py``, ``search/session.py``, ``native/``) against the
JAX package's, on the CPU.

On seeded random strategies over the candidate meshes of 4 and 8 devices
(precision tokens included), for the small BERT, DLRM, AlexNet, ResNet-50,
InceptionV3 and NMT graphs: every op's plan (``_op_plan``: dims, forward,
backward and sync times) and ``simulate_py`` equal the JAX package's
bit for bit under the reference spec, overlap on and off; the native
engine's ``simulate`` equals ``simulate_py``; ``peak_memory_bytes`` and
``op_time_shares`` equal; a ``SimSession`` walked through a seeded
sequence of one-op proposals returns at every step what a full
simulation returns (native and Python backends), and a strategy over the
memory limit scores inf in both packages.  The native library builds
into ``build/flexflow_tpu_torch/`` under a digest of its source.
"""

import os

import numpy as np
import pytest

import _torch_search_cases as cases
import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.search import cost_model as jax_cost
from flexflow_tpu.search.mcmc import candidate_meshes, legal_configs
from flexflow_tpu.search.simulator import Simulator as JaxSim
from flexflow_tpu_torch import native
from flexflow_tpu_torch.search.simulator import Simulator as PortSim

GRAPHS = ["transformer", "dlrm", "alexnet", "resnet", "inception", "nmt"]


def sims(ndev, **kw):
    j = JaxSim(spec=jax_cost.DEFAULT_SPEC, num_devices=ndev,
               use_native=False, flash_attention=False,
               compute_dtype="float32", dtype_bytes=4, **kw)
    p = PortSim(spec=cases.REF, num_devices=ndev, use_native=False,
                flash_attention=False, compute_dtype="float32",
                dtype_bytes=4, device="cpu", **kw)
    return j, p


def port_strategy(strategies):
    return {k: cases.port_pc(v) for k, v in strategies.items()}


@pytest.mark.parametrize("ndev", [4, 8])
@pytest.mark.parametrize("name", GRAPHS)
def test_simulate_equals_the_jax_package(name, ndev):
    jm, pm = cases.pair(name)
    native_sim = PortSim(spec=cases.REF, num_devices=ndev,
                         flash_attention=False, compute_dtype="float32",
                         dtype_bytes=4, device="cpu",
                         devices_per_slice=ndev // 2)
    assert native_sim.backend == "native"
    for seed in range(4):
        js, mesh = cases.random_strategies(jm.layers, ndev, seed,
                                           precision=seed % 2 == 1)
        ps = port_strategy(js)
        for dps in (0, ndev // 2):
            j, p = sims(ndev, devices_per_slice=dps)
            for jop, pop in zip(jm.layers, pm.layers):
                jp, pp = j._op_plan(jop, js), p._op_plan(pop, ps)
                assert tuple(pp[1]) == tuple(jp[1])
                assert pp[2:] == jp[2:], (name, jop.name, pp, jp)
            for overlap in (False, True):
                want = j.simulate_py(jm.layers, js, overlap)
                assert p.simulate_py(pm.layers, ps, overlap) == want
                if dps:
                    assert native_sim.simulate(pm.layers, ps, overlap,
                                               mesh_shape=mesh) == want
            assert p.peak_memory_bytes(pm.layers, ps, mesh) == \
                j.peak_memory_bytes(jm.layers, js, mesh)
            assert p.op_time_shares(pm.layers, ps) == \
                j.op_time_shares(jm.layers, js)


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("name", ["transformer", "inception"])
def test_session_deltas_equal_full_simulations(name, backend):
    """A session evaluating one-op proposals (and mesh changes) returns
    at every step the one-shot ``simulate``'s value and peak memory."""
    _, pm = cases.pair(name)
    layers = pm.layers
    sim = PortSim(spec=cases.REF, num_devices=8, flash_attention=False,
                  compute_dtype="float32", dtype_bytes=4, device="cpu")
    oneshot = PortSim(spec=cases.REF, num_devices=8, use_native=False,
                      flash_attention=False, compute_dtype="float32",
                      dtype_bytes=4, device="cpu")
    rng = np.random.default_rng(7)
    from flexflow_tpu_torch.search.mcmc import (
        candidate_meshes as port_meshes, legal_configs as port_legal)
    meshes = port_meshes(8)
    mesh = meshes[3]
    cur = {op.name: port_legal(op, mesh)[0] for op in layers}
    for overlap in (False, True):
        with sim.session(layers, overlap, mesh_shape=mesh,
                         backend=backend) as sess:
            assert sess.backend == backend
            for step in range(40):
                if step % 10 == 9:
                    mesh = meshes[int(rng.integers(len(meshes)))]
                    cur = {op.name: port_legal(op, mesh)[0]
                           for op in layers}
                op = layers[int(rng.integers(len(layers)))]
                cands = port_legal(op, mesh)
                cur = dict(cur)
                cur[op.name] = cands[int(rng.integers(len(cands)))]
                got = sess.evaluate(cur, mesh_shape=mesh)
                want = oneshot.simulate_py(layers, cur, overlap)
                assert got == want, (step, got, want)
                assert sess.peak_memory_bytes() == \
                    oneshot.peak_memory_bytes(layers, cur, mesh,
                                              assume_remat=False)
            st = sess.stats()
            assert st["evaluations"] == 40 and st["tasks"] > 0


def test_memory_limit_scores_inf_in_both_packages():
    jm, pm = cases.pair("transformer")
    tiny_j = jax_cost.DeviceSpec(hbm_capacity=1e4)
    tiny_p = cases.reference_spec(tiny_j)
    js = {op.name: legal_configs(op, {"n": 4})[0] for op in jm.layers}
    j = JaxSim(spec=tiny_j, num_devices=4, use_native=False)
    p = PortSim(spec=tiny_p, num_devices=4, device="cpu")
    assert j.simulate(jm.layers, js) == float("inf")
    assert p.simulate(pm.layers, port_strategy(js)) == float("inf")
    with p.session(pm.layers) as sess:
        assert sess.evaluate(port_strategy(js)) == float("inf")


def test_native_library_is_built_under_its_source_digest():
    lib = native.load_ffsim()
    assert lib is not None and lib.ffsim_version() >= 2
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path).endswith(
        os.path.join("build", "flexflow_tpu_torch"))
    with open(native.SRC, "rb") as f:
        assert b"flexflow_tpu_torch" in f.read(400)


def test_estimator_hook_takes_only_none():
    with pytest.raises(NotImplementedError, match=r"A\.9b"):
        PortSim(estimator=object(), device="cpu")
    assert PortSim(device="cpu").estimator is None


def test_the_python_engine_runs_without_the_native_library():
    _, pm = cases.pair("dlrm")
    strategies = {op.name: ft.ParallelConfig.data_parallel(
        4, op.outputs[0].num_dims) for op in pm.layers}
    py = PortSim(num_devices=4, use_native=False, device="cpu")
    assert py.backend == "python"
    nat = PortSim(num_devices=4, device="cpu")
    assert nat.simulate(pm.layers, strategies) == \
        py.simulate(pm.layers, strategies)
    with py.session(pm.layers) as sess:
        assert sess.backend == "python"
        assert sess.evaluate(strategies) == \
            py.simulate(pm.layers, strategies)
    with pytest.raises(RuntimeError, match="native backend"):
        py.session(pm.layers, backend="native")


def test_meshes_and_legal_configs_equal_the_jax_package():
    from flexflow_tpu_torch.search import mcmc as port_mcmc
    for ndev in (1, 4, 6, 8):
        assert port_mcmc.candidate_meshes(ndev) == candidate_meshes(ndev)
    jm, pm = cases.pair("inception")
    for mesh in candidate_meshes(8)[::5]:
        for jop, pop in zip(jm.layers, pm.layers):
            got = [(tuple(c.dims), tuple(c.device_ids))
                   for c in port_mcmc.legal_configs(pop, mesh,
                                                    max_candidates=6)]
            want = [(tuple(c.dims), tuple(c.device_ids))
                    for c in legal_configs(jop, mesh, max_candidates=6)]
            assert got == want, (jop.name, mesh)
    assert ff is not None
