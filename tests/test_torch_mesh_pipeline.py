"""The port's pipeline stages (``p``), experts (``e``) and host placement
on meshes of CPU ranks (gloo, ``_torch_mesh_worker.py``) against the JAX
package on the same mesh (its virtual CPU devices): the pipeline block
at {"p": 2}, {"p": 4} and {"n": 2, "p": 2} under GPipe (M = 8 > S
included, and 2 stages a rank) and interleaved (v = 2), segments with
dense and MoE stages, MoE at {"e": 4} and {"n": 2, "e": 2} with a
capacity that binds, DLRM with host-placed tables at {"n": 2} and
{"n": 4}, a host-placed Linear at {"n": 4}, and on 8 ranks the multichip
dryrun's composed {n, e, p} program and a segment whose 8-expert MoE
stage (k 1) drops tokens, its capacity binding; then ``pipeline_apply``
alone, whose gradients would be S times too large if the last stage's
output collective summed its cotangent over the line; and the training-loop
knobs and checkpoints on the pipeline mesh against the port's
one-device run.

Each suite of ranks is spawned once for the module, beside the JAX
runs.  Tolerances are the JAX package's parallel tests'
(``tests/test_parallel.py``): rtol 1e-4, atol 1e-5 on outputs, losses
and parameters, float32 throughout.  The host-placed Linear's reference
is the JAX package's device-placed run: its step cannot multiply a
host-placed kernel in this jaxlib (``dot_general`` refuses operands in
two memory spaces), and host placement changes no value.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_cases as cases
import flexflow_tpu as ff
from flexflow_tpu.parallel.pipeline import pipeline_apply
from test_torch_mesh import ATOL, RTOL, jax_mesh


def jax_model(name):
    case = cases.PIPE_CASES[name]
    return cases.build_pipe(ff, case, host=case["graph"] != "mlp_host",
                            mesh=jax_mesh(case["mesh"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every suite's ranks, started as soon as the JAX models' initial
    weights are written, and the JAX runs beside them."""
    jax_models, ranks, threads, errors = {}, {}, [], []
    workdirs = {}
    for suite, (world, names) in cases.PIPE_SUITES.items():
        wd = workdirs[suite] = str(tmp_path_factory.mktemp(
            f"mesh_{suite}"))
        init = {}
        for name in names:
            jax_models[name] = jax_model(name)
            init.update({f"{name}|{k}": v for k, v in
                         cases.weights(jax_models[name]).items()})
        np.savez(os.path.join(wd, "init.npz"), **init)

        def spawn(suite=suite, world=world, wd=wd):
            try:
                ranks[suite] = cases.spawn(suite, wd, world=world)
            except BaseException as e:   # re-raised in the test process
                errors.append(e)
        threads.append(threading.Thread(target=spawn))
        threads[-1].start()
    ref = {name: cases.pipe_run(m, cases.PIPE_CASES[name])
           for name, m in jax_models.items()}
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    by_case = {name: ranks[suite] for suite, (_, names)
               in cases.PIPE_SUITES.items() for name in names}
    return {"jax": ref, "ranks": by_case, "trap": ranks["pipe4"],
            "workdir": workdirs["pipe4"]}


@pytest.mark.parametrize("name", list(cases.PIPE_CASES))
def test_mesh_run_matches_jax_on_the_same_mesh(runs, name):
    """Every rank's predict, per-step losses and gathered parameters
    equal the JAX package's on the same mesh."""
    want = runs["jax"][name]
    for res in runs["ranks"][name]:
        for k, v in want.items():
            np.testing.assert_allclose(res[f"{name}|{k}"], v, rtol=RTOL,
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name,param,shape", [
    ("pipe_p4", "pipeline_block/wq", [1, 32, 32]),
    ("pipe_p4", "pipeline_block/ffn_up", [1, 64, 32]),
    ("pipe_p2", "pipeline_block/wq", [2, 32, 32]),
    ("pipe_n2p2", "pipeline_block/ln1_scale", [2, 32]),
    ("seg_moe_e2p2", "pipeline/moe/w_up", [1, 1, 32, 16]),
    ("seg_moe_e2p2", "pipeline/moe/gate", [1, 2, 16]),
    ("seg_moe_e2p2", "pipeline/dense/kernel", [1, 32, 16]),
    ("composed", "pipeline/moe/w_down", [1, 1, 16, 32]),
    ("seg_moe8_n2e2p2", "pipeline/moe/w_up", [1, 4, 32, 16]),
    ("moe_e4", "moe0/w_up", [1, 64, 32]),
    ("moe_n2e2", "moe0/w_down", [2, 32, 64]),
    ("moe_n2e2", "moe0/gate", [4, 32]),
])
def test_stacked_weights_local_shapes(runs, name, param, shape):
    """Each rank holds its stages (and, inside them, its experts) only:
    the memory split the p and e axes exist for."""
    for res in runs["ranks"][name]:
        assert res["json"][name]["local"][param] == shape


@pytest.mark.parametrize("name", ["dlrm_n2", "dlrm_n4", "mlp_host_n4"])
def test_host_placed_parameters_stay_host_tensors_on_the_mesh(runs, name):
    """A host-placed parameter is a plain tensor in host memory on every
    rank (a DTensor would live on the mesh's device type), after the
    steps."""
    want = 4 if name.startswith("dlrm") else 2
    for res in runs["ranks"][name]:
        homes = res["json"][name]["host"]
        assert len(homes) == want
        assert all(h == ["cpu", "Tensor"] for h in homes.values()), homes


def _jax_trap(sched):
    stages, v = (4, None) if sched == "gpipe" else (8, 2)
    w, b, x = cases.trap_data(stages)
    mesh = jax_mesh({"p": 4})

    def loss(params, x):
        y, _ = pipeline_apply(lambda p, h: cases.trap_stage(jnp, p, h),
                              params, x, mesh, 4, schedule=sched,
                              virtual_stages=v)
        return jnp.sum(y ** 2), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    return np.asarray(y), grads


@pytest.mark.parametrize("sched", ["gpipe", "interleaved"])
def test_last_stage_hands_its_cotangent_on_once(runs, sched):
    """``pipeline_apply`` at {"p": 4}: each rank's output equals the JAX
    pipeline's, its stage block's gradients are the JAX gradients'
    block, and the input's gradient is the sum of the ranks' shares.
    The control: these gradients are large enough that S times them
    (the output collective's cotangent summed over the 4 ranks) fails
    the same comparison."""
    y, grads = _jax_trap(sched)
    ranks = runs["trap"]
    order = sorted(range(4), key=lambda r: ranks[r]["json"]["trap_line"][1])
    for res in ranks:
        np.testing.assert_allclose(res[f"trap|{sched}|y"], y, rtol=RTOL,
                                   atol=ATOL)
    for key, want in (("dw", grads[0]["w"]), ("db", grads[0]["b"])):
        got = np.concatenate([ranks[r][f"trap|{sched}|{key}"]
                              for r in order])
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
        assert not np.allclose(4 * got, np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    dx = sum(res[f"trap|{sched}|dx"] for res in ranks)
    np.testing.assert_allclose(dx, np.asarray(grads[1]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("knob", sorted(cases.PIPE_KNOBS))
def test_pipeline_knobs_and_checkpoints_on_the_mesh(runs, knob,
                                                    tmp_path):
    """Gradient accumulation, rematerialisation and multi-step windows
    on the pipeline mesh {"n": 2, "p": 2}: fit's losses, evaluate,
    predict and the parameters equal the port's one-device run; the
    checkpoint the mesh wrote loads on one device with the same
    parameters."""
    import flexflow_tpu_torch as ft
    one = cases.pipe_knob_run(ft, knob)
    for res in runs["trap"]:
        for k, v in one.items():
            np.testing.assert_allclose(res[f"knob|{knob}|{k}"], v,
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    model = cases.build_pipe(ft, cases.PIPE_CASES["pipe_n2p2"],
                             device="cpu")
    model.load_checkpoint(os.path.join(runs["workdir"],
                                       f"pipe-{knob}.npz"))
    for k, v in cases.weights(model).items():
        np.testing.assert_allclose(v, one[f"param|{k}"], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
