"""Pipeline stages in the port against the JAX package on one device,
on the CPU in float32 (``tests/test_pipeline.py``,
``tests/test_pipeline_segment.py``): the schedules, the pipeline block
and segments (dense and MoE stages) at p == 1 under both schedules,
their refusals, and host placement of an op other than an Embedding.

Every model is built in both packages (``_torch_mesh_cases.build_pipe``)
and the JAX weights are carried into the port with
``interop.params_from_jax_numpy``.  Tolerances: rtol 1e-4, atol 1e-5 on
outputs, losses and parameters (the JAX parallel tests'); float32
einsums sum in another order in the two packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_cases as cases
import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.parallel import pipeline as jpipe
from flexflow_tpu.parallel.mesh import MachineMesh as JaxMesh
from flexflow_tpu_torch.interop import params_from_jax_numpy
from flexflow_tpu_torch.parallel import pipeline as tpipe
from flexflow_tpu_torch.parallel.distributed import AxisGroup

RTOL, ATOL = 1e-4, 1e-5

ONE_DEVICE = {
    "block": dict(graph="block", steps=4),
    "block_interleaved": dict(graph="block", steps=4,
                              schedule="interleaved", virtual=2),
    "segment_dense": dict(graph="segment", stage="dense", steps=4),
    "segment_moe": dict(graph="segment", stage="moe", steps=4),
    "segment_interleaved": dict(graph="segment", stage="dense", steps=4,
                                stages=4, schedule="interleaved",
                                virtual=2),
}


def _pair(case):
    """The JAX model on one device, the port's on the CPU, both from the
    JAX model's initial weights."""
    jm = cases.build_pipe(ff, case, mesh=JaxMesh({"n": 1}))
    pm = cases.build_pipe(ft, case, device="cpu")
    params_from_jax_numpy(pm, cases.weights(jm))
    return jm, pm


GRID = [(S, M, v) for S in (1, 2, 3, 4) for M in (1, 2, 4, 8)
        for v in (1, 2, 3)]


@pytest.mark.parametrize("S,M,v", GRID)
def test_schedules_equal_the_jax_ticks(S, M, v):
    """traversal_order and the tick counts are the JAX package's."""
    for sched in ("gpipe", "interleaved"):
        assert tpipe.traversal_order(S * v, S, sched) == \
            jpipe.traversal_order(S * v, S, sched)
    assert tpipe._interleaved_ticks(S, M, v) == jpipe._interleaved_ticks(
        S, M, v)
    assert len(tpipe.interleaved_schedule(S, M, v)) == \
        jpipe._interleaved_ticks(S, M, v)
    assert len(tpipe.gpipe_schedule(S, M)) == S + M - 1


def _jax_tag_protocol(S, M, v):
    """The units the JAX interleaved loop processes, tick by tick and rank
    by rank: its traced rules (``_pipeline_interleaved_local``) run on
    Python integers.  (chunk, microbatch) where the tag is live, else
    None."""
    tag, mb, inj = [-1] * S, [0] * S, 0
    ticks = []
    for _ in range(jpipe._interleaved_ticks(S, M, v)):
        row, send_tag = [], []
        for r in range(S):
            if r == 0 and tag[0] < 0 and inj < M:
                tag[0], mb[0], inj = 0, inj, inj + 1
            row.append((tag[r], mb[r]) if tag[r] >= 0 else None)
            if tag[r] < 0:
                send_tag.append(-1)
            elif r == S - 1:
                send_tag.append(-1 if tag[r] == v - 1 else tag[r] + 1)
            else:
                send_tag.append(tag[r])
        ticks.append(row)
        # ppermute around the ring j -> j + 1
        tag = [send_tag[(r - 1) % S] for r in range(S)]
        mb = [mb[(r - 1) % S] for r in range(S)]
    return ticks


@pytest.mark.parametrize("S,M,v", [(2, 2, 2), (2, 4, 2), (4, 4, 2),
                                   (2, 8, 4), (4, 8, 3), (3, 5, 2)])
def test_interleaved_schedule_is_the_jax_tag_protocol(S, M, v):
    """The host's schedule names, at every tick and rank, the (chunk,
    microbatch) the JAX loop's ring carries there."""
    want = _jax_tag_protocol(S, M, v)
    got = [[None if u is None else (u.chunk, u.mb) for u in row]
           for row in tpipe.interleaved_schedule(S, M, v)]
    assert got == want


def test_gpipe_schedule_runs_the_jax_valid_ticks():
    """Rank r runs microbatch t - r exactly at the ticks the JAX loop
    counts (``r <= t < r + M``); the bubbles run nothing."""
    S, M = 4, 6
    for t, row in enumerate(tpipe.gpipe_schedule(S, M)):
        for r, u in enumerate(row):
            valid = r <= t < r + M
            assert (u is not None) == valid
            if valid:
                assert (u.mb, u.inject, u.emit, u.send) == (
                    t - r, r == 0, r == S - 1, r < S - 1)


@pytest.mark.parametrize("name", sorted(ONE_DEVICE))
def test_pipeline_at_p1_matches_jax(name):
    """predict, 4 train_batch losses and every parameter after them."""
    case = ONE_DEVICE[name]
    jm, pm = _pair(case)
    jr, pr = cases.pipe_run(jm, case), cases.pipe_run(pm, case)
    assert set(jr) == set(pr)
    for k, v in jr.items():
        np.testing.assert_allclose(pr[k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_segment_weights_are_stacked_under_the_jax_names():
    """Every inner weight stacked over the stage dim, split over 'p', the
    c-splittable kernels' TP dim kept and the experts' dim over 'e'."""
    case = ONE_DEVICE["segment_moe"]
    jm, pm = _pair(case)
    jw = {p.name: p for p in jm.parameters}
    for p in pm.parameters:
        want = jw[p.name]
        assert (p.shape, p.shard_axis, p.sharded_dim, p.inner_sharded_dim,
                p.inner_shard_axis) == (
            want.shape, want.shard_axis, want.sharded_dim,
            want.inner_sharded_dim, want.inner_shard_axis), p.name
    assert pm.layers[0].num_stages == 2
    kinds = {p.name.split("/")[-1]: p for p in pm.parameters
             if p.shard_axis == "p"}
    assert kinds["kernel"].inner_sharded_dim == 1
    assert kinds["w_up"].inner_shard_axis == "e"


def test_segment_aux_loss_enters_the_objective():
    """A stage's MoE load-balance loss reaches the training loss, as in
    the JAX package (its weight 0 lowers the loss by the aux term)."""
    case = ONE_DEVICE["segment_moe"]
    batch = cases.pipe_data(case)
    losses = {}
    for w in (1e-2, 0.0):
        def stage(seg, t, w=w):
            h = seg.dense(t, 32, activation="relu")
            h = seg.dense(h, t.shape[-1])
            return seg.moe(h, num_experts=2, d_ff=32, k=1,
                           capacity_factor=4.0, aux_loss_weight=w)
        got = []
        for pkg, kw in ((ff, dict(mesh=JaxMesh({"n": 1}))),
                        (ft, dict(device="cpu"))):
            cfg = pkg.FFConfig(batch_size=8, compute_dtype="float32")
            model = pkg.FFModel(cfg, **({"device": "cpu"} if pkg is ft
                                        else {}))
            x = model.create_tensor((8, 4, 16), name="x")
            t = model.pipeline(x, 2, stage, num_microbatches=2)
            logits = model.dense(model.reshape(t, (8, 64)), 4)
            model.compile(pkg.SGDOptimizer(lr=0.2),
                          "sparse_categorical_crossentropy", [],
                          final_tensor=logits, mesh=kw.get("mesh"))
            model.init_layers(seed=0)
            if pkg is ft:
                params_from_jax_numpy(model, jw)
            else:
                jw = cases.weights(model)
            got.append(float(model.train_batch(*batch)))
        np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)
        losses[w] = got[1]
    assert losses[1e-2] > losses[0.0]


def _refusal(pkg, fn):
    with pytest.raises(Exception) as info:
        fn(pkg)
    return type(info.value), str(info.value)


def test_shape_changing_stage_is_refused_as_in_jax():
    def build(pkg):
        cfg = pkg.FFConfig(batch_size=8, compute_dtype="float32")
        model = pkg.FFModel(cfg, **({"device": "cpu"} if pkg is ft else {}))
        x = model.create_tensor((8, 4, 16), name="x")
        model.pipeline(x, 2, lambda seg, t: seg.dense(t, 17))
    want = _refusal(ff, build)
    assert want[0] is ValueError and "ring invariance" in want[1]
    assert _refusal(ft, build) == want


def test_batchnorm_in_a_stage_is_refused_as_in_jax():
    """Running statistics cannot leave the stages: the training step
    raises the JAX package's ValueError; predict runs."""
    def build(pkg):
        cfg = pkg.FFConfig(batch_size=4, compute_dtype="float32")
        model = pkg.FFModel(cfg, **({"device": "cpu"} if pkg is ft else {}))
        x = model.create_tensor((4, 3, 4, 4), name="x")
        t = model.pipeline(x, 2, lambda seg, t: seg.batch_norm(t))
        logits = model.dense(model.flat(t), 2)
        model.compile(pkg.SGDOptimizer(lr=0.1),
                      "sparse_categorical_crossentropy", [],
                      final_tensor=logits,
                      **({"mesh": JaxMesh({"n": 1})} if pkg is ff else {}))
        model.init_layers(seed=0)
        rng = np.random.default_rng(0)
        x = rng.standard_normal((4, 3, 4, 4)).astype(np.float32)
        assert np.all(np.isfinite(model.predict(x)))
        model.train_batch(x, np.zeros((4, 1), np.int32))
    want = _refusal(ff, build)
    assert want[0] is ValueError and "running-stat" in want[1]
    assert _refusal(ft, build) == want


def _line(size):
    """A line of ``size`` ranks seen from its first: the schedule's
    checks raise before any message."""
    return AxisGroup(None, tuple(range(size)), 0)


@pytest.mark.parametrize("stages,p,M,sched,v,n", [
    (6, 4, None, "gpipe", None, 8),        # stages not a multiple of p
    (8, 4, None, "interleaved", None, 8),  # no virtual_stages
    (8, 4, None, "interleaved", 3, 8),     # virtual_stages not dividing
    (8, 2, None, "interleaved", 2, 8),     # p is not stages / v
    (4, 4, 3, "gpipe", None, 8),           # M does not divide the batch
])
def test_pipeline_apply_refusals_are_the_jax_ones(stages, p, M, sched, v,
                                                  n):
    jstacked = {"w": jnp.zeros((stages, 3, 3))}
    want = _refusal(None, lambda _: jpipe.pipeline_apply(
        lambda q, x: x, jstacked, jnp.zeros((n, 3)), JaxMesh({"p": p}),
        M, schedule=sched, virtual_stages=v))
    tstacked = {"w": torch.zeros((stages // p, 3, 3))}
    got = _refusal(None, lambda _: tpipe.pipeline_apply(
        lambda q, x: x, tstacked, torch.zeros((n, 3)), stages, _line(p), M,
        sched, v))
    assert got == want


def test_moe_capacity_binds_in_the_mesh_cases():
    """The mesh tests' MoE (capacity factor 1.25, k 2) drops tokens on
    their data, so the global slot order is what they check."""
    case = cases.PIPE_CASES["moe_e4"]
    jm, model = _pair(case)
    op = model.layers[0]
    x = torch.from_numpy(cases.pipe_data(case)[0]).reshape(-1, 32)
    gate = model._params[op.w_gate.name]
    probs = torch.softmax(x @ gate.T, dim=-1)
    dispatch, _, _ = op.route(probs, op.capacity)
    kept = int(dispatch.sum())
    assert kept < op.k * x.shape[0], (kept, op.capacity)


def test_moe_ties_route_to_the_lower_expert_as_in_jax():
    """Tokens that reach the router as zeros tie every expert (a dropped
    token's zero output entering the next stage's MoE does): each goes
    to the lowest expert, as ``jax.lax.top_k`` orders ties, and fills
    that expert's slots before the tokens after it.  The forward, the
    load-balance loss and every gradient equal the JAX op's, with the
    capacity binding."""

    import jax

    from flexflow_tpu.op import OpContext as JaxCtx
    from flexflow_tpu_torch.op import OpContext

    def build(pkg, **kw):
        model = pkg.FFModel(pkg.FFConfig(batch_size=4,
                                         compute_dtype="float32"), **kw)
        x = model.create_tensor((4, 4, 16), name="x")
        model.moe(x, num_experts=8, d_ff=32, k=1, capacity_factor=1.0,
                  aux_loss_weight=1e-2)
        return model.layers[-1]

    jop, top = build(ff), build(ft, device="cpu")
    rng = np.random.default_rng(0)
    params = {w.name: (rng.standard_normal(w.shape) * 0.3).astype(
        np.float32) for w in jop.weights}
    x = rng.standard_normal((4, 4, 16)).astype(np.float32)
    x[:, ::2] = 0.0
    r = rng.standard_normal(x.shape).astype(np.float32)

    def jfun(p, xj):
        ctx = JaxCtx(training=True, rng=None, compute_dtype="float32",
                     mesh=None)
        out = jop.forward(p, [xj], ctx)[0]
        aux = ctx.aux_losses[jop.name]
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jfun, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ctx = OpContext(device=torch.device("cpu"), seed=0, training=True,
                    compute_dtype="float32")
    tout = top.forward(tp, [tx], ctx)[0]
    taux = ctx.aux_losses[top.name]
    (torch.sum(tout * torch.from_numpy(r)) + taux).backward()
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, 16)
                          @ tp[top.w_gate.name].detach().T, dim=-1)
    dispatch, _, top_idx = top.route(probs, top.capacity)
    zeros = torch.from_numpy(x.reshape(-1, 16)).abs().sum(dim=-1) == 0
    assert bool((top_idx[zeros, 0] == 0).all())
    assert int(dispatch.sum()) < x.shape[0] * x.shape[1]   # it binds
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL,
                               atol=ATOL)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=RTOL, atol=ATOL)


def _mlp(host: bool, device="cpu", **kw):
    cfg = ft.FFConfig(batch_size=16, compute_dtype="float32")
    if host:
        cfg.strategies = {"dense": ft.ParallelConfig(
            device_type=ft.DeviceType.HOST, dims=(1, 1), device_ids=(0,),
            memory_types=(ft.MemoryType.ZCM,) * 3)}
    model = ft.FFModel(cfg, device=device)
    x = model.create_tensor((16, 16), name="x")
    t = model.dense(x, 32, activation="relu")
    logits = model.dense(t, 8)
    model.compile(ft.SGDOptimizer(lr=0.05, momentum=0.9),
                  "sparse_categorical_crossentropy", [],
                  final_tensor=logits)
    model.init_layers(seed=0)
    return model


def test_host_placed_linear_steps_as_on_the_device():
    """A host-placed Linear keeps its kernel and bias in host memory (the
    same buffers before and after each step), copies them to the device
    for the forward and the update, and trains to the same values as the
    device-placed Linear from the same weights."""
    host, dev = _mlp(True), _mlp(False)
    assert host._host_stream == ["dense/kernel", "dense/bias"]
    bufs = {k: host._params[k] for k in host._host_stream}
    batch = cases.pipe_data(dict(graph="mlp_host"))
    np.testing.assert_array_equal(host.predict(batch[0]),
                                  dev.predict(batch[0]))
    for _ in range(3):
        lh, ld = host.train_batch(*batch), dev.train_batch(*batch)
        assert float(lh) == float(ld)
    for k, buf in bufs.items():
        assert host._params[k] is buf and buf.device.type == "cpu"
        np.testing.assert_array_equal(host.get_weights(k),
                                      dev.get_weights(k))
    # the optimizer's state for them lives on the device
    assert all(v.device == host.device
               for v in host._opt_state["v"].values())
