"""One rank of the port's mesh tests: ``python _torch_mesh_worker.py
<suite> <rank> <world> <workdir>``.

Started by ``_torch_mesh_cases.spawn`` (not by pytest: the tests'
conftest imports jax, and a rank imports torch and the port only).  The
rank joins a gloo process group through a ``file://`` rendezvous in
``workdir``, runs its suite on the CPU, and writes what the tests read
to ``<suite>-rank<r>.npz`` (arrays) and ``<suite>-rank<r>.json``
(everything else).
The cases' initial parameters come from ``workdir/init.npz``, which the
test process wrote from the JAX package's models.
"""

import json
import os
import sys
import traceback

import numpy as np
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import _torch_mesh_cases as cases  # noqa: E402
import flexflow_tpu_torch as ft  # noqa: E402
from flexflow_tpu_torch.interop import params_from_jax_numpy  # noqa: E402
from flexflow_tpu_torch.ops import conv as conv_ops  # noqa: E402
from flexflow_tpu_torch.parallel.sharding import (  # noqa: E402
    distribute, is_dtensor)

ARRAYS: dict = {}
RECORD: dict = {}


def init_params(workdir: str, name: str) -> dict:
    with np.load(os.path.join(workdir, "init.npz")) as z:
        return {k.split("|", 1)[1]: z[k] for k in z.files
                if k.startswith(name + "|")}


def mesh_model(name: str, workdir: str):
    case = cases.CASES[name]
    model, logits = cases.build(ft, case, device="cpu")
    cases.compile_model(ft, model, logits, case,
                        mesh=ft.MachineMesh(case["mesh"], device="cpu"))
    model.init_layers(seed=0)
    params_from_jax_numpy(model, init_params(workdir, name))
    return model, case


def run_case(name: str, workdir: str):
    """The case's steps on its mesh: losses, every parameter, the max
    pool's routes and the replicate fallbacks drained."""
    before = dict(conv_ops.POOL_ROUTES)
    model, case = mesh_model(name, workdir)
    ARRAYS[f"{name}|loss"] = np.asarray(cases.train(model, case))
    for k, v in cases.weights(model).items():
        ARRAYS[f"{name}|param|{k}"] = v
    RECORD[name] = {
        "routes": {k: conv_ops.POOL_ROUTES[k] - before[k]
                   for k in before},
        "fallbacks": sorted(list(s) for s in model.runtime_fallback_sites),
        "local": {p.name: list(model._params[p.name].to_local().shape)
                  for p in model.parameters},
    }
    return model


def shard_layouts():
    """The local shard of a c-split kernel, and the block order of a dim
    split over two sub-axes (n0 major, n1 minor)."""
    cfg = ft.FFConfig(batch_size=16, compute_dtype="float32")
    cfg.strategies = {"dense": ft.ParallelConfig(dims=(1, 4),
                                                 device_ids=(0, 1, 2, 3))}
    model = ft.FFModel(cfg, mesh=ft.MachineMesh({"c": 4}, device="cpu"))
    x = model.create_tensor((16, 16), name="x")
    t = model.dense(x, 64, activation="relu")
    model.compile(ft.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
                  [], final_tensor=t)
    model.init_layers()
    RECORD["c4_kernel_local"] = list(
        model._params["dense/kernel"].to_local().shape)
    mesh = ft.MachineMesh({"n": 4}, device="cpu")
    full = torch.arange(8 * 3, dtype=torch.float32,
                        device=mesh.device).reshape(8, 3)
    local = distribute(full, mesh, mesh.sharding(("n", None))).to_local()
    ARRAYS["n4_block"] = local.cpu().numpy()
    RECORD["n4_coordinate"] = list(mesh.coordinate())
    # no shape: pure data parallelism over every rank
    RECORD["default_shape"] = {a: n for a, n in ft.MachineMesh(
        device="cpu").sizes.items() if n > 1}


def refusals(workdir: str):
    """A.8b's items on the mesh: "no error" where one compiles (or, for
    ``reshard``, moves the model in process), else the
    NotImplementedError's text; ``reshard_count`` the ValueError of a
    reshard to another device count."""
    out = {}

    def attempt(what, fn):
        try:
            fn()
            out[what] = "no error"
        except NotImplementedError as e:
            out[what] = f"NotImplementedError: {e}"

    for axis in ("p", "e"):
        def compile_on(axis=axis):
            case = cases.CASES["mlp_dp4"]
            model, logits = cases.build(ft, case, device="cpu")
            cases.compile_model(ft, model, logits, case, mesh=ft.MachineMesh(
                {"n": 2, axis: 2}, device="cpu"))
        attempt(axis, compile_on)

    def host_table():
        cfg = ft.FFConfig(batch_size=8, compute_dtype="float32")
        cfg.strategies = {"embedding": ft.ParallelConfig(
            device_type=ft.DeviceType.HOST, dims=(1, 1), device_ids=(0,),
            memory_types=(ft.MemoryType.ZCM,) * 3)}
        model = ft.FFModel(cfg, mesh=ft.MachineMesh({"n": 4}, device="cpu"))
        ids = model.create_tensor((8, 1), dtype="int32", name="ids")
        t = model.embedding(ids, 10, 4)
        t = model.dense(t, 2)
        model.compile(ft.SGDOptimizer(lr=0.1), final_tensor=t)
    attempt("host", host_table)

    model, _ = mesh_model("mlp_dp4", workdir)
    attempt("reshard", lambda: model.reshard(new_mesh={"n": 2, "c": 2}))
    try:
        model.reshard(num_devices=2)
        out["reshard_count"] = "no error"
    except ValueError as e:
        out["reshard_count"] = f"ValueError: {e}"
    RECORD["refusals"] = out


def knobs():
    """The training-loop knobs on their cases' meshes: fit, evaluate and
    predict (full arrays on every rank)."""
    for knob, (name, _) in cases.KNOBS.items():
        mesh = ft.MachineMesh(cases.CASES[name]["mesh"], device="cpu")
        for k, v in cases.knob_run(ft, knob, mesh).items():
            ARRAYS[f"knob|{knob}|{k}"] = v


def ring_alone():
    """Ring attention at {"s": 4} against the full q, k, v: the output
    and the gradients of sum(out**2), gathered."""
    from flexflow_tpu_torch.ops.attention import ring_attention
    mesh = ft.MachineMesh({"s": 4}, device="cpu")
    rng = np.random.default_rng(1)
    full = [torch.from_numpy(rng.standard_normal((2, 16, 2, 8)).astype(
        np.float32)).to(mesh.device) for _ in range(3)]
    pl = mesh.sharding((None, "s", None, None))
    for causal in (False, True):
        q, k, v = (distribute(t, mesh, pl).requires_grad_() for t in full)
        out = ring_attention(q, k, v, mesh, causal, 0.35)
        (out.full_tensor() ** 2).sum().backward()
        ARRAYS[f"ring|{causal}|out"] = out.full_tensor().detach().cpu() \
            .numpy()
        for name, t in zip("qkv", (q, k, v)):
            ARRAYS[f"ring|{causal}|d{name}"] = \
                t.grad.full_tensor().cpu().numpy()


def checkpoints(workdir: str):
    """A mesh run saved; a one-device file and the JAX package's file
    loaded on the mesh (and trained one more step).  DTensor's
    collectives run through the runtime's counted kernels, registered
    for the CPU here as under gloo on CUDA tensors."""
    from flexflow_tpu_torch.parallel import distributed
    distributed._count_collectives("CPU")
    model = run_case("ckpt", workdir)
    model.save_checkpoint(os.path.join(workdir, "port_mesh.npz"))
    for src in ("port_one", "jax_mesh"):
        fresh, case = mesh_model("ckpt", workdir)
        fresh.load_checkpoint(os.path.join(workdir, f"{src}.npz"))
        for k, v in cases.weights(fresh).items():
            ARRAYS[f"load|{src}|{k}"] = v
        ARRAYS[f"load|{src}|loss"] = np.asarray(cases.train(
            fresh, dict(case, steps=1), seed=1))
    # params_from_jax_numpy on a mesh model: full arrays in, shards kept
    fresh, _ = mesh_model("ckpt", workdir)
    RECORD["interop_local"] = {
        p.name: list(fresh._params[p.name].to_local().shape)
        for p in fresh.parameters}
    for k, v in cases.weights(fresh).items():
        ARRAYS[f"interop|{k}"] = v
    RECORD["collectives"] = distributed.collectives


def one_rank(workdir: str):
    """A one-rank group: the mesh step and the step without a mesh."""
    case = dict(cases.CASES["mlp_n2c2"], degrees={})
    for tag, mesh in (("mesh", ft.MachineMesh({"n": 1}, device="cpu")),
                      ("plain", None)):
        model, logits = cases.build(ft, case, device="cpu")
        cases.compile_model(ft, model, logits, case, mesh=mesh)
        model.init_layers(seed=0)
        params_from_jax_numpy(model, init_params(workdir, "mlp_n2c2"))
        ARRAYS[f"{tag}|loss"] = np.asarray(cases.train(model, case))
        for k, v in cases.weights(model).items():
            ARRAYS[f"{tag}|param|{k}"] = v
        RECORD[tag] = model._on_mesh


def pipe_cases(suite: str, workdir: str):
    """The suite's PIPE_CASES on their meshes, from the JAX package's
    initial parameters: predict, the steps' losses and every parameter,
    each parameter's local shape and the host-placed ones' homes."""
    import gc

    from flexflow_tpu_torch.parallel.distributed import coordination_barrier
    for name in cases.PIPE_SUITES[suite][1]:
        # every rank has let go of the last case's tensors, and waited
        # for the others, before the next case's collectives start
        gc.collect()
        coordination_barrier()
        case = cases.PIPE_CASES[name]
        model = cases.build_pipe(ft, case, device="cpu", mesh=ft.MachineMesh(
            case["mesh"], device="cpu"))
        params_from_jax_numpy(model, init_params(workdir, name))
        for k, v in cases.pipe_run(model, case).items():
            ARRAYS[f"{name}|{k}"] = v
        vals = model._params
        RECORD[name] = {
            "local": {k: list((v.to_local() if is_dtensor(v) else v).shape)
                      for k, v in vals.items()},
            "host": {k: [vals[k].device.type, type(vals[k]).__name__]
                     for k in sorted(model._host_params)},
        }
    if suite == "pipe4":
        trap()
        for knob in cases.PIPE_KNOBS:
            gc.collect()
            coordination_barrier()
            mesh = ft.MachineMesh({"n": 2, "p": 2}, device="cpu")
            for k, v in cases.pipe_knob_run(ft, knob, mesh, workdir).items():
                ARRAYS[f"knob|{knob}|{k}"] = v


def trap():
    """``pipeline_apply`` alone at {"p": 4}, GPipe over 4 stages and
    interleaved over 8 (2 chunks a rank): the output of the stages and,
    for sum(y**2), this rank's gradients (its stage block's and its
    share of the input's)."""
    from flexflow_tpu_torch.parallel.pipeline import pipeline_apply
    mesh = ft.MachineMesh({"p": 4}, device="cpu")
    mesh.make_axis_groups(("p",))
    line = mesh.axis_group("p")
    RECORD["trap_line"] = [list(line.ranks), line.index]
    for sched, stages, v in (("gpipe", 4, None), ("interleaved", 8, 2)):
        w, b, x = cases.trap_data(stages)
        wl = torch.from_numpy(w).chunk(4)[line.index].clone()
        bl = torch.from_numpy(b).chunk(4)[line.index].clone()
        wl.requires_grad_()
        bl.requires_grad_()
        xt = torch.from_numpy(x).requires_grad_()
        y, _ = pipeline_apply(lambda p, h: cases.trap_stage(torch, p, h),
                              {"w": wl, "b": bl}, xt, stages, line, 4, sched,
                              v)
        (y ** 2).sum().backward()
        ARRAYS[f"trap|{sched}|y"] = y.detach().numpy()
        ARRAYS[f"trap|{sched}|dw"] = wl.grad.numpy()
        ARRAYS[f"trap|{sched}|db"] = bl.grad.numpy()
        ARRAYS[f"trap|{sched}|dx"] = xt.grad.numpy()


SUITES = {
    "cnn": lambda w: ([run_case(c, w) for c in (
        "mlp_dp4", "mlp_n2c2", "mlp_mixed", "mlp_fallback", "cnn_n2c2",
        "cnn_hw")], shard_layouts(), refusals(w), knobs()),
    "transformer": lambda w: ([run_case(c, w) for c in (
        "tf_s2c2", "tf_n2c2", "tf_nondiv", "tf_dropout")], ring_alone()),
    "checkpoint": checkpoints,
    "one_rank": one_rank,
    **{name: (lambda w, name=name: pipe_cases(name, w))
       for name in cases.PIPE_SUITES},
}


def main():
    suite, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    ft.initialize_distributed(
        init_method="file://" + os.path.join(workdir, f"store-{suite}"),
        world_size=world, rank=rank, device_type="cpu")
    try:
        SUITES[suite](workdir)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    np.savez(os.path.join(workdir, f"{suite}-rank{rank}.npz"), **ARRAYS)
    with open(os.path.join(workdir, f"{suite}-rank{rank}.json"), "w") as f:
        json.dump(RECORD, f)
    ft.finalize_distributed()


if __name__ == "__main__":
    main()
