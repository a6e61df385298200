"""The cases of the port's mesh tests (``tests/test_torch_mesh*.py``):
graphs, strategies, data and the rank harness, shared by the test
process, which runs the JAX package and the port's one-device runs, and
by the ranks (``tests/_torch_mesh_worker.py``), which run the port on a
gloo mesh of CPU processes.  It imports neither package: each function
takes the package module it builds with (``flexflow_tpu`` or
``flexflow_tpu_torch``).
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np

WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))

# case -> graph, mesh shape, batch, per-op degrees, steps, optimizer
CASES = {
    "mlp_dp4": dict(graph="mlp", mesh={"n": 4}, batch=32, steps=5,
                    degrees={"dense": (4, 1), "dense_1": (4, 1)}),
    "mlp_n2c2": dict(graph="mlp", mesh={"n": 2, "c": 2}, batch=16, steps=5,
                     degrees={"dense": (2, 2), "dense_1": (2, 2)}),
    # a degree-2 strategy beside a degree-4 one on an {"n": 4} mesh
    "mlp_mixed": dict(graph="mlp", mesh={"n": 4}, batch=16, steps=5,
                      degrees={"dense": (2, 1), "dense_1": (4, 1)}),
    # a degree 3 that no axis of the mesh realizes: replicated, FF106
    "mlp_fallback": dict(graph="mlp", mesh={"n": 4}, batch=16, steps=1,
                         degrees={"dense": (3, 1)}),
    # the multichip dryrun's CNN: conv on n, dense on n x c
    "cnn_n2c2": dict(graph="cnn", mesh={"n": 2, "c": 2}, batch=8, steps=1,
                     momentum=0.9,
                     degrees={"conv2d": (2, 1, 1, 1), "dense": (2, 2),
                              "dense_1": (2, 2)}),
    # conv and pool split over h: the pool takes reduce_window's route
    "cnn_hw": dict(graph="cnn", mesh={"n": 2, "h": 2}, batch=8, steps=1,
                   momentum=0.9,
                   degrees={"conv2d": (2, 1, 2, 1), "pool2d": (2, 1, 2, 1)}),
    # the multichip dryrun's transformer at {"s": 2, "c": 2}, and heads
    # split at {"n": 2, "c": 2}
    "tf_s2c2": dict(graph="transformer", mesh={"s": 2, "c": 2}, batch=2,
                    steps=1, seq=16,
                    degrees={"attention_0": (1, 2, 1),
                             "ffn_up_0": (1, 1, 2)}),
    "tf_n2c2": dict(graph="transformer", mesh={"n": 2, "c": 2}, batch=4,
                    steps=1, seq=16,
                    degrees={"attention_0": (2, 1, 2),
                             "ffn_up_0": (2, 1, 2)}),
    # a batch of 3 that the n axis of 2 does not divide
    "tf_nondiv": dict(graph="transformer", mesh={"n": 2, "s": 2}, batch=3,
                      steps=1, seq=8, degrees={"attention_0": (1, 2, 1)}),
    "tf_dropout": dict(graph="transformer", mesh={"s": 4}, batch=8, steps=6,
                       seq=16, dropout=0.2,
                       degrees={"attention_0": (1, 4, 1)}),
    # checkpoints: a mesh of n2 x c2 with Adam state
    "ckpt": dict(graph="mlp", mesh={"n": 2, "c": 2}, batch=16, steps=2,
                 adam=True, degrees={"dense": (2, 2), "dense_1": (2, 2)}),
}


# the training-loop knobs on a mesh: case, config fields
KNOBS = {
    "accumulation": ("mlp_n2c2", {"gradient_accumulation_steps": 2}),
    "window": ("mlp_n2c2", {"steps_per_dispatch": 2}),
    "pad_tail": ("mlp_n2c2", {"pad_tail_batches": True}),
    "remat": ("tf_n2c2", {"remat": True}),
}


def knob_run(ft, knob: str, mesh=None) -> dict:
    """The port's run of a knob: ``fit`` over one epoch of the case's
    batch and 5 more rows (a tail), then ``evaluate`` and ``predict`` of
    the same rows; parameters from ``init_layers(seed=0)``, the same on
    every rank and on one device.  ``mesh`` None runs one device without
    the case's strategies."""
    name, fields = KNOBS[knob]
    case = dict(CASES[name])
    if mesh is None:
        case["degrees"] = {}
    model, logits = build(ft, case, device="cpu")
    for k, v in fields.items():
        setattr(model.config, k, v)
    compile_model(ft, model, logits, case, mesh=mesh)
    model.init_layers(seed=0)
    x, y = data(case)
    xs, ys = np.concatenate([x, x[:5]]), np.concatenate([y, y[:5]])
    model.fit(xs, ys, epochs=1, verbose=False)
    out = {"losses": np.asarray(model.last_epoch_losses),
           "eval": np.asarray(model.evaluate(xs, ys)[0]),
           "predict": np.asarray(model.predict(xs))}
    out.update({f"param|{k}": v for k, v in weights(model).items()})
    return out


def strategies(pkg, case: dict) -> dict:
    return {name: pkg.ParallelConfig(
        dims=tuple(d), device_ids=tuple(range(int(np.prod(d)))))
        for name, d in case["degrees"].items()}


def data(case: dict, seed: int = 0):
    rng = np.random.default_rng(seed)
    b = case["batch"]
    if case["graph"] == "mlp":
        x = rng.standard_normal((b, 16), dtype=np.float32)
    elif case["graph"] == "cnn":
        x = rng.standard_normal((b, 3, 16, 16), dtype=np.float32)
    else:
        x = rng.integers(0, 64, (b, case["seq"])).astype(np.int32)
        return x, rng.integers(0, 4, (b, 1)).astype(np.int32)
    return x, rng.integers(0, 8, (b, 1)).astype(np.int32)


def build(pkg, case: dict, **model_kw):
    """The case's model and its logits, from ``pkg``; ``model_kw`` go to
    the FFModel (the port's ``device=``)."""
    cfg = pkg.FFConfig(batch_size=case["batch"], compute_dtype="float32")
    cfg.strategies = strategies(pkg, case)
    if case["graph"] == "transformer":
        build_tf = importlib.import_module(
            pkg.__name__ + ".models.transformer").build_transformer
        model, _, logits = build_tf(
            cfg, num_layers=1, d_model=32, num_heads=2, d_ff=64,
            seq_len=case["seq"], vocab_size=64, num_classes=4,
            dropout=case.get("dropout", 0.0), **model_kw)
        return model, logits
    model = pkg.FFModel(cfg, **model_kw)
    if case["graph"] == "mlp":
        x = model.create_tensor((case["batch"], 16), name="x")
        t = model.dense(x, 64, activation="relu")
        return model, model.dense(t, 8)
    x = model.create_tensor((case["batch"], 3, 16, 16), name="img")
    t = model.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation="relu")
    t = model.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = model.flat(t)
    t = model.dense(t, 32, activation="relu")
    return model, model.dense(t, 8)


def compile_model(pkg, model, logits, case: dict, mesh=None) -> None:
    if case.get("adam"):
        opt = pkg.AdamOptimizer(alpha=0.01)
    else:
        opt = pkg.SGDOptimizer(lr=0.05, momentum=case.get("momentum", 0.0))
    model.compile(opt, "sparse_categorical_crossentropy", ["accuracy"],
                  final_tensor=logits, mesh=mesh)


def train(model, case: dict, seed: int = 0):
    """The case's steps on its data: the per-step losses."""
    x, y = data(case, seed)
    return [float(model.train_batch(x, y)) for _ in range(case["steps"])]


def weights(model) -> dict:
    return {p.name: np.asarray(model.get_weights(p.name), np.float32)
            for p in model.parameters}


# ----------------------------------------------------------------------
# the rank harness
# ----------------------------------------------------------------------
def spawn(suite: str, workdir: str, world: int = WORLD,
          timeout: float = 600.0,
          script: str = "_torch_mesh_worker.py") -> list:
    """Run ``suite`` of ``script`` (a rank script beside this file) on
    ``world`` CPU ranks (gloo, a ``file://`` rendezvous in ``workdir``)
    and return each rank's results: a dict of numpy arrays and, under
    ``"json"``, the decoded JSON record.  A rank that fails raises with
    its output."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for r in range(world):
        log = open(os.path.join(workdir, f"{suite}-rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE, script),
             suite, str(r), str(world), workdir],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    deadline = time.monotonic() + timeout
    codes = []
    try:
        for p, log in procs:
            codes.append(p.wait(timeout=max(1.0,
                                            deadline - time.monotonic())))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if any(codes):
        logs = "\n".join(
            f"--- rank {r} (exit {c}) ---\n"
            + open(os.path.join(workdir,
                                f"{suite}-rank{r}.log")).read()[-4000:]
            for r, c in enumerate(codes) if c)
        raise RuntimeError(f"mesh ranks failed:\n{logs}")
    out = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"{suite}-rank{r}.npz")) as z:
            res = {k: z[k] for k in z.files}
        with open(os.path.join(workdir, f"{suite}-rank{r}.json")) as f:
            res["json"] = json.load(f)
        out.append(res)
    return out


# ----------------------------------------------------------------------
# pipeline stages (p), experts (e) and host placement on a mesh
# ----------------------------------------------------------------------
# case -> graph, mesh, steps and the graph's options; "block" is the
# JAX package's tests/test_pipeline.py model (4 encoder stages),
# "segment" tests/test_pipeline_segment.py's (2 stages of dense layers,
# with a MoE for "moe"), "composed" the multichip dryrun's {n, e, p}
# program, "moe" tests/test_moe.py's (capacity factor 1.25, which binds),
# "dlrm" tests/test_dlrm.py's with every table host-placed and "mlp" a
# two-layer MLP whose first layer is host-placed
PIPE_CASES = {
    "pipe_p2": dict(graph="block", mesh={"p": 2}, steps=4),
    "pipe_inter_p2": dict(graph="block", mesh={"p": 2}, steps=4,
                          schedule="interleaved", virtual=2),
    "dlrm_n2": dict(graph="dlrm", mesh={"n": 2}, steps=3),
    "pipe_p4": dict(graph="block", mesh={"p": 4}, steps=4),
    "pipe_n2p2": dict(graph="block", mesh={"n": 2, "p": 2}, steps=4),
    "pipe_m8": dict(graph="block", mesh={"p": 4}, steps=4, micro=8),
    "pipe_inter_n2p2": dict(graph="block", mesh={"n": 2, "p": 2}, steps=4,
                            schedule="interleaved", virtual=2, micro=4),
    "seg_dense_n2p2": dict(graph="segment", stage="dense",
                           mesh={"n": 2, "p": 2}, steps=4),
    "seg_moe_e2p2": dict(graph="segment", stage="moe",
                         mesh={"e": 2, "p": 2}, steps=4),
    "seg_moe_n2p2": dict(graph="segment", stage="moe",
                         mesh={"n": 2, "p": 2}, steps=4),
    "moe_e4": dict(graph="moe", mesh={"e": 4}, steps=3),
    "moe_n2e2": dict(graph="moe", mesh={"n": 2, "e": 2}, steps=3),
    "dlrm_n4": dict(graph="dlrm", mesh={"n": 4}, steps=3),
    "mlp_host_n4": dict(graph="mlp_host", mesh={"n": 4}, steps=3),
    "composed": dict(graph="composed", mesh={"n": 2, "e": 2, "p": 2},
                     steps=2),
    "seg_moe8_n2e2p2": dict(graph="segment", stage="moe8",
                            mesh={"n": 2, "e": 2, "p": 2}, steps=3),
}
# the suites of ranks that run them, by world size
PIPE_SUITES = {
    "pipe2": (2, ("pipe_p2", "pipe_inter_p2", "dlrm_n2")),
    "pipe4": (4, ("pipe_p4", "pipe_n2p2", "pipe_m8", "pipe_inter_n2p2",
                  "seg_dense_n2p2", "seg_moe_e2p2", "seg_moe_n2p2",
                  "moe_e4", "moe_n2e2", "dlrm_n4", "mlp_host_n4")),
    "composed": (8, ("composed", "seg_moe8_n2e2p2")),
}
DLRM_EMB = (100, 200, 50, 80)


def _host_pc(pkg):
    return pkg.ParallelConfig(
        device_type=pkg.DeviceType.HOST, dims=(1, 1), device_ids=(0,),
        memory_types=(pkg.MemoryType.ZCM,) * 3)


def _segment_stage(kind: str):
    def stage(seg, t):
        width = 32
        h = seg.dense(t, width, activation="relu")
        h = seg.dense(h, t.shape[-1])
        if kind == "dense":
            return h
        if kind == "moe8":
            # a capacity of 4 tokens an expert (from the stage's whole
            # batch of 32) against a microbatch's 16: it binds
            return seg.moe(h, num_experts=8, d_ff=32, k=1,
                           capacity_factor=1.0, aux_loss_weight=1e-2)
        return seg.moe(h, num_experts=2, d_ff=32, k=1, capacity_factor=4.0,
                       aux_loss_weight=1e-2)
    return stage


def build_pipe(pkg, case: dict, host: bool = True, **model_kw):
    """The case's model, from ``pkg``, compiled on ``mesh`` (a keyword:
    the JAX package's or the port's mesh, or None for one device) and
    initialised from seed 0; ``host`` False places the host-placed ops
    of "mlp_host" on the device.  (The JAX package's step cannot
    multiply a host-placed kernel in this jaxlib: ``dot_general`` refuses
    operands in two memory spaces, so its reference runs the same
    values on the device.)"""
    mesh = model_kw.pop("mesh", None)
    graph = case["graph"]
    if graph == "dlrm":
        cfg = pkg.FFConfig(batch_size=16, compute_dtype="float32")
        cfg.strategies = {f"embedding{i}": _host_pc(pkg)
                          for i in range(len(DLRM_EMB))}
        build_dlrm = importlib.import_module(
            pkg.__name__ + ".models.dlrm").build_dlrm
        model, _, preds = build_dlrm(
            cfg, embedding_size=DLRM_EMB, sparse_feature_size=8,
            mlp_bot=(4, 16, 8), mlp_top=(40, 16, 1), **model_kw)
        model.compile(pkg.SGDOptimizer(lr=0.05), metrics=[],
                      final_tensor=preds, mesh=mesh)
        model.init_layers(seed=0)
        return model
    if graph == "mlp_host":
        cfg = pkg.FFConfig(batch_size=16, compute_dtype="float32")
        if host:
            cfg.strategies = {"dense": _host_pc(pkg)}
        model = pkg.FFModel(cfg, **model_kw)
        x = model.create_tensor((16, 16), name="x")
        t = model.dense(x, 32, activation="relu")
        logits = model.dense(t, 8)
        opt = pkg.SGDOptimizer(lr=0.05, momentum=0.9)
    elif graph == "block":
        cfg = pkg.FFConfig(batch_size=8, compute_dtype="float32")
        model = pkg.FFModel(cfg, **model_kw)
        tok = model.create_tensor((8, 12), dtype="int32", name="tokens")
        t = model.embedding(tok, 50, 32, aggr="none")
        t = model.pipeline_transformer_block(
            t, num_stages=4, num_heads=4, d_ff=64,
            num_microbatches=case.get("micro"),
            schedule=case.get("schedule", "gpipe"),
            virtual_stages=case.get("virtual"))
        cls = model.reshape(model.split(t, [1, 11], axis=1)[0], (8, 32))
        logits = model.dense(cls, 4)
        opt = pkg.SGDOptimizer(lr=0.1)
    elif graph == "moe":
        cfg = pkg.FFConfig(batch_size=16, compute_dtype="float32")
        model = pkg.FFModel(cfg, **model_kw)
        x = model.create_tensor((16, 8, 32), name="x")
        t = model.moe(x, 4, d_ff=64, k=2, capacity_factor=1.25,
                      aux_loss_weight=1e-2, name="moe0")
        t = model.flat(t)
        logits = model.dense(t, 8, name="head")
        opt = pkg.SGDOptimizer(lr=0.05)
    else:   # "segment", "composed"
        cfg = pkg.FFConfig(batch_size=8, compute_dtype="float32")
        model = pkg.FFModel(cfg, **model_kw)
        x = model.create_tensor((8, 4, 16), name="x")
        stage = _segment_stage("moe" if graph == "composed"
                               else case["stage"])
        t = model.pipeline(x, num_stages=case.get("stages", 2),
                           stage_builder=stage, num_microbatches=2,
                           schedule=case.get("schedule", "gpipe"),
                           virtual_stages=case.get("virtual"))
        t = model.reshape(t, (8, 64))
        logits = model.dense(t, 4)
        opt = pkg.SGDOptimizer(lr=0.05 if graph == "composed" else 0.2)
    model.compile(opt, "sparse_categorical_crossentropy", [],
                  final_tensor=logits, mesh=mesh)
    model.init_layers(seed=0)
    return model


def pipe_data(case: dict, seed: int = 0):
    """The case's batch: the inputs, then the labels."""
    rng = np.random.default_rng(seed)
    graph = case["graph"]
    if graph == "dlrm":
        sparse = [rng.integers(0, v, (16, 1)).astype(np.int32)
                  for v in DLRM_EMB]
        dense = rng.standard_normal((16, 4)).astype(np.float32)
        return (*sparse, dense, rng.random((16, 1)).astype(np.float32))
    if graph == "mlp_host":
        return (rng.standard_normal((16, 16), dtype=np.float32),
                rng.integers(0, 8, (16, 1)).astype(np.int32))
    if graph == "block":
        return (rng.integers(0, 50, (8, 12)).astype(np.int32),
                rng.integers(0, 4, (8, 1)).astype(np.int32))
    if graph == "moe":
        # shifted by 1: the router favours some experts over others, so
        # the capacity binds and tokens are dropped
        return (rng.standard_normal((16, 8, 32)).astype(np.float32) + 1.0,
                rng.integers(0, 8, (16, 1)).astype(np.int32))
    return (rng.standard_normal((8, 4, 16)).astype(np.float32),
            rng.integers(0, 4, (8, 1)).astype(np.int32))


def pipe_run(model, case: dict) -> dict:
    """``predict`` of the case's inputs, then its steps on its batch:
    the outputs, the per-step losses and every parameter."""
    batch = pipe_data(case)
    out = {"predict": np.asarray(model.predict(list(batch[:-1])),
                                 np.float32),
           "loss": np.asarray([float(model.train_batch(*batch))
                               for _ in range(case["steps"])])}
    out.update({f"param|{k}": v for k, v in weights(model).items()})
    return out


def trap_stage(pkg_np, p, x):
    """The stage of the pipeline-collective checks: tanh(x @ w + b)."""
    return pkg_np.tanh(x @ p["w"] + p["b"])


def trap_data(stages: int = 4):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((stages, 8, 8)).astype(np.float32) * 0.3
    b = rng.standard_normal((stages, 8)).astype(np.float32) * 0.1
    x = rng.standard_normal((16, 8)).astype(np.float32)
    return w, b, x


# the training-loop knobs and checkpoints on a pipeline mesh: the block
# at {"n": 2, "p": 2} under each config field
PIPE_KNOBS = {
    "accumulation": {"gradient_accumulation_steps": 2},
    "remat": {"remat": True},
    "window": {"steps_per_dispatch": 2},
}


def pipe_knob_run(ft, knob: str, mesh=None, workdir=None) -> dict:
    """The port's block model (initial parameters from seed 0) under the
    knob: ``fit`` over two batches, then ``evaluate`` and ``predict``;
    with ``workdir`` it also saves a checkpoint there."""
    case = dict(PIPE_CASES["pipe_n2p2"])
    model = build_pipe(ft, case, device="cpu", mesh=mesh)
    for k, v in PIPE_KNOBS[knob].items():
        setattr(model.config, k, v)
    x, y = pipe_data(case)
    xs, ys = np.concatenate([x, x[::-1]]), np.concatenate([y, y[::-1]])
    model.fit(xs, ys, epochs=1, verbose=False)
    out = {"losses": np.asarray(model.last_epoch_losses),
           "eval": np.asarray(model.evaluate(xs, ys)[0]),
           "predict": np.asarray(model.predict(xs))}
    out.update({f"param|{k}": v for k, v in weights(model).items()})
    if workdir is not None:
        model.save_checkpoint(os.path.join(workdir, f"pipe-{knob}.npz"))
    return out
