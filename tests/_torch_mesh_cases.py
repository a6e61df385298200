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
          timeout: float = 600.0) -> list:
    """Run ``suite`` of ``_torch_mesh_worker.py`` on ``world`` CPU ranks
    (gloo, a ``file://`` rendezvous in ``workdir``) and return each
    rank's results: a dict of numpy arrays and, under ``"json"``, the
    decoded JSON record.  A rank that fails raises with its output."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for r in range(world):
        log = open(os.path.join(workdir, f"{suite}-rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_mesh_worker.py"),
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
