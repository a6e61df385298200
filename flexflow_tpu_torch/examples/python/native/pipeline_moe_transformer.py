"""Composed parallelism in ONE program: a transformer whose pipelined
stages (`p`) contain MoE layers sharded over experts (`e`), with data
parallelism (`n`) outside — capability the reference lacks (its pipeline
is per-op device_ids only, SURVEY §2.15).  On 8 devices the mesh is
n2 x e2 x p2; with 16 devices add tensor parallelism inside the stages
(`c`: see __graft_entry__.dryrun_multichip's composed pattern, which
runs n2 x e2 x p2 x c2).

Run:  flexflow-tpu pipeline_moe_transformer.py -b 8 -e 2
(on a CPU host: XLA_FLAGS=--xla_force_host_platform_device_count=8)
"""

import numpy as np

import flexflow_tpu as ff

SEQ, D_MODEL = 4, 16


def stage(seg, t):
    """One pipeline stage: dense block (TP over `c` when present) + MoE
    (EP over `e`)."""
    h = seg.dense(t, 32, activation="relu")
    h = seg.dense(h, D_MODEL)
    return seg.moe(h, num_experts=2, d_ff=32, k=1, capacity_factor=4.0,
                   aux_loss_weight=1e-2)


def top_level_task():
    cfg = ff.get_default_config()
    n = cfg.batch_size
    mesh_shape = {"n": 2, "e": 2, "p": 2}
    from flexflow_tpu.parallel.distributed import world_size
    if world_size() < 8:
        mesh_shape = {"p": min(2, world_size())}  # single-dev smoke
    print("mesh " + " x ".join(f"{a}{s}" for a, s in mesh_shape.items()))
    model = ff.FFModel(cfg)
    x = model.create_tensor((n, SEQ, D_MODEL), name="tokens")
    t = model.pipeline(x, num_stages=2, stage_builder=stage,
                       num_microbatches=2)
    t = model.reshape(t, (n, SEQ * D_MODEL))
    logits = model.dense(t, 4)
    model.compile(ff.SGDOptimizer(lr=cfg.learning_rate),
                  ff.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  [ff.METRICS_ACCURACY], final_tensor=logits,
                  mesh=ff.MachineMesh(mesh_shape))
    model.init_layers(seed=cfg.seed)

    rng = np.random.default_rng(cfg.seed)
    xs = rng.standard_normal((256, SEQ, D_MODEL)).astype(np.float32)
    ys = rng.integers(0, 4, (256, 1)).astype(np.int32)
    model.fit(xs, ys, epochs=cfg.epochs)


if __name__ == "__main__":
    top_level_task()
