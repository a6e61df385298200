"""Graphs and settings shared by the strategy-search tests
(``tests/test_torch_search_*.py``): the same graph built in the JAX
package (``ff``) and in the port (``ft``, on the CPU), and the port's
DeviceSpec filled with the JAX package's values so both packages price
a strategy alike.
"""

import numpy as np

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.search import cost_model as jax_cost
from flexflow_tpu_torch.search import cost_model as port_cost

BS = 8


def reference_spec(jax_spec=None):
    """The port's DeviceSpec holding the JAX package's numbers: its
    DeviceSpec's fields, its ``XLA_TEMP_FACTOR``, and the corrections
    its ops hold as literals — ``Conv2D.mxu_efficiency``'s
    ``in_channels / 8`` lane fill, ``Conv2D.backward_overhead``'s
    ``1 + 2.4 s^2 / 4``, ``Pool2D.backward_overhead``'s 1.9 (the value
    its CPU run takes) and ``cost_model._F32_MXU_SCALE``."""
    s = jax_spec or jax_cost.DEFAULT_SPEC
    return port_cost.DeviceSpec(
        mxu_flops=s.mxu_flops, vpu_flops=s.vpu_flops, hbm_bw=s.hbm_bw,
        hbm_capacity=s.hbm_capacity, ici_bw=s.ici_bw, dcn_bw=s.dcn_bw,
        ici_latency=s.ici_latency, kernel_launch=s.kernel_launch,
        conv_lane_fill=8, strided_dgrad_law=2.4, maxpool_bwd_factor=1.9,
        f32_matmul_scale=jax_cost._F32_MXU_SCALE,
        temp_factor=jax_cost.XLA_TEMP_FACTOR)


REF = reference_spec()
DEV = {ff: {}, ft: {"device": "cpu"}}


def _model(pkg, batch=BS, dtype="float32"):
    cfg = pkg.FFConfig(batch_size=batch, compute_dtype=dtype)
    cfg.mesh_shape = {"n": 1}
    return pkg.FFModel(cfg, **DEV[pkg])


def mlp(pkg):
    """The JAX tests' golden MLP (tests/test_search_hybrid.py)."""
    m = _model(pkg, 4096)
    t = m.create_tensor((4096, 256))
    t = m.dense(t, 256, activation="relu")
    t = m.dense(t, 256, activation="relu")
    m.dense(t, 16)
    return m


def branchy(pkg):
    """Two source denses into a concat chain: residual work for the
    hybrid search."""
    m = _model(pkg, 64)
    x = m.create_tensor((64, 128))
    a = m.dense(x, 128, activation="relu")
    b = m.dense(x, 128, activation="relu")
    c = m.concat([a, b], axis=1)
    m.dense(c, 32)
    return m


def diamond(pkg):
    """A reconvergent diamond: fork -> 2 branches -> join."""
    m = _model(pkg, 64)
    x = m.create_tensor((64, 64))
    f = m.dense(x, 64, activation="relu")
    a = m.dense(f, 64, activation="relu")
    b = m.dense(f, 64, activation="relu")
    j = m.concat([a, b], axis=1)
    m.dense(j, 16)
    return m


def transformer(pkg, batch=BS):
    """A small BERT: 2 layers of 32 wide, 2 heads, s 16, dense
    attention (``flash_attention`` False in both packages)."""
    from flexflow_tpu.models import build_transformer as jax_fn
    cfg = pkg.FFConfig(batch_size=batch, compute_dtype="float32",
                       flash_attention=False)
    fn = jax_fn if pkg is ff else ft.build_transformer
    return fn(cfg, num_layers=2, d_model=32, num_heads=2, d_ff=64,
              seq_len=16, vocab_size=128, num_classes=4, **DEV[pkg])[0]


def dlrm(pkg, batch=BS):
    from flexflow_tpu.models import build_dlrm as jax_fn
    cfg = pkg.FFConfig(batch_size=batch, compute_dtype="float32")
    fn = jax_fn if pkg is ff else ft.build_dlrm
    return fn(cfg, embedding_size=(100, 200, 300), sparse_feature_size=8,
              mlp_bot=(4, 16, 8), mlp_top=(32, 16, 1), **DEV[pkg])[0]


def alexnet(pkg):
    from flexflow_tpu.models import build_alexnet as jax_fn
    cfg = pkg.FFConfig(batch_size=BS, compute_dtype="float32")
    fn = jax_fn if pkg is ff else ft.build_alexnet
    return fn(cfg, num_classes=10, image_size=67, **DEV[pkg])[0]


def resnet(pkg):
    from flexflow_tpu.models import build_resnet50 as jax_fn
    cfg = pkg.FFConfig(batch_size=BS, compute_dtype="float32")
    fn = jax_fn if pkg is ff else ft.build_resnet50
    return fn(cfg, 10, 32, batch_norm=True, **DEV[pkg])[0]


def inception(pkg):
    """InceptionV3's stem cut to one conv, then one module of each kind
    at 75 px (``chip_smoke.trimmed_inception``)."""
    if pkg is ff:
        from flexflow_tpu.models import inception as mod
    else:
        from flexflow_tpu_torch.models import inception as mod
    m = _model(pkg)
    inp = m.create_tensor((BS, 3, 75, 75), name="input")
    t = m.conv2d(inp, 8, 3, 3, 2, 2, 0, 0, activation="relu")
    t = mod._inception_a(m, t, 8)
    t = mod._inception_b(m, t)
    t = mod._inception_c(m, t, 8)
    t = mod._inception_d(m, t)
    t = mod._inception_e(m, t)
    hw = t.shape[2]
    t = m.pool2d(t, hw, hw, 1, 1, 0, 0, pool_type="avg")
    t = m.flat(t)
    m.softmax(m.dense(t, 10))
    return m


def candle_uno(pkg):
    from flexflow_tpu.models import build_candle_uno as jax_fn
    cfg = pkg.FFConfig(batch_size=BS, compute_dtype="float32")
    fn = jax_fn if pkg is ff else ft.build_candle_uno
    feats = {"dose": 1, "cell.rnaseq": 12, "drug.descriptors": 20,
             "drug.fingerprints": 16}
    return fn(cfg, dense_layers=(16, 8), dense_feature_layers=(8, 8),
              feature_shapes=feats, **DEV[pkg])[0]


def nmt(pkg):
    from flexflow_tpu.models import build_nmt as jax_fn
    cfg = pkg.FFConfig(batch_size=BS, compute_dtype="float32")
    fn = jax_fn if pkg is ff else ft.build_nmt
    return fn(cfg, vocab_size=50, embed_dim=16, hidden_dim=16,
              num_layers=2, src_len=5, tgt_len=6, **DEV[pkg])[0]


def moe(pkg):
    """Embedding, RMSNorm, a 4-expert MoE, dropout, a residual and a
    transpose: the MoE slice's ops."""
    m = _model(pkg)
    ids = m.create_tensor((BS, 16), "int32")
    t = m.embedding(ids, 64, 32, aggr="none")
    t = m.rms_norm(t)
    u = m.moe(t, num_experts=4, d_ff=64, k=2)
    t = m.add(t, m.dropout(u, 0.1))
    t = m.transpose(t, (0, 2, 1))
    m.flat(t)
    return m


def pipeline(pkg):
    """A 4-stage pipeline block and a pipeline segment of two denses."""
    m = _model(pkg)
    x = m.create_tensor((BS, 16, 32))
    t = m.pipeline_transformer_block(x, 4, num_heads=2, d_ff=64,
                                     num_microbatches=2)

    def stage(sub, s):
        s = sub.dense(s, 32, activation="relu")
        return sub.dense(s, 32)

    m.pipeline(t, 2, stage, num_microbatches=2)
    return m


ZOO = {"alexnet": alexnet, "transformer": transformer, "resnet": resnet,
       "inception": inception, "dlrm": dlrm, "candle_uno": candle_uno,
       "nmt": nmt, "moe": moe, "pipeline": pipeline}


def pair(name):
    """(JAX model, port model) of one graph; their ops correspond one to
    one, by name and in order."""
    build = ZOO.get(name) or globals()[name]
    j, p = build(ff), build(ft)
    assert [op.name for op in j.layers] == [op.name for op in p.layers]
    return j, p


def port_pc(pc):
    """A JAX ParallelConfig as the port's."""
    return ft.ParallelConfig(
        device_type=ft.DeviceType(int(pc.device_type)), dims=tuple(pc.dims),
        device_ids=tuple(pc.device_ids),
        memory_types=tuple(ft.MemoryType(int(m)) for m in pc.memory_types),
        precision=pc.precision)


def random_strategies(jax_layers, ndev, seed, precision=False):
    """Seeded random strategies over the JAX package's candidate meshes
    and legal configs: {name: JAX ParallelConfig} and the mesh."""
    from flexflow_tpu.search.mcmc import candidate_meshes, legal_configs
    rng = np.random.default_rng(seed)
    meshes = candidate_meshes(ndev)
    mesh = meshes[int(rng.integers(len(meshes)))]
    out = {}
    for op in jax_layers:
        cands = legal_configs(op, mesh)
        pc = cands[int(rng.integers(len(cands)))]
        if precision and rng.random() < 0.3:
            import dataclasses
            from flexflow_tpu.analysis.legality import allowed_precisions
            opts = allowed_precisions(op)
            pc = dataclasses.replace(
                pc, precision=opts[int(rng.integers(len(opts)))])
        out[op.name] = pc
    return out, mesh
